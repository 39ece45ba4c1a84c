"""BCOUNT: a bounded counter with replica-local escrow.

The port's copy of jylis_tpu/ops/bcount.py (:1-238), unchanged in
behaviour; host-only in both packages. Inventory, rate limits and
quotas are counters that must respect a bound under concurrent writes
without coordinating every write. The escrow construction splits the
slack between the value and its bound into replica-held RIGHTS that
can be spent locally and moved between replicas by a join-monotone
transfer matrix:

* ``grants[rid]``   -- capacity this replica added to the bound (and
                       received as inc-escrow); ``bound = sum(grants)``.
* ``incs[rid]``     -- this replica's lifetime increments.
* ``decs[rid]``     -- this replica's lifetime decrements.
* ``xi[(f, t)]``    -- inc-escrow moved f -> t (lifetime total).
* ``xd[(f, t)]``    -- dec-escrow moved f -> t (lifetime total).

``value = sum(incs) - sum(decs)``. Every component is a single-writer
monotone counter, so the join is pointwise max. Replica-local rights:

    inc_rights(r) = grants[r] + decs[r] - incs[r] + sum xi[(*, r)] - sum xi[(r, *)]
    dec_rights(r) = incs[r] - decs[r] + sum xd[(*, r)] - sum xd[(r, *)]

An INC spends inc-escrow and mints dec-escrow; a DEC spends dec-escrow
and mints inc-escrow; a TRANSFER debits the sender's row before the
recipient can observe the credit. Refusal (insufficient local rights)
is the typed ``OUTOFBOUND`` error. Summing the identities gives
``sum inc_rights = bound - value`` and ``sum dec_rights = value``, so
rights >= 0 everywhere forces ``0 <= value <= bound``. A BCOUNT delta
always ships the replica's full per-key view, so every shipped state
is self-justifying under join.
"""

from __future__ import annotations

# one pointwise-max join (zero-normalised) for both composed modules:
# two copies would drift independently and break cross-replica canon
from .compose import U64_MAX, _join_pmax


class BCount:
    """One bounded counter replica state (host-resident).

    ``xi``/``xd`` must be mutated through :meth:`transfer` /
    :meth:`converge` / :meth:`from_wire` — the per-rid net-transfer
    cache that makes rights checks O(1) (instead of a full matrix scan
    per spend, the difference between ~3k and ~1M grants/sec under the
    bcount-contention bench) is maintained by exactly those entry
    points."""

    __slots__ = ("grants", "incs", "decs", "xi", "xd",
                 "_xi_net", "_xd_net")

    def __init__(self):
        self.grants: dict[int, int] = {}
        self.incs: dict[int, int] = {}
        self.decs: dict[int, int] = {}
        # (from_rid, to_rid) -> lifetime amount moved; row `from_rid`
        # is single-writer like every other component
        self.xi: dict[tuple[int, int], int] = {}
        self.xd: dict[tuple[int, int], int] = {}
        # derived: per-rid (incoming - outgoing) over each matrix
        self._xi_net: dict[int, int] = {}
        self._xd_net: dict[int, int] = {}

    def _recount(self) -> None:
        self._xi_net = {}
        self._xd_net = {}
        for (f, t), v in self.xi.items():
            self._xi_net[f] = self._xi_net.get(f, 0) - v
            self._xi_net[t] = self._xi_net.get(t, 0) + v
        for (f, t), v in self.xd.items():
            self._xd_net[f] = self._xd_net.get(f, 0) - v
            self._xd_net[t] = self._xd_net.get(t, 0) + v

    # ---- derived views -----------------------------------------------------

    def value(self) -> int:
        return sum(self.incs.values()) - sum(self.decs.values())

    def bound(self) -> int:
        return sum(self.grants.values())

    def inc_rights(self, rid: int) -> int:
        return (
            self.grants.get(rid, 0)
            + self.decs.get(rid, 0)
            - self.incs.get(rid, 0)
            + self._xi_net.get(rid, 0)
        )

    def dec_rights(self, rid: int) -> int:
        return (
            self.incs.get(rid, 0)
            - self.decs.get(rid, 0)
            + self._xd_net.get(rid, 0)
        )

    # ---- local operations (escrow-checked; False = OUTOFBOUND) ------------

    def grant(self, rid: int, amount: int) -> bool:
        """Raise the bound by ``amount``; the granting replica receives
        the matching inc-escrow. Creation is the first grant. Refuses
        (False) when the cell would pass u64: the wire decoders bound
        every span to u64 (codec _r_u64_dict), so an over-u64 cell
        would encode fine yet be refused by every peer AND make the
        origin's own journal unreplayable — the overflow must be
        stopped at the mutation, not discovered at the decoder."""
        cur = self.grants.get(rid, 0)
        if cur + amount > U64_MAX:
            return False
        self.grants[rid] = cur + amount
        return True

    def inc(self, rid: int, amount: int) -> bool:
        cur = self.incs.get(rid, 0)
        if amount > self.inc_rights(rid) or cur + amount > U64_MAX:
            return False
        self.incs[rid] = cur + amount
        return True

    def dec(self, rid: int, amount: int) -> bool:
        cur = self.decs.get(rid, 0)
        if amount > self.dec_rights(rid) or cur + amount > U64_MAX:
            return False
        self.decs[rid] = cur + amount
        return True

    def transfer(
        self, frm: int, to: int, amount: int, polarity: str = "DEC",
        unchecked: bool = False,
    ) -> bool:
        """Move ``amount`` of escrow from replica ``frm`` (the caller)
        to replica ``to``. The debit lands in the caller's OWN matrix
        row in the same mutation as the credit becomes derivable, so
        no schedule can spend a right twice. ``unchecked`` skips the
        rights check (kept for parity with the JAX package's model
        checker)."""
        if frm == to or amount == 0:
            return True
        src = self.xi if polarity == "INC" else self.xd
        rights = (
            self.inc_rights(frm) if polarity == "INC"
            else self.dec_rights(frm)
        )
        cur = src.get((frm, to), 0)
        if cur + amount > U64_MAX:
            return False  # matrix cells are u64 on the wire (see grant)
        if not unchecked and amount > rights:
            return False
        src[(frm, to)] = cur + amount
        net = self._xi_net if polarity == "INC" else self._xd_net
        net[frm] = net.get(frm, 0) - amount
        net[to] = net.get(to, 0) + amount
        return True

    # ---- lattice -----------------------------------------------------------

    def converge(self, other: "BCount") -> None:
        self.grants = _join_pmax(self.grants, other.grants)
        self.incs = _join_pmax(self.incs, other.incs)
        self.decs = _join_pmax(self.decs, other.decs)
        self.xi = _join_pmax(self.xi, other.xi)
        self.xd = _join_pmax(self.xd, other.xd)
        self._recount()

    def copy(self) -> "BCount":
        out = BCount()
        out.converge(self)
        return out

    def canon(self) -> tuple:
        return (
            tuple(sorted(self.grants.items())),
            tuple(sorted(self.incs.items())),
            tuple(sorted(self.decs.items())),
            tuple(sorted(self.xi.items())),
            tuple(sorted(self.xd.items())),
        )

    def is_bottom(self) -> bool:
        return not (
            self.grants or self.incs or self.decs or self.xi or self.xd
        )

    # ---- wire shape --------------------------------------------------------
    # delta/BCOUNT ships the FULL per-key view as five components (see
    # module docstring on self-justifying states): three {rid: u64}
    # spans plus two transfer matrices as (from, to, amount) triples.

    def to_wire(self) -> tuple:
        return (
            dict(self.grants), dict(self.incs), dict(self.decs),
            dict(self.xi), dict(self.xd),
        )

    @classmethod
    def from_wire(cls, wire: tuple) -> "BCount":
        grants, incs, decs, xi, xd = wire
        out = cls()
        # zero-normalised like the join: wire spans may carry zeros
        out.grants = {k: v for k, v in grants.items() if v}
        out.incs = {k: v for k, v in incs.items() if v}
        out.decs = {k: v for k, v in decs.items() if v}
        out.xi = {k: v for k, v in xi.items() if v}
        out.xd = {k: v for k, v in xd.items() if v}
        out._recount()
        return out
