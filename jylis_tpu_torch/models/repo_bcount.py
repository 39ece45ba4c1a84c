"""BCOUNT repo: bounded escrow counters (ops/bcount.py) per key.

The port's copy of jylis_tpu/models/repo_bcount.py (:1-231), unchanged
in behaviour, the OUTOFBOUND reply texts byte for byte: a counter that
must respect ``0 <= value <= bound`` under write contention without
coordinating writes. This repo is the RESP surface, the full-view delta
flush (a BCOUNT delta always ships the replica's complete per-key
state), converge buffering with a timed host drain, per-key digest
entries, and dump/load. Host-only in both packages.

RESP surface:

    BCOUNT GRANT key amount            raise the bound; the granting
                                       replica receives the inc-escrow
    BCOUNT INC key amount              spend inc-escrow (value +n)
    BCOUNT DEC key amount              spend dec-escrow (value -n)
    BCOUNT TRANSFER key to_rid amount [INC|DEC]
                                       move own escrow to replica
                                       to_rid (default DEC-escrow)
    BCOUNT GET key                     -> [value, bound]

INC / DEC / TRANSFER refuse with the typed ``OUTOFBOUND`` error when
the replica's local escrow cannot fund the operation.

Delta wire shape: the five-component full view
``(grants, incs, decs, xi, xd)``.
"""

from __future__ import annotations

from ..ops.bcount import BCount
from ..utils.metrics import timed_drain
from .base import ParseError, need, parse_u64
from .help import RepoHelp

BCOUNT_HELP = RepoHelp(
    "BCOUNT",
    {
        "GET": "key",
        "GRANT": "key amount",
        "INC": "key amount",
        "DEC": "key amount",
        "TRANSFER": "key to_replica amount [INC|DEC]",
    },
)

PENDING_DRAIN_THRESHOLD = 512


def outofbound(resp, what: str, rights: int, amount: int) -> None:
    resp.err(
        f"OUTOFBOUND (insufficient local {what} escrow: rights {rights} "
        f"< amount {amount}; transfer escrow to this replica or retry "
        "on one that holds some)"
    )


class RepoBCOUNT:
    name = "BCOUNT"
    help = BCOUNT_HELP

    def __init__(self, identity: int, **_kw):
        # device / mesh arguments accepted for constructor parity:
        # BCOUNT is host-only
        self._identity = identity
        self._keys: dict[bytes, BCount] = {}
        self._dirty: set[bytes] = set()
        self._sync_dirty: set[bytes] = set()
        self._pending: list[tuple[bytes, tuple]] = []

    def _for(self, key: bytes) -> BCount:
        bc = self._keys.get(key)
        if bc is None:
            bc = BCount()
            self._keys[key] = bc
        return bc

    def _note(self, key: bytes) -> None:
        self._dirty.add(key)
        self._sync_dirty.add(key)

    # -- commands ------------------------------------------------------------

    def apply(self, resp, args: list[bytes]) -> bool:
        op = need(args, 0)
        if op == b"GET":
            if self._pending:
                self.drain()
            key = need(args, 1)
            bc = self._keys.get(key)
            value = bc.value() if bc is not None else 0
            bound = bc.bound() if bc is not None else 0
            resp.array_start(2)
            resp.i64(value)  # the invariant pins value >= 0; i64 keeps
            resp.u64(bound)  # even a hostile loaded state renderable
            return False
        if op == b"GRANT":
            key = need(args, 1)
            amount = parse_u64(need(args, 2))
            if self._pending:
                self.drain()
            bc = self._for(key)
            if not bc.grant(self._identity, amount):
                # this replica's grant cell would pass u64 — the wire
                # span's ceiling (every decoder would refuse the delta)
                resp.err(
                    "OUTOFBOUND (grant overflows this replica's u64 "
                    f"grant cell: {bc.grants.get(self._identity, 0)} "
                    f"+ {amount})"
                )
                return False
            self._note(key)
            resp.ok()
            return True
        if op in (b"INC", b"DEC"):
            key = need(args, 1)
            amount = parse_u64(need(args, 2))
            if self._pending:
                # buffered foreign escrow may fund this spend: fold it
                # in before computing rights (refusals stay local-view
                # sound either way — rights only grow with knowledge)
                self.drain()
            bc = self._for(key)
            if op == b"INC":
                if not bc.inc(self._identity, amount):
                    outofbound(resp, "inc", bc.inc_rights(self._identity),
                               amount)
                    return False
            else:
                if not bc.dec(self._identity, amount):
                    outofbound(resp, "dec", bc.dec_rights(self._identity),
                               amount)
                    return False
            self._note(key)
            resp.ok()
            return True
        if op == b"TRANSFER":
            key = need(args, 1)
            to_rid = parse_u64(need(args, 2))
            amount = parse_u64(need(args, 3))
            pol = b"DEC"
            if len(args) > 4:
                pol = need(args, 4)
                if pol not in (b"INC", b"DEC"):
                    raise ParseError()
            if self._pending:
                self.drain()
            bc = self._for(key)
            polarity = "INC" if pol == b"INC" else "DEC"
            if not bc.transfer(self._identity, to_rid, amount, polarity):
                rights = (
                    bc.inc_rights(self._identity) if polarity == "INC"
                    else bc.dec_rights(self._identity)
                )
                outofbound(resp, polarity.lower(), rights, amount)
                return False
            self._note(key)
            resp.ok()
            return True
        raise ParseError()

    # -- lattice plumbing ----------------------------------------------------

    def converge(self, key: bytes, delta: tuple) -> None:
        self._pending.append((key, delta))

    def drain_overdue(self) -> bool:
        return len(self._pending) >= PENDING_DRAIN_THRESHOLD

    @timed_drain("BCOUNT")
    def drain(self) -> int:
        """Fold the buffered foreign states; returns how many (timed_drain's
        ``keys``)."""
        pending, self._pending = self._pending, []
        for key, delta in pending:
            self._for(key).converge(BCount.from_wire(delta))
            self._sync_dirty.add(key)
        return len(pending)

    def deltas_size(self) -> int:
        return len(self._dirty)

    def flush_deltas(self):
        if self._pending:
            self.drain()
        out = []
        for key in sorted(self._dirty):
            bc = self._keys.get(key)
            if bc is not None and not bc.is_bottom():
                out.append((key, bc.to_wire()))
        self._dirty.clear()
        return out

    # -- sync digest (models/database.py incremental tree) -------------------

    def sync_prepare(self) -> None:
        if self._pending:
            self.drain()

    def sync_dirty_keys(self) -> list[bytes]:
        out = sorted(self._sync_dirty)
        self._sync_dirty.clear()
        return out

    def sync_canon(self, key: bytes) -> bytes | None:
        bc = self._keys.get(key)
        if bc is None or bc.is_bottom():
            return None
        return repr(bc.canon()).encode()

    # -- snapshot: full state in the wire-delta shape -------------------------

    def dump_state(self):
        if self._pending:
            self.drain()
        return [
            (key, bc.to_wire())
            for key, bc in sorted(self._keys.items())
            if not bc.is_bottom()
        ]

    def load_state(self, batch) -> None:
        for key, delta in batch:
            self.converge(key, delta)
        self.drain()

    # -- direct host views (tests) --------------------------------------------

    def counter(self, key: bytes) -> BCount | None:
        if self._pending:
            self.drain()
        return self._keys.get(key)
