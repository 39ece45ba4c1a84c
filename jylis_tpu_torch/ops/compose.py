"""Composed CRDTs: the inner-lattice registry and the generic MAP.

The port's copy of jylis_tpu/ops/compose.py (:1-470), whole and
unchanged in behaviour: the MAP field lattice and its inner joins are
host rules that every replica must apply identically (their canon is
what the sync digest hashes), so nothing here is re-derived. No device
code: MAP runs on the host in both packages.

Two layers live here:

* **The inner-lattice registry** (:data:`REGISTRY`): every value type
  a MAP field can hold, described over its WIRE-delta representation
  (a dict for GCOUNT, a ``(value, ts)`` pair for TREG, ...), with join
  / canon / bottom / RESP write+render hooks and a seeded generator.
  The inner joins are hostref's exact rules (TReg, TLog, the
  G-Counter's pointwise max).

* **The MAP field lattice** (:class:`MapCRDT` holding
  :class:`Field` s): each field is a PRODUCT lattice
  ``(itype, ver, tomb, val)`` -- per-replica edit counters (``ver``,
  pointwise max), a per-field causal-context tombstone (``tomb``,
  pointwise max), and the inner value (inner join). A field is LIVE
  iff some edit is not covered by the tombstone (observed-remove at
  field granularity: a DEL only covers the edits its replica had
  seen, so a concurrent SET survives -- add-wins). Removal HIDES; the
  inner content is retained and keeps joining under the tombstone, so
  the product stays a true join-semilattice. Conflicting inner types
  on one field resolve by type-name dominance (the lexicographically
  greater name wins wholesale).

Field deltas pack the composite ``(key, field)`` into ONE opaque wire
key (:func:`pack_field`), so the (key, delta) batch machinery and the
per-type digest tree operate at FIELD granularity.
"""

from __future__ import annotations

U64_MAX = (1 << 64) - 1


def _norm(d: dict) -> dict:
    """Drop zero entries: a zero counter/tombstone cell is the SAME
    lattice point as an absent one, and must canon/join identically
    (wire decodes may legally carry explicit zeros)."""
    return {k: v for k, v in d.items() if v}


def _join_pmax(a: dict, b: dict) -> dict:
    """Pointwise-max join of {int: int} maps (the G-Counter core),
    zero-normalised."""
    out = _norm(a)
    for k, v in b.items():
        if v > out.get(k, 0):
            out[k] = v
    return out


# ---- inner lattices over their wire-delta representations ------------------


class InnerLattice:
    """One registry row: a value lattice a MAP field can hold, expressed
    over the wire-delta shape cluster/codec.py already ships for the
    flat type of the same name. ``join(a, b)`` returns a NEW value
    (inputs unaliased); ``canon`` is the representation-normal
    comparable/digestible form; ``bottom()`` is the join identity (the
    branch-free wire unit encodes it instead of a presence flag);
    ``write(cur, rid, args)`` parses a ``MAP <TYPE> SET key field
    <args…>`` tail into the delta to join AND ship (raises ValueError
    on a malformed tail); ``render(resp, v)`` answers a GET; ``gen``
    drives the generated law harness."""

    __slots__ = ()
    name: str = "?"

    def bottom(self):
        raise NotImplementedError

    def join(self, a, b):
        raise NotImplementedError

    def copy(self, v):
        raise NotImplementedError

    def canon(self, v) -> tuple:
        raise NotImplementedError

    def is_bottom(self, v) -> bool:
        return self.canon(v) == self.canon(self.bottom())

    def write(self, cur, rid: int, args: list):
        raise NotImplementedError

    def render(self, resp, v) -> None:
        raise NotImplementedError

    def gen(self, rng):
        raise NotImplementedError

    # parse helper shared by the write hooks: strict u64 (models/base
    # duplicates this over ParseError; here ValueError keeps ops/ free
    # of the models import)
    @staticmethod
    def _u64(b: bytes) -> int:
        if not b.isdigit():
            raise ValueError("not a u64")
        v = int(b)
        if v > U64_MAX:
            raise ValueError("u64 overflow")
        return v


class InnerTREG(InnerLattice):
    """LWW pair (value: bytes, ts: u64); join = max by (ts, value) —
    hostref.TReg's exact rule. Bottom (b"", 0) equals a written empty
    pair at ts 0, the reference's documented unset behaviour."""

    name = "TREG"

    def bottom(self):
        return (b"", 0)

    def join(self, a, b):
        return a if (a[1], a[0]) >= (b[1], b[0]) else b

    def copy(self, v):
        return v  # immutable tuple

    def canon(self, v) -> tuple:
        return (v[1], v[0])

    def write(self, cur, rid: int, args: list):
        if len(args) != 2:
            raise ValueError("TREG write takes: value timestamp")
        return (args[0], self._u64(args[1]))

    def render(self, resp, v) -> None:
        value, ts = v
        resp.array_start(2)
        resp.string(value)
        resp.u64(ts)

    def gen(self, rng):
        if rng.random() < 0.15:
            return self.bottom()
        return (
            bytes(rng.choices(b"abcdef", k=rng.randint(0, 4))),
            rng.randint(0, 5),
        )


class InnerTLOG(InnerLattice):
    """(entries: [(value, ts)] ts-desc, cutoff: u64); join = entry union
    above the max cutoff — hostref.TLog's exact rule."""

    name = "TLOG"

    def bottom(self):
        return ((), 0)

    def join(self, a, b):
        cutoff = max(a[1], b[1])
        merged = set(a[0]) | set(b[0])
        entries = tuple(
            sorted(
                (e for e in merged if e[1] >= cutoff),
                key=lambda e: (e[1], e[0]),
                reverse=True,
            )
        )
        return (entries, cutoff)

    def copy(self, v):
        return (tuple(v[0]), v[1])

    def canon(self, v) -> tuple:
        return (tuple(v[0]), v[1])

    def write(self, cur, rid: int, args: list):
        if len(args) != 2:
            raise ValueError("TLOG write takes: value timestamp")
        return (((args[0], self._u64(args[1])),), 0)

    def render(self, resp, v) -> None:
        entries, _cutoff = v
        resp.array_start(len(entries))
        for value, ts in entries:
            resp.array_start(2)
            resp.string(value)
            resp.u64(ts)

    def gen(self, rng):
        entries = tuple(
            (bytes(rng.choices(b"xyz", k=rng.randint(1, 3))),
             rng.randint(0, 9))
            for _ in range(rng.randint(0, 4))
        )
        cutoff = rng.randint(0, 9) if rng.random() < 0.3 else 0
        return self.join((entries, 0), ((), cutoff))


class InnerGCOUNT(InnerLattice):
    """{rid: u64}; join = pointwise max; value = wrapping sum."""

    name = "GCOUNT"

    def bottom(self):
        return {}

    def join(self, a, b):
        return _join_pmax(a, b)

    def copy(self, v):
        return dict(v)

    def canon(self, v) -> tuple:
        return tuple(sorted(v.items()))

    def write(self, cur, rid: int, args: list):
        if len(args) != 1:
            raise ValueError("GCOUNT write takes: amount")
        amount = self._u64(args[0])
        cur = cur if cur is not None else {}
        return {rid: (cur.get(rid, 0) + amount) & U64_MAX}

    def render(self, resp, v) -> None:
        resp.u64(sum(v.values()) & U64_MAX)

    def gen(self, rng):
        return {
            rid: rng.randint(1, 1 << 40)
            for rid in rng.sample(range(1, 9), rng.randint(0, 4))
        }


class InnerPNCOUNT(InnerLattice):
    """({rid: u64}, {rid: u64}); value = P − N signed-64 modular."""

    name = "PNCOUNT"

    def bottom(self):
        return ({}, {})

    def join(self, a, b):
        return (_join_pmax(a[0], b[0]), _join_pmax(a[1], b[1]))

    def copy(self, v):
        return (dict(v[0]), dict(v[1]))

    def canon(self, v) -> tuple:
        return (tuple(sorted(v[0].items())), tuple(sorted(v[1].items())))

    def write(self, cur, rid: int, args: list):
        if len(args) != 1:
            raise ValueError("PNCOUNT write takes: amount (+n or -n)")
        raw = args[0]
        pol = 0
        if raw[:1] == b"-":
            pol, raw = 1, raw[1:]
        elif raw[:1] == b"+":
            raw = raw[1:]
        amount = self._u64(raw)
        cur = cur if cur is not None else ({}, {})
        own = (cur[pol].get(rid, 0) + amount) & U64_MAX
        return ({rid: own}, {}) if pol == 0 else ({}, {rid: own})

    def render(self, resp, v) -> None:
        raw = (sum(v[0].values()) - sum(v[1].values())) & U64_MAX
        resp.i64(raw - (1 << 64) if raw >= (1 << 63) else raw)

    def gen(self, rng):
        g = InnerGCOUNT()
        return (g.gen(rng), g.gen(rng))


# the registered value lattices, by type name. MAP itself is NOT
# registered: the wire unit would nest without bound and the digest
# leaves would lose their (key, field) shape — composition is one
# level deep by design (UJSON already covers arbitrary nesting).
REGISTRY: dict[str, InnerLattice] = {
    inner.name: inner
    for inner in (InnerTREG(), InnerTLOG(), InnerGCOUNT(), InnerPNCOUNT())
}


# ---- composite wire keys ---------------------------------------------------


def pack_field(key: bytes, field: bytes) -> bytes:
    """One opaque wire key for a (key, field) pair: varint key length,
    key, field. Every existing batch mechanism (journal, retransmit
    window, digest tree, range pulls) then operates per FIELD."""
    n = len(key)
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    return bytes(out) + key + field


def unpack_field(packed: bytes) -> tuple[bytes, bytes]:
    """Inverse of pack_field; raises ValueError on a malformed key."""
    shift = n = pos = 0
    while True:
        if pos >= len(packed) or shift > 63:
            raise ValueError("malformed composite key")
        c = packed[pos]
        pos += 1
        n |= (c & 0x7F) << shift
        if not (c & 0x80):
            break
        shift += 7
    if pos + n > len(packed):
        raise ValueError("malformed composite key")
    return packed[pos : pos + n], packed[pos + n :]


# ---- the MAP field lattice -------------------------------------------------


class Field:
    """One field's product-lattice state: inner type tag, per-replica
    edit counters, removal tombstone, inner value. The WIRE unit for a
    field delta is the plain tuple ``(itype, ver, tomb, val)`` —
    :meth:`unit` exports one, :func:`join_units` is the codec-facing
    join over them."""

    __slots__ = ("itype", "ver", "tomb", "val")

    def __init__(self, itype: str, ver=None, tomb=None, val=None):
        inner = REGISTRY[itype]
        self.itype = itype
        self.ver: dict[int, int] = _norm(ver or {})
        self.tomb: dict[int, int] = _norm(tomb or {})
        self.val = val if val is not None else inner.bottom()

    def live(self) -> bool:
        return any(n > self.tomb.get(rid, 0) for rid, n in self.ver.items())

    def unit(self) -> tuple:
        """Export the wire unit (a fresh copy: the caller aliases it
        into journal/broadcast sinks)."""
        inner = REGISTRY[self.itype]
        return (self.itype, dict(self.ver), dict(self.tomb),
                inner.copy(self.val))

    def canon(self) -> tuple:
        return (
            self.itype,
            tuple(sorted(self.ver.items())),
            tuple(sorted(self.tomb.items())),
            REGISTRY[self.itype].canon(self.val),
        )

    def converge_unit(self, unit: tuple) -> None:
        """Join one wire unit in (type dominance, then product join)."""
        itype, ver, tomb, val = unit
        if itype not in REGISTRY:
            raise ValueError(f"unregistered MAP value type: {itype}")
        if itype != self.itype:
            # deterministic type-rank dominance: greater name wins
            # wholesale; the loser's state is discarded identically on
            # every replica, so the composite stays a lattice
            if itype < self.itype:
                return
            inner = REGISTRY[itype]
            self.itype = itype
            self.ver = _norm(ver)
            self.tomb = _norm(tomb)
            self.val = inner.copy(val)
            return
        self.ver = _join_pmax(self.ver, ver)
        self.tomb = _join_pmax(self.tomb, tomb)
        self.val = REGISTRY[itype].join(self.val, val)


def join_units(a: tuple, b: tuple) -> tuple:
    """Join two wire units (the law harness's MAP-field join)."""
    f = Field(a[0], a[1], a[2], REGISTRY[a[0]].copy(a[3]))
    f.converge_unit(b)
    return f.unit()


class MapCRDT:
    """A whole map replica: field name -> Field. The law harness joins
    these (converge) and compares canonical forms; the serving repo
    (models/repo_map.py) keys them per map key."""

    __slots__ = ("fields",)

    def __init__(self):
        self.fields: dict[bytes, Field] = {}

    def set_field(self, field: bytes, rid: int, itype: str, args: list):
        """Local SET: parse the inner write, bump the editor's per-field
        counter, join the content in. Returns the decomposed wire unit
        to ship (ValueError propagates for malformed writes)."""
        f = self.fields.get(field)
        # a type-changing SET starts a fresh dominance contest: the
        # unit carries only this write's evidence
        cur_val = f.val if (f is not None and f.itype == itype) else None
        inner = REGISTRY[itype]  # KeyError = unregistered type
        delta_val = inner.write(cur_val, rid, args)
        if f is None:
            f = Field(itype)
            self.fields[field] = f
        seq = f.ver.get(rid, 0) + 1 if f.itype == itype else 1
        unit = (itype, {rid: seq}, {}, delta_val)
        f.converge_unit(unit)
        return unit

    def del_field(self, field: bytes, rid: int):
        """Local DEL: tombstone every edit this replica has OBSERVED
        (observed-remove: a concurrent unseen edit survives). Returns
        the tombstone-only wire unit to ship, or None if the field is
        unknown/dead (nothing to remove)."""
        f = self.fields.get(field)
        if f is None or not f.live():
            return None
        f.tomb = _join_pmax(f.tomb, f.ver)
        return (f.itype, {}, dict(f.tomb), REGISTRY[f.itype].bottom())

    def get_field(self, field: bytes, itype: str):
        """The live inner value of a field, or None (dead, missing, or
        held by a different dominating type)."""
        f = self.fields.get(field)
        if f is None or f.itype != itype or not f.live():
            return None
        return f.val

    def live_fields(self, itype: str) -> list[bytes]:
        return sorted(
            name
            for name, f in self.fields.items()
            if f.itype == itype and f.live()
        )

    def converge(self, other: "MapCRDT") -> None:
        for name, f in other.fields.items():
            self.converge_field(name, f.unit())

    def converge_field(self, field: bytes, unit: tuple) -> None:
        f = self.fields.get(field)
        if f is None:
            self.fields[field] = Field(
                unit[0], unit[1], unit[2], REGISTRY[unit[0]].copy(unit[3])
            )
        else:
            f.converge_unit(unit)

    def canon(self) -> tuple:
        return tuple(
            (name, f.canon()) for name, f in sorted(self.fields.items())
        )
