"""MAP repo: a generic key -> (field -> registered lattice) keyspace.

The port's copy of jylis_tpu/models/repo_map.py (:1-207), unchanged in
behaviour. MAP runs no device code in either package: the value
semantics live in ops/compose.py; this repo is the RESP surface,
decomposed per-field delta flushes, converge buffering with a timed
host drain (offloaded by the manager's ``drain_overdue`` hook),
(key, field)-granular digest entries, and dump/load.

RESP surface (``MAP <TYPE> <OP> ...``, TYPE = any registered inner
lattice -- TREG, TLOG, GCOUNT, PNCOUNT):

    MAP <TYPE> SET key field <inner write args...>
    MAP <TYPE> GET key field
    MAP <TYPE> DEL key field
    MAP <TYPE> KEYS key

Delta wire shape: ``(packed(key, field), (itype, ver, tomb, val))`` --
one FIELD's full product state per entry; a DEL ships a tombstone-only
unit (ver empty, val = inner bottom). The digest tree hashes packed
(key, field) leaves.
"""

from __future__ import annotations

from ..ops.compose import REGISTRY, pack_field, unpack_field
from ..utils.metrics import timed_drain
from .base import ParseError, need
from .help import RepoHelp
from .map_table import PyMapTable

MAP_HELP = RepoHelp(
    "MAP",
    {
        "SET": "type key field ...  (inner write args, e.g. TREG: value ts)",
        "GET": "type key field",
        "DEL": "type key field",
        "KEYS": "type key",
    },
)

# foreign units buffered past this fold in a worker thread off the
# serving loop (the host analog of the device repos' drain thresholds)
PENDING_DRAIN_THRESHOLD = 512


class RepoMAP:
    name = "MAP"
    help = MAP_HELP

    def __init__(self, identity: int, **_kw):
        # device / mesh arguments accepted for constructor parity: MAP
        # is host-only
        self._identity = identity
        self._tbl = PyMapTable()
        # wire units dropped at the converge boundary (malformed
        # composite key from a peer): nothing joinable to keep, but the
        # count stays visible to tests/debugging
        self._dropped_units = 0

    # -- commands ------------------------------------------------------------

    def apply(self, resp, args: list[bytes]) -> bool:
        itype_b = need(args, 0)
        op = need(args, 1)
        itype = itype_b.decode("ascii", "replace")
        inner = REGISTRY.get(itype)
        if inner is None:
            raise ParseError()
        if op == b"GET":
            if self._tbl.pending:
                self.drain()
            key, field = need(args, 2), need(args, 3)
            m = self._tbl.find(key)
            val = m.get_field(field, itype) if m is not None else None
            if val is None:
                resp.null()
            else:
                inner.render(resp, val)
            return False
        if op == b"KEYS":
            if self._tbl.pending:
                self.drain()
            key = need(args, 2)
            m = self._tbl.find(key)
            fields = m.live_fields(itype) if m is not None else []
            resp.array_start(len(fields))
            for f in fields:
                resp.string(f)
            return False
        if op == b"SET":
            key, field = need(args, 2), need(args, 3)
            if self._tbl.pending:
                # local edit counters must advance past everything this
                # replica has OBSERVED, including buffered foreign units
                self.drain()
            try:
                self._tbl.map_for(key).set_field(
                    field, self._identity, itype, args[4:]
                )
            except ValueError:
                raise ParseError() from None
            self._tbl.note_edit(key, field)
            resp.ok()
            return True
        if op == b"DEL":
            key, field = need(args, 2), need(args, 3)
            if self._tbl.pending:
                # observed-remove: the tombstone must cover the edits
                # this replica has seen — fold them in first
                self.drain()
            m = self._tbl.find(key)
            unit = m.del_field(field, self._identity) if m is not None else None
            resp.ok()
            if unit is None:
                return False  # unknown/dead field: nothing to remove
            self._tbl.note_edit(key, field)
            return True
        raise ParseError()

    # -- lattice plumbing ----------------------------------------------------

    def converge(self, key: bytes, delta: tuple) -> None:
        # key is the PACKED (key, field) composite; buffer only — the
        # serving path drains via drain_overdue in a worker thread.
        # Validate the composite SHAPE eagerly: the codec treats batch
        # keys as opaque bytes, so a buggy peer can ship a key no
        # unpack can parse — buffered unvalidated, it would blow up the
        # fold mid-drain and take every other buffered unit with it.
        # A key that names no (key, field) carries nothing joinable:
        # drop it here, alone.
        try:
            unpack_field(key)
        except ValueError:
            self._dropped_units += 1
            return
        self._tbl.buffer_unit(key, delta)

    def drain_overdue(self) -> bool:
        return len(self._tbl.pending) >= PENDING_DRAIN_THRESHOLD

    @timed_drain("MAP")
    def drain(self) -> int:
        """Fold the pending fields; returns how many (timed_drain's
        ``keys``)."""
        n = len(self._tbl.pending)
        self._tbl.fold_pending()
        return n

    def deltas_size(self) -> int:
        return len(self._tbl.dirty)

    def flush_deltas(self):
        if self._tbl.pending:
            self.drain()
        out = []
        for packed in self._tbl.export_dirty():
            unit = self._tbl.field_unit(packed)
            if unit is not None:
                out.append((packed, unit))
        return out

    # -- sync digest (models/database.py incremental tree) -------------------

    def sync_prepare(self) -> None:
        if self._tbl.pending:
            self.drain()

    def sync_dirty_keys(self) -> list[bytes]:
        return self._tbl.export_sync_dirty()

    def sync_canon(self, key: bytes) -> bytes | None:
        canon = self._tbl.field_canon(key)
        return None if canon is None else repr(canon).encode()

    # -- snapshot: full state in the wire-delta shape -------------------------

    def dump_state(self):
        if self._tbl.pending:
            self.drain()
        out = []
        for packed in self._tbl.all_packed():
            unit = self._tbl.field_unit(packed)
            if unit is not None:
                out.append((packed, unit))
        return out

    def load_state(self, batch) -> None:
        for packed, unit in batch:
            self.converge(packed, unit)
        self.drain()

    # -- direct host views (tests) --------------------------------------------

    def get_value(self, key: bytes, field: bytes, itype: str):
        if self._tbl.pending:
            self.drain()
        m = self._tbl.find(key)
        return m.get_field(field, itype) if m is not None else None


def unpack_wire_key(packed: bytes) -> tuple[bytes, bytes]:
    """Re-exported for operators/tests reading journal or range frames."""
    return unpack_field(packed)


__all__ = ["RepoMAP", "MAP_HELP", "pack_field", "unpack_wire_key"]
