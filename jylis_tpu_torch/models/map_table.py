"""Host table backend for the MAP repo.

The port's copy of jylis_tpu/models/map_table.py (:1-107), unchanged in
behaviour. State model: ``key -> ops.compose.MapCRDT`` (field ->
product-lattice Field). Three kinds of dirtiness are tracked at FIELD
granularity, keyed by the packed composite wire key
(compose.pack_field):

* ``dirty``       -- fields edited locally since the last delta flush
                     (what flush_deltas exports: decomposed per-field
                     units, never the map).
* ``sync_dirty``  -- fields changed since the last digest fold (leaves
                     hash (key, field) pairs).
* ``pending``     -- foreign units buffered by converge until the next
                     drain (the timed seam).
"""

from __future__ import annotations

from ..ops.compose import MapCRDT, pack_field, unpack_field


class PyMapTable:
    def __init__(self):
        self.maps: dict[bytes, MapCRDT] = {}
        self.dirty: set[bytes] = set()
        self.sync_dirty: set[bytes] = set()
        self.pending: list[tuple[bytes, tuple]] = []

    def map_for(self, key: bytes) -> MapCRDT:
        m = self.maps.get(key)
        if m is None:
            m = MapCRDT()
            self.maps[key] = m
        return m

    def find(self, key: bytes) -> MapCRDT | None:
        return self.maps.get(key)

    def note_edit(self, key: bytes, field: bytes) -> None:
        packed = pack_field(key, field)
        self.dirty.add(packed)
        self.sync_dirty.add(packed)

    def buffer_unit(self, packed: bytes, unit: tuple) -> None:
        self.pending.append((packed, unit))

    def fold_pending(self) -> None:
        """Apply the buffered foreign units (the drain body). Per-unit
        tolerance: the repo validates composite keys at the converge
        boundary, but a malformed unit reaching here anyway (a direct
        load path, a future regression) must drop ALONE — the swap
        above already emptied the buffer, so one raise would discard
        every unit buffered behind it."""
        pending, self.pending = self.pending, []
        for packed, unit in pending:
            try:
                key, field = unpack_field(packed)
                self.map_for(key).converge_field(field, unit)
            except (ValueError, KeyError):
                continue
            self.sync_dirty.add(packed)

    def export_dirty(self) -> list[bytes]:
        out = sorted(self.dirty)
        self.dirty.clear()
        return out

    def export_sync_dirty(self) -> list[bytes]:
        out = sorted(self.sync_dirty)
        self.sync_dirty.clear()
        return out

    def field_unit(self, packed: bytes) -> tuple | None:
        """The FULL current unit of one field (a fresh copy — callers
        alias it into journal/broadcast sinks), or None if unknown."""
        key, field = unpack_field(packed)
        m = self.maps.get(key)
        if m is None:
            return None
        f = m.fields.get(field)
        return None if f is None else f.unit()

    def field_canon(self, packed: bytes) -> tuple | None:
        """Canonical state of one field — tombstoned fields INCLUDED
        (a replica that saw a DEL and one that did not must digest
        apart until the tombstone syncs)."""
        key, field = unpack_field(packed)
        m = self.maps.get(key)
        if m is None:
            return None
        f = m.fields.get(field)
        return None if f is None else f.canon()

    def all_packed(self) -> list[bytes]:
        return sorted(
            pack_field(key, field)
            for key, m in self.maps.items()
            for field in m.fields
        )
