"""Host-state table for the counter repos.

The counters' host bookkeeping — key interning, own contributions,
serving-value cache, dirty/pending-own/foreign flags — lives behind one
small table interface with two implementations, the port's copies of
jylis_tpu/models/counter_table.py:

* `PyTable` -- pure-Python dicts, the semantic oracle (``engine="python"``).
* `NativeTable` -- a view over one table of the native serving engine
  (native/engine.py). The same state the server's native burst applier
  mutates, so commands settled in C++ and Python-side drains and
  flushes share one source of truth.

Values are stored as u64 bit patterns; PNCOUNT decodes them as the
wrapped two's-complement i64 the reference's (p-n).i64() defines.
Polarity 0 is GCOUNT's only / PNCOUNT's P plane; polarity 1 is N.
"""

from __future__ import annotations

U64_MASK = (1 << 64) - 1


class PyTable:
    __slots__ = (
        "_keys", "_rkeys", "_value", "_own", "_ownset", "_pend", "_pendset",
        "_pend_rows", "_dirty", "_foreign", "_sync_dirty",
    )

    def __init__(self):
        self._keys: dict[bytes, int] = {}
        self._rkeys: list[bytes] = []
        self._value: list[int] = []  # u64 bits
        self._own = ([], [])  # per polarity, per row
        self._ownset = ([], [])
        self._pend = ([], [])
        self._pendset = ([], [])
        self._pend_rows: dict[int, None] = {}
        self._dirty: dict[int, None] = {}
        self._foreign: set[int] = set()
        self._sync_dirty: dict[int, None] = {}  # since last digest pass

    def rows(self) -> int:
        return len(self._rkeys)

    def upsert(self, key: bytes) -> int:
        row = self._keys.get(key)
        if row is None:
            row = len(self._rkeys)
            self._keys[key] = row
            self._rkeys.append(key)
            self._value.append(0)
            for pol in (0, 1):
                self._own[pol].append(0)
                self._ownset[pol].append(False)
                self._pend[pol].append(0)
                self._pendset[pol].append(False)
        return row

    def find(self, key: bytes) -> int:
        return self._keys.get(key, -1)

    def key_of(self, row: int) -> bytes:
        return self._rkeys[row]

    def inc(self, row: int, polarity: int, amount: int) -> None:
        own = (self._own[polarity][row] + amount) & U64_MASK
        self._own[polarity][row] = own
        self._ownset[polarity][row] = True
        if own > self._pend[polarity][row]:
            self._pend[polarity][row] = own
        if not (self._pendset[0][row] or self._pendset[1][row]):
            self._pend_rows[row] = None
        self._pendset[polarity][row] = True
        self._dirty[row] = None
        self._sync_dirty[row] = None
        delta = amount if polarity == 0 else -amount
        self._value[row] = (self._value[row] + delta) & U64_MASK

    def is_foreign(self, row: int) -> bool:
        return row in self._foreign

    def set_foreign(self, row: int) -> None:
        self._foreign.add(row)

    def value(self, row: int) -> int:
        return self._value[row]

    def own(self, row: int, polarity: int) -> int:
        return self._own[polarity][row]

    def own_max(self, row: int, polarity: int, v: int) -> None:
        if v > self._own[polarity][row]:
            self._own[polarity][row] = v
        self._ownset[polarity][row] = True

    def own_set(self, row: int) -> int:
        return (1 if self._ownset[0][row] else 0) | (
            2 if self._ownset[1][row] else 0
        )

    def apply_drain(self, rows, values) -> None:
        for row, v in zip(rows, values):
            self._value[row] = int(v) & U64_MASK
            self._foreign.discard(row)

    def pend_count(self) -> int:
        return len(self._pend_rows)

    def export_pending(self, clear: bool = True):
        rows = list(self._pend_rows)
        vp = [self._pend[0][r] if self._pendset[0][r] else 0 for r in rows]
        vn = [self._pend[1][r] if self._pendset[1][r] else 0 for r in rows]
        if clear:
            for r in rows:
                self._pend[0][r] = self._pend[1][r] = 0
                self._pendset[0][r] = self._pendset[1][r] = False
            self._pend_rows.clear()
        return rows, vp, vn

    def dirty_count(self) -> int:
        return len(self._dirty)

    def export_dirty(self):
        rows = list(self._dirty)
        op = [self._own[0][r] for r in rows]
        on = [self._own[1][r] for r in rows]
        sb = [self.own_set(r) for r in rows]
        self._dirty.clear()
        return rows, op, on, sb

    def export_sync_dirty(self) -> list[int]:
        rows = list(self._sync_dirty)
        self._sync_dirty.clear()
        return rows


class NativeTable:
    """One counter type's view over a shared native engine."""

    __slots__ = ("_eng", "_which")

    def __init__(self, engine, which: int):
        self._eng = engine
        self._which = which

    def rows(self) -> int:
        return self._eng.rows(self._which)

    def upsert(self, key: bytes) -> int:
        return self._eng.upsert(self._which, key)

    def find(self, key: bytes) -> int:
        return self._eng.find(self._which, key)

    def key_of(self, row: int) -> bytes:
        return self._eng.key_of(self._which, row)

    def inc(self, row: int, polarity: int, amount: int) -> None:
        self._eng.inc(self._which, row, polarity, amount)

    def is_foreign(self, row: int) -> bool:
        return self._eng.is_foreign(self._which, row)

    def set_foreign(self, row: int) -> None:
        self._eng.set_foreign(self._which, row)

    def value(self, row: int) -> int:
        return self._eng.value(self._which, row)

    def own(self, row: int, polarity: int) -> int:
        return self._eng.own(self._which, row, polarity)

    def own_max(self, row: int, polarity: int, v: int) -> None:
        self._eng.own_max(self._which, row, polarity, v)

    def own_set(self, row: int) -> int:
        return self._eng.own_set(self._which, row)

    def apply_drain(self, rows, values) -> None:
        self._eng.apply_drain(self._which, rows, values)

    def pend_count(self) -> int:
        return self._eng.pend_count(self._which)

    def export_pending(self, clear: bool = True):
        rows, vp, vn = self._eng.export_pending(self._which, clear=clear)
        return rows.tolist(), vp.tolist(), vn.tolist()

    def dirty_count(self) -> int:
        return self._eng.dirty_count(self._which)

    def export_dirty(self):
        rows, op, on, sb = self._eng.export_dirty(self._which)
        return rows.tolist(), op.tolist(), on.tolist(), sb.tolist()

    def export_sync_dirty(self) -> list[int]:
        return self._eng.export_sync_dirty(self._which)
