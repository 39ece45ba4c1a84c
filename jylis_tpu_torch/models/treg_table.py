"""Host-state table for the TREG repo.

TREG's host bookkeeping — key interning, the serving winner, the pending
drain window and the outbound delta accumulator — lives behind one small
table interface with two implementations, the port's copies of
jylis_tpu/models/treg_table.py: `PyTregTable` (pure-Python, the oracle,
``engine="python"``) and `NativeTregTable` (a view over the native
serving engine's TREG table: the same state the server's burst applier
mutates).

The winner rule is lexicographic (ts, value-bytes) — the reference's
TReg last-writer-wins with value tiebreak (repo_treg.pony:24-68). The
winner is the join of the drained cache and the pending window, so a
drain never changes it: `fold_pend` just moves the window into the
cache.
"""

from __future__ import annotations


class PyTregTable:
    __slots__ = ("_keys", "_rkeys", "_cache", "_pending", "_deltas",
                 "_sync_dirty")

    def __init__(self):
        self._keys: dict[bytes, int] = {}
        self._rkeys: list[bytes] = []
        self._cache: dict[int, tuple[int, bytes]] = {}  # drained winner
        self._pending: dict[int, tuple[int, bytes]] = {}  # max since drain
        self._deltas: dict[int, tuple[int, bytes]] = {}  # max since flush
        self._sync_dirty: dict[int, None] = {}  # since last digest pass

    def rows(self) -> int:
        return len(self._rkeys)

    def upsert(self, key: bytes) -> int:
        row = self._keys.get(key)
        if row is None:
            row = len(self._rkeys)
            self._keys[key] = row
            self._rkeys.append(key)
        return row

    def find(self, key: bytes) -> int:
        return self._keys.get(key, -1)

    def key_of(self, row: int) -> bytes:
        return self._rkeys[row]

    def write(self, row: int, ts: int, value: bytes) -> None:
        self._sync_dirty[row] = None
        cur = self._pending.get(row)
        if cur is None or (ts, value) > cur:
            self._pending[row] = (ts, value)

    def note_delta(self, row: int, ts: int, value: bytes) -> None:
        cur = self._deltas.get(row)
        if cur is None or (ts, value) > cur:
            self._deltas[row] = (ts, value)

    def winner(self, row: int) -> tuple[int, bytes] | None:
        c = self._cache.get(row)
        p = self._pending.get(row)
        if c is None:
            return p
        if p is None:
            return c
        return max(c, p)

    def pend_count(self) -> int:
        return len(self._pending)

    def export_pend(self) -> list[tuple[int, int, bytes]]:
        return [(row, ts, v) for row, (ts, v) in self._pending.items()]

    def fold_pend(self) -> None:
        for row, p in self._pending.items():
            c = self._cache.get(row)
            if c is None or p > c:
                self._cache[row] = p
        self._pending.clear()

    def deltas_size(self) -> int:
        return len(self._deltas)

    def flush_deltas(self):
        out = sorted(
            (self._rkeys[row], (v, ts)) for row, (ts, v) in self._deltas.items()
        )
        self._deltas.clear()
        return out

    def dump(self):
        out = []
        for key, row in sorted(self._keys.items()):
            w = self.winner(row)
            if w is not None:
                out.append((key, (w[1], w[0])))
        return out

    def export_sync_dirty(self) -> list[int]:
        rows = list(self._sync_dirty)
        self._sync_dirty.clear()
        return rows


class NativeTregTable:
    """The TREG view over a shared native serving engine."""

    __slots__ = ("_eng",)

    def __init__(self, engine):
        self._eng = engine

    def rows(self) -> int:
        return self._eng.treg_rows()

    def upsert(self, key: bytes) -> int:
        return self._eng.treg_upsert(key)

    def find(self, key: bytes) -> int:
        return self._eng.treg_find(key)

    def key_of(self, row: int) -> bytes:
        return self._eng.treg_key_of(row)

    def write(self, row: int, ts: int, value: bytes) -> None:
        self._eng.treg_write(row, ts, value)

    def note_delta(self, row: int, ts: int, value: bytes) -> None:
        self._eng.treg_note_delta(row, ts, value)

    def winner(self, row: int) -> tuple[int, bytes] | None:
        return self._eng.treg_winner(row)

    def pend_count(self) -> int:
        return self._eng.treg_pend_count()

    def export_pend(self) -> list[tuple[int, int, bytes]]:
        return self._eng.treg_export_pend()

    def fold_pend(self) -> None:
        self._eng.treg_fold_pend()

    def deltas_size(self) -> int:
        return self._eng.treg_delta_count()

    def flush_deltas(self):
        return self._eng.treg_flush_deltas()

    def dump(self):
        out = []
        for row in range(self._eng.treg_rows()):
            w = self._eng.treg_winner(row)
            if w is not None:
                out.append((self._eng.treg_key_of(row), (w[1], w[0])))
        out.sort()
        return out

    def export_sync_dirty(self) -> list[int]:
        return self._eng.treg_export_sync_dirty()
