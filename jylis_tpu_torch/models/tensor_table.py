"""Host-state backend for the TENSOR repo.

The port's copy of jylis_tpu/models/tensor_table.py (the
counter_table.py / treg_table.py pattern, pure-Python only: the table
IS the host truth). Every cell is an
ops/tensor_host.Tensor; the serving winner is the join of the drained
cache and the pending window, so a drain never changes what GET
observes (``fold_pend`` just moves the window into the cache) — the
"observe-first" posture: reads observe host state, only writes
schedule device work.
"""

from __future__ import annotations

from ..ops.tensor_host import Tensor


def _joined(a: Tensor | None, b: Tensor | None) -> Tensor | None:
    """Always a FRESH Tensor: winners escape the table into sync canons,
    snapshot dumps, and cluster sync-dump encodes that run in worker
    threads after the repo lock is released — the live cache/pending
    objects must never alias out, or a concurrent drain's in-place
    converge corrupts the bytes mid-encode."""
    if a is None and b is None:
        return None
    out = Tensor()
    if a is not None:
        out.converge(a)
    if b is not None:
        out.converge(b)
    return out


class PyTensorTable:
    __slots__ = ("_keys", "_rkeys", "_cache", "_pending", "_deltas",
                 "_sync_dirty")

    def __init__(self):
        self._keys: dict[bytes, int] = {}
        self._rkeys: list[bytes] = []
        self._cache: dict[int, Tensor] = {}  # drained winner
        self._pending: dict[int, Tensor] = {}  # joined since last drain
        self._deltas: dict[int, Tensor] = {}  # joined since last flush
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

    def stamp(self, row: int) -> tuple[int, int] | None:
        """(mode, dim) of the row's winner — the RESP boundary's
        mismatch check reads this before admitting a write."""
        w = self.winner(row)
        return None if w is None or w.mode == 0 else (w.mode, w.dim)

    def write(self, row: int, delta: Tensor) -> None:
        self._sync_dirty[row] = None
        cur = self._pending.get(row)
        if cur is None:
            cur = Tensor()
            self._pending[row] = cur
        cur.converge(delta)

    def note_delta(self, row: int, delta: Tensor) -> None:
        cur = self._deltas.get(row)
        if cur is None:
            cur = Tensor()
            self._deltas[row] = cur
        cur.converge(delta)

    def winner(self, row: int) -> Tensor | None:
        return _joined(self._cache.get(row), self._pending.get(row))

    def pend_count(self) -> int:
        return len(self._pending)

    def export_pend(self) -> list[tuple[int, Tensor]]:
        return list(self._pending.items())

    def fold_pend(self) -> None:
        for row, p in self._pending.items():
            c = self._cache.get(row)
            if c is None:
                c = Tensor()
                self._cache[row] = c
            c.converge(p)
        self._pending.clear()

    def deltas_size(self) -> int:
        return len(self._deltas)

    def flush_deltas(self):
        out = sorted(
            (self._rkeys[row], t) for row, t in self._deltas.items()
        )
        self._deltas.clear()
        return out

    def dump(self):
        out = []
        for key, row in sorted(self._keys.items()):
            w = self.winner(row)
            if w is not None and w.mode != 0:
                out.append((key, w))
        return out

    def export_sync_dirty(self) -> list[int]:
        rows = list(self._sync_dirty)
        self._sync_dirty.clear()
        return rows
