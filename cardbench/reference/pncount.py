"""PNCOUNT as jylis defines it (repo_pncount.pony:26-67): per key, two
planes of per-replica u64 counters that join by the per-replica max; a
key's value is the wrapping u64 sum of its p column minus that of its n
column, read as a signed 64-bit integer."""

from __future__ import annotations

import numpy as np


class PNCount:
    """The state of ``num_keys`` keys over the replica ids seen so far,
    held as two (keys, replicas) planes of ``dtype`` (uint64 as jylis
    states; a narrower type only for the lower-precision control)."""

    def __init__(self, num_keys: int, dtype=np.uint64):
        self.num_keys = num_keys
        self.dtype = np.dtype(dtype)
        self.cols: dict[int, int] = {}
        self.p = np.zeros((num_keys, 0), self.dtype)
        self.n = np.zeros((num_keys, 0), self.dtype)

    def _col(self, rid: int) -> int:
        col = self.cols.get(rid)
        if col is None:
            col = self.cols[rid] = len(self.cols)
            pad = np.zeros((self.num_keys, 1), self.dtype)
            self.p = np.hstack([self.p, pad])
            self.n = np.hstack([self.n, pad])
        return col

    def join(self, keys: np.ndarray, rid: int, p: np.ndarray, n: np.ndarray) -> None:
        """Converge one replica's deltas ({rid: p[i]}, {rid: n[i]}) at
        ``keys`` (unique within one call)."""
        col = self._col(rid)
        p = np.asarray(p, np.uint64).astype(self.dtype)
        n = np.asarray(n, np.uint64).astype(self.dtype)
        self.p[keys, col] = np.maximum(self.p[keys, col], p)
        self.n[keys, col] = np.maximum(self.n[keys, col], n)

    def values(self) -> np.ndarray:
        """Every key's value: int64 for uint64 planes (the sums wrap at
        2^64), the narrower signed type otherwise."""
        with np.errstate(over="ignore"):
            p = self.p.sum(axis=1, dtype=self.dtype)
            n = self.n.sum(axis=1, dtype=self.dtype)
            diff = (p - n).astype(self.dtype)
        return diff.view(np.dtype(f"i{self.dtype.itemsize}"))
