"""TREG as jylis defines it (repo_treg.pony:24-68, docs/types/treg.md:30):
a register holds one (value, timestamp) pair; a pair beats another when
its timestamp is higher, or when the timestamps are equal and its value
is lexicographically larger."""

from __future__ import annotations

import numpy as np


class TReg:
    """``num_keys`` registers of fixed-length values; ``ts_dtype`` is the
    timestamps' type (uint64 as jylis states; uint32 only for the
    lower-precision control). Unset registers hold ``set`` False."""

    def __init__(self, num_keys: int, value_bytes: int, ts_dtype=np.uint64):
        self.ts_dtype = np.dtype(ts_dtype)
        self.set = np.zeros(num_keys, bool)
        self.ts = np.zeros(num_keys, self.ts_dtype)
        self.value = np.zeros(num_keys, f"S{value_bytes}")

    def join(self, keys: np.ndarray, values: np.ndarray, ts: np.ndarray) -> None:
        """Converge deltas (values[i], ts[i]) at ``keys`` (unique within
        one call); ``values`` is an (n, value_bytes) uint8 array."""
        ts = np.asarray(ts, np.uint64).astype(self.ts_dtype)
        vals = np.ascontiguousarray(values).view(self.value.dtype).ravel()
        cur_ts, cur_val = self.ts[keys], self.value[keys]
        wins = ~self.set[keys] | (ts > cur_ts) | ((ts == cur_ts) & (vals > cur_val))
        k = keys[wins]
        self.set[k] = True
        self.ts[k] = ts[wins]
        self.value[k] = vals[wins]
