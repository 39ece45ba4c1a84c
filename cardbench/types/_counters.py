"""What the counter types (GCOUNT, PNCOUNT) share: the readback of every
key's GET, the comparison of the values, and the drains' roofline.

Counter drain (GCOUNT ``planes`` = 1, PNCOUNT 2), per key: the key's
state row read and written and its delta row read (``planes x replicas
x 8`` bytes each), its row index (4) and its value out (8), for the
layout the configuration fixes (its replica count), not the program's
(a plane wider than the replicas in use is the program's choice).
(``chip_smoke.py``'s count of a sparse drain at live = B, with R the
configuration's replicas.)
"""

from __future__ import annotations

import numpy as np

# a phase ends with a GET of one key of each peer's last acknowledged
# frame, so the phase's deltas are joined into the state when it closes
DRAIN_AT_CLOSE = True

# the kernels that implement the counters' drains, by name
DRAIN_KERNELS = ("counter_drain_sparse", "counter_drain_dense", "scatter_slots")


def bytes_per_key(planes: int, replicas: int) -> int:
    return planes * replicas * 8 * 3 + 4 + 8


def read_gets(resp, cfg: dict, keys: np.ndarray, dtype=np.int64) -> tuple[np.ndarray, int]:
    """Every key's GET as ``dtype``, and how many replies were not
    integers."""
    t = cfg["type"].encode()
    replies = resp.pipeline([[t, b"GET", keys[i].tobytes()] for i in range(len(keys))])
    bad = sum(not isinstance(r, int) for r in replies)
    vals = np.array([r if isinstance(r, int) else 0 for r in replies], dtype)
    return vals, bad


def compare_values(values: np.ndarray, unread: int, want: np.ndarray) -> dict:
    """Every key's GET against the reference's value. A GET's value is
    the row sum the drain kernels wrote into the host value cache, so it
    covers the wire decode, converge, the sparse and dense drains on the
    card, the cache and the RESP reply."""
    return {"wrong_values": int(np.count_nonzero(values != want)), "unread_keys": int(unread)}
