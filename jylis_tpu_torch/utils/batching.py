"""Batch-shape helpers for the counter repos (models/): pad rows and
power-of-two batch buckets, the same values the JAX package uses so both
packages hand their drains identical batches.
"""

from __future__ import annotations

import numpy as np

# batch-padding row index: out of range for any real keyspace; every drain
# masks rows >= K, so a pad slot never touches state
PAD_ROW = (1 << 31) - 1


def pad_rows(n: int):
    """(n,) int32 of DISTINCT out-of-range rows (PAD_ROW, PAD_ROW-1, ...).

    Distinct descending pads keep the whole index vector unique, which
    the sparse drain relies on (one warp owns one row) — real keyspaces
    are far smaller than PAD_ROW - n."""
    return (PAD_ROW - np.arange(n)).astype(np.int32)


def bucket(n: int, lo: int = 16) -> int:
    """Next power of two >= n (>= lo): the batch and capacity buckets."""
    b = lo
    while b < n:
        b <<= 1
    return b
