"""Bytes a drain batch needs, whichever kernel implements it, and the
card's memory rate.

Each input byte read once and each output byte written once, per key of
the batch, for the layout the configuration fixes (its replica count),
not the program's (a plane wider than the replicas in use is the
program's choice). What the data decides, such as how many registers a
TREG batch changes, is not counted, so the bound is a lower bound and a
share of it never overstates.

* Counter drain (GCOUNT ``planes`` = 1, PNCOUNT 2), per key: the key's
  state row read and written and its delta row read (``planes x
  replicas x 8`` bytes each), its row index (4) and its value out (8).
  (``chip_smoke.py``'s count of a sparse drain at live = B, with R the
  configuration's replicas.)
* TREG drain, per key: its row index (4); its delta and its state
  register read (ts 8, value-prefix rank 8, value id 4: 20 each); its
  result out (tie flag 1, ts 8, value id 4). A register the delta wins
  would add 20 written; it is not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet): HBM3 at 3.35 TB/s, at the 700 W limit
HBM_BYTES_PER_S = {"H100": 3.35e12}

COUNTER_PLANES = {"GCOUNT": 1, "PNCOUNT": 2}

# the kernels that implement each type's drains, by name
DRAIN_KERNELS = {
    "GCOUNT": ("counter_drain_sparse", "counter_drain_dense", "scatter_slots"),
    "PNCOUNT": ("counter_drain_sparse", "counter_drain_dense", "scatter_slots"),
    "TREG": ("treg_drain_sparse", "treg_drain_dense", "treg_dense_clear", "scatter_slots"),
}


def counter_bytes_per_key(planes: int, replicas: int) -> int:
    return planes * replicas * 8 * 3 + 4 + 8


TREG_BYTES_PER_KEY = 4 + 20 + 20 + 1 + 8 + 4


def drain_bytes(type_name: str, keys: float, replicas: int) -> float:
    """The bytes ``keys`` drained keys need."""
    if type_name in COUNTER_PLANES:
        return keys * counter_bytes_per_key(COUNTER_PLANES[type_name], replicas)
    if type_name == "TREG":
        return keys * TREG_BYTES_PER_KEY
    raise ValueError(f"no drain bytes for {type_name}")


def memory_rate(kind: str) -> float | None:
    """The card's memory rate (bytes/s), None for a card not in the
    table."""
    return next((v for k, v in HBM_BYTES_PER_S.items() if k in kind), None)
