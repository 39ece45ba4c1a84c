"""The card's memory rate: the bound of the drains' roofline share
(metrics/drain_roofline_pct.py), whichever kernel implements a drain.

A drain batch's bytes: each input byte read once and each output byte
written once, per key of the batch, for the layout the configuration
fixes, not the program's; the data type's module (types/<type>.py)
gives a drained key's bytes (``drain_bytes_per_key``) and the kernels
that implement its drains (``DRAIN_KERNELS``).
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet): HBM3 at 3.35 TB/s, at the 700 W limit
HBM_BYTES_PER_S = {"H100": 3.35e12}


def memory_rate(kind: str) -> float | None:
    """The card's memory rate (bytes/s), None for a card not in the
    table."""
    return next((v for k, v in HBM_BYTES_PER_S.items() if k in kind), None)
