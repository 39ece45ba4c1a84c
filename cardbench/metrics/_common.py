"""What several readers share: percentiles and SYSTEM METRICS deltas."""

from __future__ import annotations

import math

# a GET that failed or never came counts at the reader's reply timeout
MISSING_MS = 60_000.0


def percentile(values, q: float) -> float | None:
    """The nearest-rank ``q`` percentile; None of no values."""
    xs = sorted(MISSING_MS if v is None else v for v in values)
    if not xs:
        return None
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def delta(record: dict, name: str) -> float:
    """A SYSTEM METRICS counter's growth over the window."""
    m = record["system_metrics"]
    return m["after"].get(name, 0.0) - m["before"].get(name, 0.0)
