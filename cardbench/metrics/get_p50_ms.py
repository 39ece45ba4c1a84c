"""Median of every RESP GET of the window, from its scheduled send."""

from cardbench.metrics._common import percentile


def read(record: dict) -> float | None:
    gets = record["gets"]
    return percentile(gets["lat_ms"], 50) if gets else None
