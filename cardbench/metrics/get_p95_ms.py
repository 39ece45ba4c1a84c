"""95th percentile of every RESP GET of the window, from its scheduled
send; a failed GET counts as missing (at the reply timeout)."""

from cardbench.metrics._common import percentile


def read(record: dict) -> float | None:
    gets = record["gets"]
    return percentile(gets["lat_ms"], 95) if gets else None
