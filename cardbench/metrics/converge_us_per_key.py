"""Host us per converged key of the cell's type in the window: ``SPAN
converge.<TYPE>`` ms x 1000 over its items (each converge slice's keys),
their growth."""

from cardbench.metrics._span import span_mean


def read(record: dict) -> float | None:
    ms_per_key = span_mean(record, f"converge.{record['config']['type']}", "items")
    return None if ms_per_key is None else ms_per_key * 1e3
