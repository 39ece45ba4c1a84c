"""Keys per drain of the cell's type in the window (SYSTEM METRICS
``<TYPE> keys`` over ``<TYPE> drains``, their growth)."""

from cardbench.metrics._common import delta


def read(record: dict) -> float | None:
    t = record["config"]["type"]
    drains = delta(record, f"{t} drains")
    return delta(record, f"{t} keys") / drains if drains else None
