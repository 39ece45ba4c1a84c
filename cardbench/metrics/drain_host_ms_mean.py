"""Host ms per drain of the cell's type in the window: SYSTEM METRICS
``<TYPE> device_ms`` over ``<TYPE> drains``. The registry times the
drain call on the host with no device sync (utils/metrics.timed_drain),
so this is the drain's host time, not its device time."""

from cardbench.metrics._common import delta


def read(record: dict) -> float | None:
    t = record["config"]["type"]
    drains = delta(record, f"{t} drains")
    return delta(record, f"{t} device_ms") / drains if drains else None
