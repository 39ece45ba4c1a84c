"""Host ms per drain of the cell's type spent writing the batch into the
staging buffers in the window: ``SPAN drain.<TYPE>.fill`` ms over
``<TYPE> drains``, their growth (parallel/sharded.py's staged call)."""

from cardbench.metrics._common import delta
from cardbench.metrics._span import span_delta


def read(record: dict) -> float | None:
    t = record["config"]["type"]
    ms, drains = span_delta(record, f"drain.{t}.fill", "ms"), delta(record, f"{t} drains")
    return ms / drains if ms is not None and drains else None
