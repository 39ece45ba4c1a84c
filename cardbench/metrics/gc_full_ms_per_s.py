"""Ms of full (generation 2) collections per second of the window:
``SPAN gc.full`` ms growth over the window's seconds. A full collection
stops every thread of the node's process."""

from cardbench.metrics._span import span_delta


def read(record: dict) -> float | None:
    ms = span_delta(record, "gc.full", "ms")
    return ms / record["window_s"] if ms is not None and record["window_s"] else None
