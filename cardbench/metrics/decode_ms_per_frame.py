"""Host ms per cluster frame decoded in the window: ``SPAN decode.frame``
ms over its count, their growth (``codec.decode`` in the cluster's read
loop)."""

from cardbench.metrics._span import span_mean


def read(record: dict) -> float | None:
    return span_mean(record, "decode.frame")
