"""Mean ms one converge of the cell's type held its repo's lock in the
window: ``SPAN lock_hold.<TYPE>.converge`` ms over its count, their
growth. One converge is one cluster frame's batch, its slices and the
yields between them included."""

from cardbench.metrics._span import span_mean


def read(record: dict) -> float | None:
    return span_mean(record, f"lock_hold.{record['config']['type']}.converge")
