"""Mean ms a command of the cell's type waited for its repo's lock in the
window: SYSTEM METRICS ``SPAN lock_wait.<TYPE>.apply`` ms over its count,
their growth (the lock helper of models/manager.py; a command served on
the lock-free inline path takes no lock and is not counted)."""

from cardbench.metrics._span import span_mean


def read(record: dict) -> float | None:
    return span_mean(record, f"lock_wait.{record['config']['type']}.apply")
