"""The drain kernels' share of their memory bound in the window: the
bytes the window's drained keys need (roofline/drains.py, with the
type module's bytes a key) over the card's memory rate, against the
device time of the kernels that implement the type's drains (the type
module's ``DRAIN_KERNELS``, by name, from the trace)."""

from cardbench.metrics._common import delta
from cardbench.roofline.drains import memory_rate


def read(record: dict) -> float | None:
    trace = record["trace"]
    cfg = record["config"]
    rate = memory_rate(record["device"]["kind"])
    if trace is None or rate is None:
        return None
    kind = record["type_module"]
    device_s = sum(s for op, s in trace["device_ops"].items()
                   if any(n in op for n in kind.DRAIN_KERNELS))
    keys = delta(record, f"{cfg['type']} keys")
    if device_s <= 0 or keys <= 0:
        return None
    return 100.0 * (keys * kind.drain_bytes_per_key(cfg)) / rate / device_s
