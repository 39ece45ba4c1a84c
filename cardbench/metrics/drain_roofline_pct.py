"""The drain kernels' share of their memory bound in the window: the
bytes the window's drained keys need (roofline/drains.py) over the card's
memory rate, against the device time of the kernels that implement the
type's drains (by name, from the trace)."""

from cardbench.metrics._common import delta
from cardbench.roofline.drains import DRAIN_KERNELS, drain_bytes, memory_rate


def read(record: dict) -> float | None:
    trace = record["trace"]
    cfg = record["config"]
    rate = memory_rate(record["device"]["kind"])
    if trace is None or rate is None:
        return None
    names = DRAIN_KERNELS.get(cfg["type"], ())
    device_s = sum(s for op, s in trace["device_ops"].items() if any(n in op for n in names))
    keys = delta(record, f"{cfg['type']} keys")
    if device_s <= 0 or keys <= 0:
        return None
    return 100.0 * drain_bytes(cfg["type"], keys, cfg["replicas"]) / rate / device_s
