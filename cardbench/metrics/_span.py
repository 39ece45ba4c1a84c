"""What the readers of the program's spans share: a span field's growth
over the window from SYSTEM METRICS' SPAN section (``SPAN <name> <field>
<value>``), or None where the program shows no such span."""

from cardbench.metrics._common import delta


def span_delta(record: dict, name: str, field: str) -> float | None:
    line = f"SPAN {name} {field}"
    if line not in record["system_metrics"]["after"]:
        return None
    return delta(record, line)


def span_mean(record: dict, name: str, over: str = "count") -> float | None:
    """The span's ms growth per unit of ``over``'s growth (its count or
    items); None without the span or with no growth of ``over``."""
    ms, n = span_delta(record, name, "ms"), span_delta(record, name, over)
    return ms / n if ms is not None and n else None
