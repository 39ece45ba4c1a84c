"""The share of the traced window in which no operation ran on the card
(1 - union of the busy intervals / window)."""


def read(record: dict) -> float | None:
    trace = record["trace"]
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
