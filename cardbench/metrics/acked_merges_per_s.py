"""Key-replica deltas the node acknowledged over the whole window, per
second of it (the window closes once a drain-forcing read has returned
on a counter cell)."""


def read(record: dict) -> float | None:
    return record["merges"] / record["window_s"] if record["merges"] else None
