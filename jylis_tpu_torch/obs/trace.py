"""Bounded structured trace ring.

The port's copy of jylis_tpu/obs/trace.py (:1-65), unchanged in
behaviour: a fixed-size deque of (ts_ms, subsystem, event, reason,
detail) tuples that keeps the LAST `cap` structured events queryable
from any Redis client (`SYSTEM TRACE [count]`).

Memory is bounded twice: `deque(maxlen=cap)` overwrites oldest-first,
and `detail` is truncated to DETAIL_CAP characters. Appends are
GIL-atomic (deque.append), so events from worker threads interleave
safely with the event loop's.
"""

from __future__ import annotations

import time
from collections import deque

DEFAULT_CAP = 512
DETAIL_CAP = 200


def now_ms() -> int:
    return time.time_ns() // 1_000_000


class TraceRing:
    __slots__ = ("cap", "_ring")

    def __init__(self, cap: int = DEFAULT_CAP):
        self.cap = cap
        self._ring: deque = deque(maxlen=cap)

    def push(
        self, subsystem: str, event: str, reason: str = "", detail: str = ""
    ) -> None:
        detail = str(detail)
        if len(detail) > DETAIL_CAP:
            detail = detail[:DETAIL_CAP]
        self._ring.append((now_ms(), subsystem, event, str(reason), detail))

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self, count: int | None = None) -> list[tuple]:
        """Chronological (oldest first); the newest `count` when given."""
        items = list(self._ring)
        if count is not None and count < len(items):
            items = items[len(items) - count :]
        return items

    @staticmethod
    def format(entry: tuple) -> str:
        ts, subsystem, event, reason, detail = entry
        out = f"{ts} {subsystem} {event}"
        if reason:
            out += f" {reason}"
        if detail:
            out += f" | {detail}"
        return out
