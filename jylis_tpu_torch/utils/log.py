"""Leveled logger with a dual sink into the replicated SYSTEM log.

Reference analog: log.pony:10-84 — level-gated predicates with the
short-circuit idiom (``log.info() and log.i("...")`` skips formatting cost
when the level is off), a "(L) " level prefix, and every emitted line going
both to the output stream and into the SYSTEM repo's TLog (via System),
which makes the server's own log a CRDT queryable cluster-wide
(SURVEY.md section 2.6).
"""

from __future__ import annotations

import sys

_LEVELS = {"debug": 0, "info": 1, "warn": 2, "err": 3, "none": 4}


class Log:
    def __init__(self, level: str = "info", out=None):
        self._level = _LEVELS[level]
        self._out = out if out is not None else sys.stderr
        self._sys_sink = None  # System.log callback

    @classmethod
    def create_none(cls) -> "Log":
        return cls("none")

    def set_sys(self, sink) -> None:
        self._sys_sink = sink

    # level predicates (log.pony:31-34)
    def debug(self) -> bool:
        return self._level <= 0

    def info(self) -> bool:
        return self._level <= 1

    def warn(self) -> bool:
        return self._level <= 2

    def err(self) -> bool:
        return self._level <= 3

    def _emit(self, tag: str, s: str) -> bool:
        line = f"({tag}) {s}"
        if self._sys_sink is not None:
            self._sys_sink(line)
        if self._out is not None:
            print(line, file=self._out, flush=True)
        return True

    def d(self, s: str) -> bool:
        return self._emit("D", s)

    def i(self, s: str) -> bool:
        return self._emit("I", s)

    def w(self, s: str) -> bool:
        return self._emit("W", s)

    def e(self, s: str) -> bool:
        return self._emit("E", s)

    def inspect(self, *xs) -> bool:
        return self._emit("D", "; ".join(repr(x) for x in xs))
