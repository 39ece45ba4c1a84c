"""The native RESP scanner behind the incremental-parser interface of
server/resp.RespParser.

The port's copy of jylis_tpu/native/resp.py. The scanner reads straight
out of the Python buffer through its address and parses a whole
pipelined burst per FFI call (``resp_scan_many``), so a command costs
one C struct walk plus the bytes objects it yields.

``make_parser(engine)`` takes the node's engine (a ``ServeEngine``, or
None for the pure-Python tables): a native node gets the native scanner,
a Python node the Python parser. It never asks whether the library
happens to exist.
"""

from __future__ import annotations

import ctypes
from collections import deque

from ..server.resp import RespError, RespParser

_MAX_CMDS = 256
_INITIAL_ARGS = 1024


class NativeRespParser:
    """Incremental RESP command parser over native resp_scan_many."""

    __slots__ = ("_buf", "_lib", "_ready", "_bad", "_argc", "_offs", "_lens", "_cap")

    def __init__(self, cdll):
        self._buf = bytearray()
        self._lib = cdll
        self._ready: deque[list[bytes]] = deque()
        self._bad = False  # protocol error after serving queued commands
        self._argc = (ctypes.c_int32 * _MAX_CMDS)()
        self._cap = _INITIAL_ARGS
        self._offs = (ctypes.c_int64 * self._cap)()
        self._lens = (ctypes.c_int64 * self._cap)()

    def append(self, data: bytes) -> None:
        self._buf += data

    def has_pending(self) -> bool:
        """Unconsumed bytes held (a split command's head): while true the
        stream's head belongs to this parser, not the native engine."""
        return bool(self._buf)

    def take_tail(self) -> bytes | None:
        """Hand the held bytes back to the caller (and forget them), so
        the stream's head can return to the native engine. Only legal
        when every parsed command has been iterated out and the stream
        is well-formed; returns None otherwise (the caller then keeps
        routing through this parser)."""
        if self._ready or self._bad:
            return None
        out = bytes(self._buf)
        del self._buf[:]
        return out

    def __iter__(self):
        return self

    def __next__(self) -> list[bytes]:
        if not self._ready:
            self._scan_burst()
        if self._ready:
            return self._ready.popleft()
        if self._bad:
            # the scanner stops with the malformed bytes at the buffer
            # head (it serves the prefix first); the oracle parser renders
            # the specific error, so both serving paths reply the same
            # client-visible bytes
            oracle = RespParser()
            oracle.append(bytes(self._buf))
            for _ in oracle:  # raises the specific RespError
                pass
            raise RespError("protocol error")  # scanner and oracle disagree
        raise StopIteration

    def _scan_burst(self) -> None:
        while not self._bad:
            if not self._buf:
                return
            consumed = ctypes.c_int64()
            n_args = ctypes.c_int32()
            base = ctypes.addressof(ctypes.c_char.from_buffer(self._buf))
            rc = self._lib.resp_scan_many(
                ctypes.c_void_p(base), len(self._buf), ctypes.byref(consumed),
                self._argc, _MAX_CMDS,
                self._offs, self._lens, self._cap, ctypes.byref(n_args),
            )
            if rc == -2:  # grow the slice arrays and rescan
                self._cap = max(self._cap * 2, n_args.value)
                self._offs = (ctypes.c_int64 * self._cap)()
                self._lens = (ctypes.c_int64 * self._cap)()
                continue
            if rc == -1:
                self._bad = True
                return
            if rc == 0:
                return  # incomplete tail: wait for more input
            view = memoryview(self._buf)
            offs, lens, argc = self._offs, self._lens, self._argc
            a = 0
            for c in range(rc):
                n = argc[c]
                if n < 0:  # blank inline line: the oracle parser skips it
                    continue
                self._ready.append(
                    [bytes(view[offs[a + i] : offs[a + i] + lens[a + i]]) for i in range(n)]
                )
                a += n
            del view  # a live memoryview blocks bytearray resizing
            del self._buf[: consumed.value]
            if rc < _MAX_CMDS:
                return  # buffer exhausted of complete commands


def make_parser(engine):
    """The parser for a node whose engine is ``engine``: the native
    scanner (from the engine's own library) for a native engine, the
    pure-Python parser for None."""
    return RespParser() if engine is None else NativeRespParser(engine.cdll)
