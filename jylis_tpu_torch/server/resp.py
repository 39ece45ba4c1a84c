"""RESP (Redis Serialization Protocol) codec.

The rebuild's equivalent of the pony-resp dependency (reference:
server_notify.pony:33-36 feeds bytes to CommandParser; every repo replies
through Respond). Two halves:

* ``Respond`` — streaming reply writer over a byte sink. The sink
  indirection is the testability seam the reference relies on
  (test/test_cluster.pony:6-41 fakes it): the engine is drivable with no
  socket anywhere.
* ``RespParser`` — incremental command parser: RESP arrays of bulk strings
  (what real clients send) plus inline space-separated commands (what
  humans type into nc), yielding complete commands as lists of bytes.

Reply byte shapes are pinned by the reference's integration test
(test/test_cluster.pony:123-128: b"+OK\\r\\n", b":9\\r\\n") and the
docs (docs/_docs/start/connect.md: any Redis client is compatible).

The native scanner (native/resp.py) slots in behind the same parser
interface; this pure-Python one is the oracle for its error messages.
"""

from __future__ import annotations

CRLF = b"\r\n"


class RespError(Exception):
    """Protocol-level error: the connection should be dropped (reference:
    server_notify.pony:19-22 disposes the connection on parse errors)."""


class Respond:
    """Streaming RESP reply writer; ``sink`` receives encoded bytes."""

    __slots__ = ("_sink",)

    def __init__(self, sink):
        self._sink = sink

    def ok(self) -> None:
        self._sink(b"+OK" + CRLF)

    def simple(self, s: str) -> None:
        self._sink(b"+" + s.encode() + CRLF)

    def err(self, msg: str) -> None:
        self._sink(b"-" + msg.encode() + CRLF)

    def u64(self, n: int) -> None:
        self._sink(b":%d" % n)
        self._sink(CRLF)

    def i64(self, n: int) -> None:
        self._sink(b":%d" % n)
        self._sink(CRLF)

    def string(self, s) -> None:
        if isinstance(s, str):
            s = s.encode()
        self._sink(b"$%d" % len(s) + CRLF + s + CRLF)

    def null(self) -> None:
        self._sink(b"$-1" + CRLF)

    def array_start(self, n: int) -> None:
        self._sink(b"*%d" % n + CRLF)


class RespParser:
    """Incremental RESP command parser.

    Feed raw socket bytes with ``append``; iterate complete commands (each a
    ``list[bytes]``). Malformed protocol raises RespError. Handles both RESP
    arrays (``*N\\r\\n$len\\r\\n...``) and inline commands (plain text line,
    space-separated) like real Redis servers do.
    """

    _MAX_BULK = 512 * 1024 * 1024  # Redis's proto-max-bulk-len default

    def __init__(self):
        self._buf = bytearray()

    def append(self, data: bytes) -> None:
        self._buf += data

    def has_pending(self) -> bool:
        """Unconsumed bytes held (a split command's head): while true the
        stream's head belongs to this parser, not the native engine."""
        return bool(self._buf)

    def take_tail(self) -> bytes | None:
        """Hand the held bytes back to the caller (and forget them), so
        the stream's head can return to the native engine. Only legal
        once every complete command has been iterated out; ``_buf`` then
        holds exactly the split tail."""
        out = bytes(self._buf)
        self._buf.clear()
        return out

    def __iter__(self):
        return self

    def __next__(self) -> list[bytes]:
        cmd = self._try_parse()
        if cmd is None:
            raise StopIteration
        return cmd

    # -- internals ----------------------------------------------------------

    def _find_line(self, start: int):
        idx = self._buf.find(b"\r\n", start)
        if idx < 0:
            if len(self._buf) - start > 64 * 1024:
                raise RespError("protocol error: line too long")
            return None, start
        return bytes(self._buf[start:idx]), idx + 2

    def _try_parse(self):
        if not self._buf:
            return None
        if self._buf[0:1] != b"*":
            # inline command: one text line, split on whitespace
            line, pos = self._find_line(0)
            if line is None:
                return None
            del self._buf[:pos]
            parts = line.split()
            return parts if parts else self._try_parse()

        line, pos = self._find_line(0)
        if line is None:
            return None
        if not line[1:].isdigit():  # strict: no +, no whitespace (as native)
            raise RespError("protocol error: bad array header")
        n = int(line[1:])
        if n > 1024 * 1024:
            raise RespError("protocol error: bad array length")
        items: list[bytes] = []
        for _ in range(n):
            header, pos2 = self._find_line(pos)
            if header is None:
                return None
            if header[0:1] != b"$":
                raise RespError("protocol error: expected bulk string")
            if not header[1:].isdigit():  # strict, matching the native scanner
                raise RespError("protocol error: bad bulk length")
            blen = int(header[1:])
            if blen > self._MAX_BULK:
                raise RespError("protocol error: bad bulk length")
            if len(self._buf) < pos2 + blen + 2:
                return None
            body = bytes(self._buf[pos2 : pos2 + blen])
            if self._buf[pos2 + blen : pos2 + blen + 2] != b"\r\n":
                raise RespError("protocol error: bulk not terminated")
            items.append(body)
            pos = pos2 + blen + 2
        del self._buf[:pos]
        return items
