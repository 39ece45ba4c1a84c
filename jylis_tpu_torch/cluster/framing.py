"""Cluster wire framing: magic byte + 64-bit big-endian length header.

Reference analog: framing.pony:1-28 — a 9-byte header (magic ``0x06``
followed by the body length as an 8-byte big-endian integer); parsing
validates the magic byte and rejects the frame otherwise. The reference
additionally guards for 64-bit platforms at compile time (framing.pony:3);
Python ints make that moot, but we keep the explicit u64 bound check.

The header is 9 fixed bytes built/parsed with ``struct``. The port's copy
of jylis_tpu/cluster/framing.py, whole.
"""

from __future__ import annotations

import struct

MAGIC = 0x06
HEADER_SIZE = 9
_U64_MAX = (1 << 64) - 1


class FramingError(Exception):
    """Bad magic or impossible length — treated like auth failure
    (framed_notify.pony:70-71: the connection is dropped)."""


def build_header(body_len: int) -> bytes:
    if not (0 <= body_len <= _U64_MAX):
        raise FramingError(f"body length out of u64 range: {body_len}")
    return struct.pack(">BQ", MAGIC, body_len)


def parse_header(header: bytes) -> int:
    """Returns the body length; raises FramingError on a tampered magic
    byte (framing.pony:20) or short header."""
    if len(header) != HEADER_SIZE:
        raise FramingError(f"header must be {HEADER_SIZE} bytes, got {len(header)}")
    magic, length = struct.unpack(">BQ", header)
    if magic != MAGIC:
        raise FramingError(f"bad magic byte: {magic:#x}")
    return length


def frame(body: bytes) -> bytes:
    """Wrap a message body for the wire (framed_notify.pony:50-54)."""
    return build_header(len(body)) + body


class FrameReader:
    """Incremental frame reassembly over a byte stream.

    The reference alternates ``conn.expect(header)`` / ``expect(body)``
    (framed_notify.pony:42-48,64-77); asyncio gives us a buffer instead, so
    this class carries the same state machine over an internal buffer.
    Frames larger than ``max_frame`` raise, bounding memory under a
    malicious or corrupt peer.
    """

    def __init__(self, max_frame: int = 1 << 30):
        self._buf = bytearray()
        self._need: int | None = None  # body length once header parsed
        self._max = max_frame

    def append(self, data: bytes) -> None:
        self._buf.extend(data)

    def set_max_frame(self, max_frame: int) -> None:
        """Raise/lower the frame cap (used to widen after a handshake)."""
        self._max = max_frame

    def pending(self) -> int:
        """Bytes buffered but not yet yielded as a complete frame (useful
        for end-of-stream truncation checks)."""
        return len(self._buf) + (0 if self._need is None else HEADER_SIZE)

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._need is None:
            if len(self._buf) < HEADER_SIZE:
                raise StopIteration
            self._need = parse_header(bytes(self._buf[:HEADER_SIZE]))
            if self._need > self._max:
                raise FramingError(f"frame of {self._need} bytes exceeds limit")
            del self._buf[:HEADER_SIZE]
        if len(self._buf) < self._need:
            raise StopIteration
        body = bytes(self._buf[: self._need])
        del self._buf[: self._need]
        self._need = None
        return body
