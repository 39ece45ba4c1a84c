"""LEB128 wire primitives: the port's copy of jylis_tpu/utils/wire.py.

Shared by the delta codec (cluster/codec.py) and the TENSOR host
lattice (ops/tensor_host.py), kept here so ops/ can raise wire errors
without importing cluster/ (which imports ops/)."""

from __future__ import annotations


class WireError(Exception):
    """Malformed wire bytes. cluster/codec.py re-exports this as
    CodecError."""


class Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def varint(self) -> int:
        shift = 0
        v = 0
        while True:
            if self.pos >= len(self.buf):
                raise WireError("truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 70:
                raise WireError("varint too long")

    def bytes_(self) -> bytes:
        n = self.varint()
        if self.pos + n > len(self.buf):
            raise WireError("truncated bytes")
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def str_(self) -> str:
        b = self.bytes_()
        try:
            return b.decode()
        except UnicodeDecodeError as e:
            # malformed peer bytes must surface as WireError (the cluster
            # drops the connection on it), never a raw UnicodeDecodeError
            raise WireError(f"invalid utf-8 string: {e}") from e

    def done(self) -> bool:
        return self.pos == len(self.buf)
