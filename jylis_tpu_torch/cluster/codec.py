"""The per-type delta codec, for the types this port serves so far.

The port's copy of the delta half of jylis_tpu/cluster/codec.py, trimmed
to ``delta/TENSOR``: the bytes TENSOR MRG takes as its payload
(models/repo_tensor.py). The encoding is the JAX codec's, byte for byte:
LEB128 varints for integers, varint-length-prefixed byte strings, and
the uniform unit

    delta/TENSOR=(mode:varint dim:varint val:bytes ts:bytes rid:bytes
                  contribs:[(rid:varint ts:varint vec:bytes)])

with the contributions in ascending rid order. Messages, membership and
the other types' deltas come with the cluster.
"""

from __future__ import annotations

from ..ops.tensor_host import Tensor
from ..utils.wire import Reader, WireError

# a WireError IS this module's CodecError, as in the JAX codec
CodecError = WireError


def _w_varint(out: bytearray, v: int) -> None:
    if v < 0:
        raise CodecError(f"negative varint: {v}")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _w_bytes(out: bytearray, b: bytes) -> None:
    _w_varint(out, len(b))
    out.extend(b)


def _w_tensor(out: bytearray, t: Tensor) -> None:
    _w_varint(out, t.mode)
    _w_varint(out, t.dim)
    _w_bytes(out, t.val)
    _w_bytes(out, t.ts)
    _w_bytes(out, t.rid)
    _w_varint(out, len(t.contribs))
    for rid in sorted(t.contribs):
        cts, vec = t.contribs[rid]
        _w_varint(out, rid)
        _w_varint(out, cts)
        _w_bytes(out, vec)


def _r_tensor(r: Reader) -> Tensor:
    mode = r.varint()
    dim = r.varint()
    val = r.bytes_()
    ts = r.bytes_()
    rid = r.bytes_()
    n = r.varint()
    contribs: dict[int, tuple[int, bytes]] = {}
    for _ in range(n):
        crid = r.varint()
        cts = r.varint()
        contribs[crid] = (cts, r.bytes_())
    if len(contribs) != n:
        # a repeated rid would silently last-entry-win past the per-rid
        # join: the canonical encoding never produces one
        raise CodecError("duplicate tensor contribution rid")
    # shape validation happens in from_wire; a WireError IS a CodecError
    return Tensor.from_wire(mode, dim, val, ts, rid, contribs)


def _check_name(name: str) -> None:
    if name != "TENSOR":
        raise CodecError(f"unknown data type: {name}")


def encode_delta(name: str, delta) -> bytes:
    """One bare per-type delta payload (no message framing)."""
    _check_name(name)
    out = bytearray()
    _w_tensor(out, delta)
    return bytes(out)


def decode_delta(name: str, blob: bytes):
    """Inverse of encode_delta; raises CodecError on trailing bytes."""
    _check_name(name)
    r = Reader(blob)
    delta = _r_tensor(r)
    if not r.done():
        raise CodecError("trailing bytes after delta")
    return delta
