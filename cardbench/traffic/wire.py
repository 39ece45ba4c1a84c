"""The cluster wire as a synthetic peer speaks it.

A frozen copy of the port's ``cluster/framing.py`` (the magic-and-length
frame) and of the oracle half of ``cluster/codec.py`` at schema v11: the
schema text whose sha256 is the handshake signature, LEB128 varints, the
transport frame's CRC and origin stamp, the dialer's hello and the
passive side's echo, the address set of ``MsgExchangeAddrs`` and the
pieces of a ``MsgPushDeltas`` body, from which each data type's module
(types/<type>.py) builds its own (``push``). A later change to the
program cannot move what the peers send. Imports nothing of the program.

The bodies are vectorised: every entry of a frame has one fixed width
(fixed-length keys, values and varints, ``leb128_fixed``), so a
2,048-key frame is a handful of numpy column writes.
"""

from __future__ import annotations

import hashlib
import struct
import zlib

import numpy as np

MAGIC = 0x06
HEADER_SIZE = 9
CRC_LEN = 4
ORIGIN_LEN = 8

TAG_PONG = 0
TAG_EXCHANGE = 1
TAG_ANNOUNCE = 2
TAG_PUSH = 3
TAG_SYNC_REQ = 4
TAG_SYNC_DONE = 5
TAG_DELTA_ACK = 6
TAG_SEQ_PUSH = 7
TAG_RELAY_PUSH = 11

# cluster/codec.py _SCHEMA_TEXT at SCHEMA_VERSION 11, verbatim
SCHEMA_TEXT = """jylis-tpu cluster schema v11
varint=LEB128 bytes=varint-len-prefixed str=utf8-bytes
wire=frame(crc32(origin_ms:u64be body):u32be origin_ms:u64be body)
handshake=wire(sig:32B hello:(dialer-addr:addr region:str epoch:varint)?) echo=wire(sig:32B region:str epoch:varint)
addr=(host:str port:str name:str)
p2set=(adds:[addr] removes:[addr])
svec=[(rid:str seq:varint)]
msg0=Pong
msg1=ExchangeAddrs(p2set)
msg2=AnnounceAddrs(p2set)
msg3=PushDeltas(name:str batch:[(key:bytes delta)])
msg4=SyncRequest(digests:[bytes] order=TREG,TLOG,GCOUNT,PNCOUNT,UJSON,TENSOR,MAP,BCOUNT svec)
msg5=SyncDone(svec match-only)
msg6=DeltaAck(cum:varint)
msg7=SeqPush(seq:varint oseq:varint span:bytes name:str batch:[(key:bytes delta)])
msg8=DigestTree(name:str leaves:[(bucket:varint digest:bytes)] fanout=256 bucket=sha256(key)[0])
msg9=RangeRequest(name:str buckets:[varint])
msg10=IntervalReset(seq:varint)
msg11=RelayPush(seq:varint origin:str oseq:varint span:bytes name:str batch:[(key:bytes delta)])
msg12=RegionGossip(regions:[(addr:str region:str epoch:varint)])
delta/TREG=(value:bytes ts:varint)
delta/TLOG=delta/SYSTEM=(entries:[(value:bytes ts:varint)] cutoff:varint)
delta/GCOUNT=[(rid:varint v:varint)]
delta/PNCOUNT=(gcount gcount)
delta/UJSON=(entries:[(rid seq path:[str] token:str)] vv:[(rid seq)] cloud:[(rid seq)])
delta/TENSOR=(mode:varint dim:varint val:bytes ts:bytes rid:bytes contribs:[(rid:varint ts:varint vec:bytes)])
delta/MAP=(itype:str ver:[(rid:varint seq:varint)] tomb:[(rid:varint seq:varint)] val:delta/itype) key=(klen:varint key field) itype in TREG,TLOG,GCOUNT,PNCOUNT
delta/BCOUNT=(grants:[(rid:varint v:varint)] incs:[(rid:varint v:varint)] decs:[(rid:varint v:varint)] xi:[(from:varint to:varint v:varint)] xd:[(from:varint to:varint v:varint)])
"""

SIGNATURE = hashlib.sha256(SCHEMA_TEXT.encode()).digest()


class WireError(Exception):
    """Bytes the peer cannot read: a bad magic byte, a CRC mismatch, a
    truncated varint."""


# ---- LEB128 -------------------------------------------------------------------


def varint(v: int) -> bytes:
    if v < 0:
        raise WireError(f"negative varint: {v}")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def varint_len(v: int) -> int:
    return len(varint(v))


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    """(value, next position)."""
    shift = v = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
        if shift > 70:
            raise WireError("varint too long")


def leb128_fixed(values: np.ndarray, width: int) -> np.ndarray:
    """(n, width) uint8: the LEB128 bytes of u64 ``values`` that all take
    exactly ``width`` bytes (their top 7-bit group sits in the last byte
    and is nonzero), so the encoding is the canonical one."""
    v = np.asarray(values, dtype=np.uint64)
    lo = np.uint64(1) << np.uint64(7 * (width - 1))
    if v.size and (v.min() < lo or (width < 10 and v.max() >= lo << np.uint64(7))):
        raise WireError(f"values outside the {width}-byte varint range")
    out = np.empty((v.size, width), np.uint8)
    for i in range(width):
        group = (v >> np.uint64(7 * i)) & np.uint64(0x7F)
        out[:, i] = group.astype(np.uint8) | (0x80 if i < width - 1 else 0)
    return out


def str_bytes(s: str | bytes) -> bytes:
    b = s.encode() if isinstance(s, str) else s
    return varint(len(b)) + b


# ---- frames -------------------------------------------------------------------


def wire_frame(body: bytes, origin_ms: int = 0) -> bytes:
    """One transport frame: magic + u64be length, then crc32 of (origin
    stamp + body), the stamp and the body. Origin 0 is "unstamped": the
    receiver records no lag for it."""
    stamped = struct.pack(">Q", origin_ms) + body
    payload = struct.pack(">I", zlib.crc32(stamped)) + stamped
    return struct.pack(">BQ", MAGIC, len(payload)) + payload


def check_frame(payload: bytes) -> bytes:
    """The message body of one received frame payload, CRC checked."""
    if len(payload) < CRC_LEN + ORIGIN_LEN:
        raise WireError("short frame")
    (crc,) = struct.unpack_from(">I", payload)
    if zlib.crc32(payload[CRC_LEN:]) != crc:
        raise WireError("frame CRC mismatch")
    return payload[CRC_LEN + ORIGIN_LEN:]


class FrameReader:
    """Incremental reassembly of frame payloads over a byte stream."""

    def __init__(self, max_frame: int = 1 << 30):
        self._buf = bytearray()
        self._need: int | None = None
        self._max = max_frame

    def append(self, data: bytes) -> None:
        self._buf.extend(data)

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._need is None:
            if len(self._buf) < HEADER_SIZE:
                raise StopIteration
            magic, need = struct.unpack_from(">BQ", self._buf)
            if magic != MAGIC:
                raise WireError(f"bad magic byte: {magic:#x}")
            if need > self._max:
                raise WireError(f"frame of {need} bytes exceeds limit")
            self._need = need
            del self._buf[:HEADER_SIZE]
        if len(self._buf) < self._need:
            raise StopIteration
        payload = bytes(self._buf[: self._need])
        del self._buf[: self._need]
        self._need = None
        return payload


# ---- handshake and control messages -------------------------------------------


def addr_bytes(host: str, port: int, name: str) -> bytes:
    return str_bytes(host) + str_bytes(str(port)) + str_bytes(name)


def hello(host: str, port: int, name: str, epoch: int, region: str = "") -> bytes:
    """The dialer's first frame body: signature + advertised address +
    region + boot epoch."""
    return SIGNATURE + addr_bytes(host, port, name) + str_bytes(region) + varint(epoch)


def echo(epoch: int, region: str = "") -> bytes:
    """The passive side's reply to a hello: signature + region + epoch."""
    return SIGNATURE + str_bytes(region) + varint(epoch)


def exchange_addrs(addrs: list[tuple[str, int, str]]) -> bytes:
    """``MsgExchangeAddrs`` with ``addrs`` added and nothing removed
    (the codec writes each group sorted by ``host:port:name``)."""
    adds = sorted(addrs, key=lambda a: f"{a[0]}:{a[1]}:{a[2]}")
    return (bytes([TAG_EXCHANGE]) + varint(len(adds))
            + b"".join(addr_bytes(*a) for a in adds) + varint(0))


def pong() -> bytes:
    return bytes([TAG_PONG])


def sync_done() -> bytes:
    """``MsgSyncDone`` with an empty session vector."""
    return bytes([TAG_SYNC_DONE]) + varint(0)


def delta_ack(cum: int) -> bytes:
    return bytes([TAG_DELTA_ACK]) + varint(cum)


def seq_of(body: bytes) -> int:
    """The transport sequence of a ``MsgSeqPush`` or ``MsgRelayPush``
    body: the varint right after its tag."""
    return read_varint(body, 1)[0]


# ---- MsgPushDeltas ------------------------------------------------------------


def push_header(name: str, n: int) -> bytes:
    return bytes([TAG_PUSH]) + str_bytes(name) + varint(n)


def key_column(key_bytes: np.ndarray) -> np.ndarray:
    """(n, 1 + L) uint8: each fixed-length key with its length prefix."""
    n, width = key_bytes.shape
    if width >= 0x80:
        raise WireError("keys of 128 bytes or more take a wider prefix")
    out = np.empty((n, 1 + width), np.uint8)
    out[:, 0] = width
    out[:, 1:] = key_bytes
    return out


def push(name: str, cols: list[np.ndarray]) -> bytes:
    """A ``MsgPushDeltas`` body of data type ``name``: the header, then
    each entry's columns side by side. A 2-D column holds one row an
    entry (a key with its prefix, ``key_column``; a fixed-width varint,
    ``leb128_fixed``); a 1-D one is the same bytes in every entry."""
    n = next(c.shape[0] for c in cols if c.ndim == 2)
    widths = [c.shape[-1] for c in cols]
    entries = np.empty((n, sum(widths)), np.uint8)
    at = 0
    for col, w in zip(cols, widths):
        entries[:, at : at + w] = col
        at += w
    return push_header(name, n) + entries.tobytes()
