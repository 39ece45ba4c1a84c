"""Versioned binary codec for cluster messages + schema signature.

The port's copy of jylis_tpu/cluster/codec.py: the same schema text,
signatures and bytes for every message and every delta type, so a port
node and a JAX node interoperate byte for byte. The handshake exchanges
``signature()`` as the first frame; a byte mismatch drops the
connection. ``legacy_snapshot_signatures`` and ``legacy_delta_signatures``
name the older headers a snapshot or a journal segment may carry.

``encode`` / ``decode`` take the native C++ codec (native/codec.py) for
``MsgPushDeltas``, ``MsgSeqPush`` and ``MsgRelayPush`` (the last two are
a PushDeltas body behind a sequence prefix), as the JAX package's do;
every other message, and any one message outside the native path's
domain, takes the pure-Python oracle below. ``native=False`` takes the
oracle for every message (tests and scripts/cluster_heal.py compare
the two). ``encode.native`` / ``encode.oracle`` and ``decode.native`` /
``decode.oracle`` count the messages each path coded, per message kind
(``"PushDeltas"``, ``"SeqPush"``, ...), as the kernel wrappers count
``.launches``.

Encoding: LEB128 varints for all integers, varint-length-prefixed byte
strings, and a one-byte tag per message / per delta kind. Delta payloads
are encoded per data type (the wire shapes documented in each repo module):

    TREG           (value: bytes, ts: u64)
    TLOG / SYSTEM  ([(value: bytes, ts: u64)...], cutoff: u64)
    GCOUNT         {replica-id: u64}
    PNCOUNT        ({rid: u64}, {rid: u64})
    UJSON          dot-store entries + causal context (ops/ujson_host.py)
    TENSOR         uniform 4-plane unit + AVG contribs (ops/tensor_host.py)
    MAP            one FIELD unit (itype, ver, tomb, inner delta) under a
                   packed (key, field) wire key — recursive (ops/compose.py)
    BCOUNT         full escrow view (grants, incs, decs, xi, xd)
                   (ops/bcount.py)

Every integer is a Python int in [0, 2^64): the repos turn their int64
bit patterns back into u64 values before they flush or dump.
"""

from __future__ import annotations

import hashlib
import threading

from ..ops import compose
from ..ops.p2set import P2Set
from ..ops.tensor_host import Tensor
from ..ops.ujson_host import UJSON
from ..ops.ujson_wire import read_ujson
from ..utils.address import Address
from ..utils.wire import Reader as _Reader
from ..utils.wire import WireError
from .msg import (
    Msg,
    MsgAnnounceAddrs,
    MsgDeltaAck,
    MsgDigestTree,
    MsgExchangeAddrs,
    MsgIntervalReset,
    MsgPong,
    MsgPushDeltas,
    MsgRangeRequest,
    MsgRegionGossip,
    MsgRelayPush,
    MsgSeqPush,
    MsgSyncDone,
    MsgSyncRequest,
)

SCHEMA_VERSION = 11

# The canonical schema text: any change to the wire format MUST change this
# string (bump SCHEMA_VERSION), which changes the signature, which makes
# incompatible peers refuse each other at handshake instead of corrupting.
# v5: (a) every transport frame body is prefixed with its CRC32 —
# without it a single bit flip past the TCP checksum can decode as a
# valid message and converge as forged lattice state (found by the
# drill matrix); (b) the dialer's handshake frame carries its
# advertised address after the 32-byte signature (the passive side uses
# it to identify the peer for teardown logs and to reset its dial
# backoff on inbound contact); the passive echo remains the bare
# signature.
# v6: every transport frame carries its sender's wall-clock origin
# (milliseconds, u64be, CRC-covered) between the CRC and the body —
# mirroring the v5 handshake-address precedent of enriching the
# TRANSPORT layer rather than the message encodings, so snapshots and
# journals (which store bare message payloads versioned by
# delta_signature) remain loadable across the bump. Receivers fold the
# stamp into per-peer convergence-lag gauges (push→apply staleness, the
# quantity a delta-CRDT store exists to bound) and heartbeat round-trip
# histograms; origin 0 means "unstamped" and records nothing. Sync
# replies get their own message (msg5 SyncDone) so a Pong always
# answers a round-trip-stamped send and the rtt histogram's FIFO
# matching stays exact — a sync reply's timing includes digest
# computation or a whole dump stream, which is not a round trip.
# v7: the TENSOR data type (ops/tensor_host.py — fixed-dim f32 vectors
# with per-coordinate MAX / LWW / timestamp-weighted-AVG joins). One
# uniform delta shape for all three merge modes: every plane ships
# every time (empty bytes for the planes a mode does not use), so the
# encoder/decoder bodies stay branch-free for pass 7's symmetry
# extractor. `vec` payloads are packed little-endian f32 with NaNs
# canonicalised at ingest. This is the FIRST delta-line change since
# v1, so delta_signature() changes for the first time: v1-v6 snapshots
# and journals (which stamp the delta signature) stay loadable via the
# legacy acceptance below — they contain only old-type frames, all
# still decodable.
# v8: the anti-entropy rewrite — five new TRANSPORT messages, zero
# delta-line changes (so delta_signature() is UNCHANGED from v7 and
# every v7 snapshot/journal stays first-class loadable; v1-v6 remain
# covered by the legacy acceptance). msg6/msg7 are the delta-interval
# half (per-sender monotone batch seqs, cumulative contiguous acks,
# retransmit-only-unacked — arXiv:1410.2803); msg8/msg9 are the
# Merkle-range half (a 256-leaf keyspace digest tree over
# sha256(key)[0], range pulls of divergent buckets only —
# arXiv:1605.06424); msg10 is the graceful-degradation rung between
# them (a sender whose retransmit window evicted a receiver's gap
# re-baselines that receiver and demotes it to range repair — never a
# silent whole-state dump). msg7's name+batch encoding is byte-
# identical to msg3 after the tag+seq prefix, so the native codec fast
# path serves both.
# v9: the composed types (ROADMAP item 4). Two new delta lines, the
# SECOND delta-line change ever (so delta_signature() changes and the
# v7/v8 delta digest joins the legacy acceptance — those files' frames
# all still decode; v1-v6 remain covered by the older legacy entry).
# delta/MAP is the first RECURSIVE unit: one FIELD of one map key —
# the wire key is the packed (key, field) composite (klen:varint key
# field), the unit is the field's product-lattice state (inner type
# tag, per-replica edit counters, removal tombstone), and `val` is the
# inner type's OWN delta encoding, one level deep (itype must be a
# registered inner lattice: TREG, TLOG, GCOUNT, PNCOUNT — never MAP).
# Decomposition means one field edit ships one unit, never the map,
# and the digest tree / range-repair ladder operates per field.
# delta/BCOUNT is the escrow counter's FULL per-key view (five
# join-monotone components — grants/incs/decs and the two transfer
# matrices); shipping the whole view keeps every state self-justifying
# under join, which is what makes `0 <= value <= bound` hold on every
# replica in every delivery schedule (ops/bcount.py). msg4's digest
# order gains MAP,BCOUNT at the tail (positional vector, transport
# level).
# v10: sessions & regions — transport-only (delta lines unchanged, so
# delta_signature() is UNCHANGED from v9: every existing snapshot and
# journal loads as-is). The dialer's handshake suffix becomes a hello
# (advertised address + region name + boot epoch) and the passive echo
# answers with its own region + epoch: the epoch is what keys session
# vectors per incarnation (a rebooted sender's restarted seq counter
# must never alias its previous stream), the region is what the
# region-aware peering policy classifies conns by. msg4/msg5 gain the
# session vector (svec) for digest-match adoption — byte-equal state is
# the proof that lets a whole vector fold across. msg7 gains the sender's own-content ordinal (oseq — the
# session counter, gapless per origin because relay frames never
# consume it; transport acks stay on seq). msg11 is the
# origin-preserving relay (transport-sequenced like msg7, its name+batch
# bytes msg3's after the prefix, with the ORIGIN incarnation's rid+seq
# carried verbatim hop to hop — how a session token minted in one
# region or lane verifies in another). msg12 gossips {addr -> region}
# on the announce cadence so dial policy can classify addresses it
# never met.
# v11: provenance spans — transport-only like v8/v10 (delta lines
# unchanged, so delta_signature() is UNCHANGED from v9 and every
# snapshot/journal loads as-is). msg7 and msg11 gain ``span``, a
# length-prefixed opaque trace chain (obs/jtrace.py wire format:
# tag/len-framed hop stamps, appended per hop) minted for 1-in-N
# sequenced flushes (--trace-sample) and empty otherwise — the
# unsampled cost is ONE length byte. The span sits in the prefix
# (after oseq, before name) so msg7/msg11's name+batch bytes remain
# msg3's after the prefix and the native codec fast path keeps serving
# both; receivers fold arrived chains into per-hop and per-region-pair
# convergence histograms and the converge_slo gauges. Retransmits
# replay the originally wired bytes, original stamps included.
_SCHEMA_TEXT = f"""jylis-tpu cluster schema v{SCHEMA_VERSION}
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


def signature() -> bytes:
    """The handshake digest (the reference's _Serialise.signature analog,
    _serialise.pony:7) — here a schema identity, not a binary identity."""
    return hashlib.sha256(_SCHEMA_TEXT.encode()).digest()


def delta_signature() -> bytes:
    """Identity of the PER-TYPE DELTA encodings only (the lines of the
    schema snapshots actually contain). Snapshots are versioned by THIS,
    not the full transport signature: a transport-message change (like
    the v3 sync-request digest) must not invalidate every snapshot on
    disk when the delta bytes it stores are unchanged."""
    delta_lines = [
        line
        for line in _SCHEMA_TEXT.splitlines()
        if line.startswith("delta/") or line.startswith("varint=")
    ]
    return hashlib.sha256("\n".join(delta_lines).encode()).digest()


# the exact schema texts earlier releases stamped into snapshot headers
# via the FULL signature() — their delta lines are byte-identical to
# v3's, so those files remain loadable; kept verbatim (not derived from
# _SCHEMA_TEXT) so future schema edits cannot silently change what a
# legacy header means
_LEGACY_V1_TEXT = """jylis-tpu cluster schema v1
varint=LEB128 bytes=varint-len-prefixed str=utf8-bytes
addr=(host:str port:str name:str)
p2set=(adds:[addr] removes:[addr])
msg0=Pong
msg1=ExchangeAddrs(p2set)
msg2=AnnounceAddrs(p2set)
msg3=PushDeltas(name:str batch:[(key:bytes delta)])
delta/TREG=(value:bytes ts:varint)
delta/TLOG=delta/SYSTEM=(entries:[(value:bytes ts:varint)] cutoff:varint)
delta/GCOUNT=[(rid:varint v:varint)]
delta/PNCOUNT=(gcount gcount)
delta/UJSON=(entries:[(rid seq path:[str] token:str)] vv:[(rid seq)] cloud:[(rid seq)])
"""

_LEGACY_V2_TEXT = """jylis-tpu cluster schema v2
varint=LEB128 bytes=varint-len-prefixed str=utf8-bytes
addr=(host:str port:str name:str)
p2set=(adds:[addr] removes:[addr])
msg0=Pong
msg1=ExchangeAddrs(p2set)
msg2=AnnounceAddrs(p2set)
msg3=PushDeltas(name:str batch:[(key:bytes delta)])
msg4=SyncRequest
delta/TREG=(value:bytes ts:varint)
delta/TLOG=delta/SYSTEM=(entries:[(value:bytes ts:varint)] cutoff:varint)
delta/GCOUNT=[(rid:varint v:varint)]
delta/PNCOUNT=(gcount gcount)
delta/UJSON=(entries:[(rid seq path:[str] token:str)] vv:[(rid seq)] cloud:[(rid seq)])
"""


# the early-v3 window ALSO stamped the full signature() (persist.py
# switched to delta_signature() later in that release cycle); the v3
# text is frozen verbatim like the others so a future schema v4 cannot
# silently change what this header means
_LEGACY_V3_TEXT = """jylis-tpu cluster schema v3
varint=LEB128 bytes=varint-len-prefixed str=utf8-bytes
addr=(host:str port:str name:str)
p2set=(adds:[addr] removes:[addr])
msg0=Pong
msg1=ExchangeAddrs(p2set)
msg2=AnnounceAddrs(p2set)
msg3=PushDeltas(name:str batch:[(key:bytes delta)])
msg4=SyncRequest(digest:bytes)
delta/TREG=(value:bytes ts:varint)
delta/TLOG=delta/SYSTEM=(entries:[(value:bytes ts:varint)] cutoff:varint)
delta/GCOUNT=[(rid:varint v:varint)]
delta/PNCOUNT=(gcount gcount)
delta/UJSON=(entries:[(rid seq path:[str] token:str)] vv:[(rid seq)] cloud:[(rid seq)])
"""


# v4 through v6 stamped delta_signature() into snapshot AND journal
# headers; their delta lines are byte-identical to v1's, so the ONE
# legacy delta digest below covers that whole window. Frozen verbatim
# (not derived from _SCHEMA_TEXT) like the full-signature texts above.
_LEGACY_V6_TEXT = """jylis-tpu cluster schema v6
varint=LEB128 bytes=varint-len-prefixed str=utf8-bytes
wire=frame(crc32(origin_ms:u64be body):u32be origin_ms:u64be body)
handshake=wire(sig:32B dialer-addr:addr?)
addr=(host:str port:str name:str)
p2set=(adds:[addr] removes:[addr])
msg0=Pong
msg1=ExchangeAddrs(p2set)
msg2=AnnounceAddrs(p2set)
msg3=PushDeltas(name:str batch:[(key:bytes delta)])
msg4=SyncRequest(digests:[bytes] order=TREG,TLOG,GCOUNT,PNCOUNT,UJSON)
msg5=SyncDone
delta/TREG=(value:bytes ts:varint)
delta/TLOG=delta/SYSTEM=(entries:[(value:bytes ts:varint)] cutoff:varint)
delta/GCOUNT=[(rid:varint v:varint)]
delta/PNCOUNT=(gcount gcount)
delta/UJSON=(entries:[(rid seq path:[str] token:str)] vv:[(rid seq)] cloud:[(rid seq)])
"""


# the v7/v8 window's schema (v8 touched only transport messages, so
# both releases stamped ONE delta digest: v1-v6's lines plus
# delta/TENSOR). Frozen verbatim like the other legacy texts so future
# schema edits cannot silently change what those on-disk headers mean.
_LEGACY_V8_TEXT = """jylis-tpu cluster schema v8
varint=LEB128 bytes=varint-len-prefixed str=utf8-bytes
wire=frame(crc32(origin_ms:u64be body):u32be origin_ms:u64be body)
handshake=wire(sig:32B dialer-addr:addr?)
addr=(host:str port:str name:str)
p2set=(adds:[addr] removes:[addr])
msg0=Pong
msg1=ExchangeAddrs(p2set)
msg2=AnnounceAddrs(p2set)
msg3=PushDeltas(name:str batch:[(key:bytes delta)])
msg4=SyncRequest(digests:[bytes] order=TREG,TLOG,GCOUNT,PNCOUNT,UJSON,TENSOR)
msg5=SyncDone
msg6=DeltaAck(cum:varint)
msg7=SeqPush(seq:varint name:str batch:[(key:bytes delta)])
msg8=DigestTree(name:str leaves:[(bucket:varint digest:bytes)] fanout=256 bucket=sha256(key)[0])
msg9=RangeRequest(name:str buckets:[varint])
msg10=IntervalReset(seq:varint)
delta/TREG=(value:bytes ts:varint)
delta/TLOG=delta/SYSTEM=(entries:[(value:bytes ts:varint)] cutoff:varint)
delta/GCOUNT=[(rid:varint v:varint)]
delta/PNCOUNT=(gcount gcount)
delta/UJSON=(entries:[(rid seq path:[str] token:str)] vv:[(rid seq)] cloud:[(rid seq)])
delta/TENSOR=(mode:varint dim:varint val:bytes ts:bytes rid:bytes contribs:[(rid:varint ts:varint vec:bytes)])
"""


def legacy_delta_signatures() -> tuple[bytes, ...]:
    """DELTA-schema digests of older releases whose frames this build
    still decodes, stamped into v4+ snapshot and journal headers on
    disk. Two windows: the v1-v6 delta lines (unchanged across that
    whole span) hash to one digest, and the v7/v8 lines (v7 added
    delta/TENSOR; v8 changed only transport messages) hash to another.
    v9 added delta/MAP + delta/BCOUNT — pure extensions, so every
    legacy file's frames still decode: they contain only old-type
    units."""
    out = []
    for text in (_LEGACY_V6_TEXT, _LEGACY_V8_TEXT):
        delta_lines = [
            line
            for line in text.splitlines()
            if line.startswith("delta/") or line.startswith("varint=")
        ]
        out.append(hashlib.sha256("\n".join(delta_lines).encode()).digest())
    return tuple(out)


def legacy_snapshot_signatures() -> tuple[bytes, ...]:
    """Snapshot headers older releases wrote that THIS build still reads:
    every frame they version is still decodable (persist.py accepts
    these alongside delta_signature(), so upgrading a single-node
    deployment never strands its only data copy). The early releases
    stamped the FULL schema signature; v4+ stamped the delta signature
    (now also legacy after the v7 delta/TENSOR addition)."""
    return (
        hashlib.sha256(_LEGACY_V1_TEXT.encode()).digest(),
        hashlib.sha256(_LEGACY_V2_TEXT.encode()).digest(),
        hashlib.sha256(_LEGACY_V3_TEXT.encode()).digest(),
    ) + legacy_delta_signatures()


# the reader primitives live in utils/wire.py (shared with the lazy wire
# objects in ops/ujson_wire.py); a WireError IS this module's CodecError
CodecError = WireError


def batch_has_content(name: str, batch) -> bool:
    """True when a flushed delta batch carries joinable content. Empty
    batches and the SYSTEM keepalive quirk (deltas_size()==1 even when
    the delta log is empty) ship nothing a receiver — or the delta
    journal — can use. The SYSTEM batch-shape knowledge lives here with
    the rest of the per-type delta shapes; the cluster held-delta filter
    and journal/journal.py both delegate to this one predicate."""
    if not batch:
        return False
    if name == "SYSTEM":
        return any(entries or cutoff for _, (entries, cutoff) in batch)
    return True


# ---- primitive writers ----------------------------------------------------


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


def _w_str(out: bytearray, s: str) -> None:
    _w_bytes(out, s.encode())


# ---- address / membership set ---------------------------------------------


def _w_addr(out: bytearray, a: Address) -> None:
    _w_str(out, a.host)
    _w_str(out, a.port)
    _w_str(out, a.name)


def _r_addr(r: _Reader) -> Address:
    return Address(r.str_(), r.str_(), r.str_())


def encode_hello(a: Address, region: str, epoch: int) -> bytes:
    """The dialer's v10 handshake suffix: advertised address + region
    name + boot epoch (the session-rid incarnation stamp)."""
    out = bytearray()
    _w_addr(out, a)
    _w_str(out, region)
    _w_varint(out, epoch)
    return bytes(out)


def decode_hello(data: bytes) -> tuple[Address, str, int]:
    r = _Reader(data)
    a = _r_addr(r)
    region = r.str_()
    epoch = r.varint()
    if epoch > _U64_MAX:
        raise CodecError("hello epoch exceeds u64")
    if not r.done():
        raise CodecError("trailing bytes after hello")
    return a, region, epoch


def encode_echo(region: str, epoch: int) -> bytes:
    """The passive side's v10 handshake echo suffix."""
    out = bytearray()
    _w_str(out, region)
    _w_varint(out, epoch)
    return bytes(out)


def decode_echo(data: bytes) -> tuple[str, int]:
    r = _Reader(data)
    region = r.str_()
    epoch = r.varint()
    if epoch > _U64_MAX:
        raise CodecError("echo epoch exceeds u64")
    if not r.done():
        raise CodecError("trailing bytes after echo")
    return region, epoch


def _w_svec(out: bytearray, entries: tuple) -> None:
    # session vector: pre-sorted (rid, seq) pairs (sessions.py)
    _w_varint(out, len(entries))
    for rid, seq in entries:
        _w_str(out, rid)
        _w_varint(out, seq)


def _r_svec(r: _Reader) -> tuple:
    # accumulator deliberately NOT named `out`: pass 7's symbolic
    # evaluator reads `out.append` as the byte-writer primitive
    entries = []
    for _ in range(r.varint()):
        rid = r.str_()
        seq = r.varint()
        if seq > _U64_MAX:
            raise CodecError("svec seq exceeds u64")
        entries.append((rid, seq))
    return tuple(entries)


def _w_p2set(out: bytearray, s: P2Set) -> None:
    for group in (s.adds, s.removes):
        addrs = sorted(group, key=str)
        _w_varint(out, len(addrs))
        for a in addrs:
            _w_addr(out, a)


def _r_p2set(r: _Reader) -> P2Set:
    s = P2Set()
    s.adds = {_r_addr(r) for _ in range(r.varint())}
    s.removes = {_r_addr(r) for _ in range(r.varint())}
    return s


# ---- per-type delta payloads ----------------------------------------------


def _w_gcount_dict(out: bytearray, d: dict) -> None:
    _w_varint(out, len(d))
    for rid in sorted(d):
        _w_varint(out, rid)
        _w_varint(out, d[rid])


def _r_gcount_dict(r: _Reader) -> dict:
    return {r.varint(): r.varint() for _ in range(r.varint())}


def _w_tlog(out: bytearray, delta: tuple) -> None:
    entries, cutoff = delta
    _w_varint(out, len(entries))
    for value, ts in entries:
        _w_bytes(out, value)
        _w_varint(out, ts)
    _w_varint(out, cutoff)


def _r_tlog(r: _Reader) -> tuple:
    entries = [(r.bytes_(), r.varint()) for _ in range(r.varint())]
    return entries, r.varint()


def _w_ujson(out: bytearray, u: UJSON) -> None:
    _w_varint(out, len(u.entries))
    for (rid, seq) in sorted(u.entries):
        path, token = u.entries[(rid, seq)]
        _w_varint(out, rid)
        _w_varint(out, seq)
        _w_varint(out, len(path))
        for part in path:
            _w_str(out, part)
        _w_str(out, token)
    vv = u.ctx.vv
    _w_varint(out, len(vv))
    for rid in sorted(vv):
        _w_varint(out, rid)
        _w_varint(out, vv[rid])
    cloud = sorted(u.ctx.cloud)
    _w_varint(out, len(cloud))
    for rid, seq in cloud:
        _w_varint(out, rid)
        _w_varint(out, seq)


def _r_ujson(r: _Reader) -> UJSON:
    return read_ujson(r)  # single implementation: ops/ujson_wire.py


def _w_tensor(out: bytearray, t: Tensor) -> None:
    # uniform shape for all three merge modes (branch-free unit: pass 7)
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


def _r_tensor(r: _Reader) -> Tensor:
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
        # join — the canonical encoding never produces one
        raise CodecError("duplicate tensor contribution rid")
    # shape validation happens in from_wire; a WireError IS a CodecError
    return Tensor.from_wire(mode, dim, val, ts, rid, contribs)


def _w_map(out: bytearray, unit: tuple) -> None:
    # one FIELD's product-lattice unit (the v9 recursive shape): inner
    # type tag, edit counters, tombstone, then the inner type's OWN
    # delta encoding — branch-free (val is always present; the inner
    # bottom is the join identity, so a tombstone-only unit ships it)
    itype, ver, tomb, val = unit
    if itype not in compose.REGISTRY:
        raise CodecError(f"unregistered MAP value type: {itype}")
    _w_str(out, itype)
    _w_gcount_dict(out, ver)
    _w_gcount_dict(out, tomb)
    _w_delta(out, itype, val)


_U64_MAX = (1 << 64) - 1


def _r_u64_dict(r: _Reader) -> dict:
    """A {rid: amount} span with BOTH sides bounded to u64: LEB128
    admits ~2^70, and an oversized escrow amount or edit seq would be
    journaled, then poison every arithmetic consumer on replay (the
    TENSOR AVG-ts lesson)."""
    d = _r_gcount_dict(r)
    for rid, v in d.items():
        if rid > _U64_MAX or v > _U64_MAX:
            raise CodecError("rid or amount exceeds u64")
    return d


def _r_map(r: _Reader) -> tuple:
    itype = r.str_()
    if itype not in compose.REGISTRY:
        raise CodecError(f"unregistered MAP value type: {itype}")
    ver = _r_u64_dict(r)
    tomb = _r_u64_dict(r)
    val = _r_delta(r, itype)
    return (itype, ver, tomb, val)


def _w_xfer(out: bytearray, m: dict) -> None:
    # a transfer matrix {(from, to): amount} as sorted triples
    _w_varint(out, len(m))
    for (f, t) in sorted(m):
        _w_varint(out, f)
        _w_varint(out, t)
        _w_varint(out, m[(f, t)])


def _r_xfer(r: _Reader) -> dict:
    out: dict[tuple[int, int], int] = {}
    for _ in range(r.varint()):
        f = r.varint()
        t = r.varint()
        v = r.varint()
        if f > _U64_MAX or t > _U64_MAX or v > _U64_MAX:
            raise CodecError("rid or amount exceeds u64")
        out[(f, t)] = v
    return out


def _w_bcount(out: bytearray, wire: tuple) -> None:
    # the FULL per-key view, five join-monotone components (the
    # self-justifying-state rule: funding evidence never lags a spend)
    grants, incs, decs, xi, xd = wire
    _w_gcount_dict(out, grants)
    _w_gcount_dict(out, incs)
    _w_gcount_dict(out, decs)
    _w_xfer(out, xi)
    _w_xfer(out, xd)


def _r_bcount(r: _Reader) -> tuple:
    grants = _r_u64_dict(r)
    incs = _r_u64_dict(r)
    decs = _r_u64_dict(r)
    xi = _r_xfer(r)
    xd = _r_xfer(r)
    return (grants, incs, decs, xi, xd)


def _w_delta(out: bytearray, name: str, delta) -> None:
    if name == "TREG":
        value, ts = delta
        _w_bytes(out, value)
        _w_varint(out, ts)
    elif name in ("TLOG", "SYSTEM"):
        _w_tlog(out, delta)
    elif name == "GCOUNT":
        _w_gcount_dict(out, delta)
    elif name == "PNCOUNT":
        dp, dn = delta
        _w_gcount_dict(out, dp)
        _w_gcount_dict(out, dn)
    elif name == "UJSON":
        _w_ujson(out, delta)
    elif name == "TENSOR":
        _w_tensor(out, delta)
    elif name == "MAP":
        _w_map(out, delta)
    elif name == "BCOUNT":
        _w_bcount(out, delta)
    else:
        raise CodecError(f"unknown data type: {name}")


def _r_delta(r: _Reader, name: str):
    if name == "TREG":
        return r.bytes_(), r.varint()
    if name in ("TLOG", "SYSTEM"):
        return _r_tlog(r)
    if name == "GCOUNT":
        return _r_gcount_dict(r)
    if name == "PNCOUNT":
        return _r_gcount_dict(r), _r_gcount_dict(r)
    if name == "UJSON":
        return _r_ujson(r)
    if name == "TENSOR":
        return _r_tensor(r)
    if name == "MAP":
        return _r_map(r)
    if name == "BCOUNT":
        return _r_bcount(r)
    raise CodecError(f"unknown data type: {name}")


def encode_delta(name: str, delta) -> bytes:
    """One bare per-type delta payload (no message framing): what
    TENSOR MRG accepts as its binary bulk payload, and what tests use
    to pin delta bytes without a whole PushDeltas."""
    out = bytearray()
    _w_delta(out, name, delta)
    return bytes(out)


def decode_delta(name: str, blob: bytes):
    """Inverse of encode_delta; raises CodecError on trailing bytes."""
    r = _Reader(blob)
    delta = _r_delta(r, name)
    if not r.done():
        raise CodecError("trailing bytes after delta")
    return delta


# ---- messages --------------------------------------------------------------

_TAG_PONG = 0
_TAG_EXCHANGE = 1
_TAG_ANNOUNCE = 2
_TAG_PUSH = 3
_TAG_SYNC_REQ = 4
_TAG_SYNC_DONE = 5
_TAG_DELTA_ACK = 6
_TAG_SEQ_PUSH = 7
_TAG_DIGEST_TREE = 8
_TAG_RANGE_REQ = 9
_TAG_INTERVAL_RESET = 10
_TAG_RELAY_PUSH = 11
_TAG_REGION_GOSSIP = 12


_count_lock = threading.Lock()  # the cluster also encodes in worker threads


def _count(counts: dict, msg: Msg) -> None:
    kind = type(msg).__name__[3:]  # "MsgSeqPush" -> "SeqPush"
    with _count_lock:
        counts[kind] = counts.get(kind, 0) + 1


def encode(msg: Msg, native: bool = True) -> bytes:
    """A message's bytes: the native codec's for a push (PushDeltas, or
    its seq/relay-prefixed forms) it can pack, else the oracle's."""
    if native and isinstance(msg, (MsgPushDeltas, MsgSeqPush, MsgRelayPush)):
        from ..native import codec as ncodec

        push = msg if isinstance(msg, MsgPushDeltas) else MsgPushDeltas(msg.name, msg.batch)
        fast = ncodec.encode_push(push)
        if fast is not None:
            _count(encode.native, msg)
            if isinstance(msg, MsgPushDeltas):
                return fast
            # msg7's and msg11's name+batch bytes are msg3's after their
            # prefixes (the schema text), so the push packer serves them
            out = bytearray((_TAG_SEQ_PUSH if isinstance(msg, MsgSeqPush) else _TAG_RELAY_PUSH,))
            _w_varint(out, msg.seq)
            if isinstance(msg, MsgRelayPush):
                _w_str(out, msg.origin)
            _w_varint(out, msg.oseq)
            _w_bytes(out, msg.span)
            out += fast[1:]
            return bytes(out)
    _count(encode.oracle, msg)
    return _encode_oracle(msg)


encode.native = {}
encode.oracle = {}


def decode(body: bytes, native: bool = True) -> Msg:
    """A message from its bytes: pushes through the native codec when
    their body lies in its domain, everything else through the oracle."""
    tag = body[0] if body else None
    if not native or tag not in (_TAG_PUSH, _TAG_SEQ_PUSH, _TAG_RELAY_PUSH):
        msg = _decode_oracle(body)
        _count(decode.oracle, msg)
        return msg
    from ..native import codec as ncodec

    if tag == _TAG_PUSH:
        rest, r = body, None
    else:
        # strip the seq prefix and decode the remainder as msg3 (native
        # or oracle: byte-identical by schema), then re-tag
        r = _Reader(body)
        r.pos = 1
        seq = r.varint()
        origin = r.str_() if tag == _TAG_RELAY_PUSH else None
        oseq = r.varint()
        if seq > _U64_MAX or oseq > _U64_MAX:
            raise CodecError("seq exceeds u64" if origin is None else "relay seq exceeds u64")
        span = r.bytes_()
        rest = bytes((_TAG_PUSH,)) + body[r.pos :]
    inner = ncodec.decode_push(rest)
    path = decode.native
    if inner is None:
        inner = _decode_oracle(rest)
        path = decode.oracle
    if r is None:
        msg = inner
    elif origin is None:
        msg = MsgSeqPush(seq, oseq, inner.name, inner.batch, span)
    else:
        msg = MsgRelayPush(seq, origin, oseq, inner.name, inner.batch, span)
    _count(path, msg)
    return msg


decode.native = {}
decode.oracle = {}


def _encode_oracle(msg: Msg) -> bytes:
    out = bytearray()
    if isinstance(msg, MsgPong):
        out.append(_TAG_PONG)
    elif isinstance(msg, MsgSyncDone):
        out.append(_TAG_SYNC_DONE)
        _w_svec(out, msg.svec)
    elif isinstance(msg, MsgExchangeAddrs):
        out.append(_TAG_EXCHANGE)
        _w_p2set(out, msg.known_addrs)
    elif isinstance(msg, MsgAnnounceAddrs):
        out.append(_TAG_ANNOUNCE)
        _w_p2set(out, msg.known_addrs)
    elif isinstance(msg, MsgPushDeltas):
        out.append(_TAG_PUSH)
        _w_str(out, msg.name)
        _w_varint(out, len(msg.batch))
        for key, delta in msg.batch:
            _w_bytes(out, key)
            _w_delta(out, msg.name, delta)
    elif isinstance(msg, MsgSyncRequest):
        out.append(_TAG_SYNC_REQ)
        _w_varint(out, len(msg.digests))
        for d in msg.digests:
            _w_bytes(out, d)
        _w_svec(out, msg.svec)
    elif isinstance(msg, MsgDeltaAck):
        out.append(_TAG_DELTA_ACK)
        _w_varint(out, msg.cum)
    elif isinstance(msg, MsgSeqPush):
        out.append(_TAG_SEQ_PUSH)
        _w_varint(out, msg.seq)
        _w_varint(out, msg.oseq)
        _w_bytes(out, msg.span)
        _w_str(out, msg.name)
        _w_varint(out, len(msg.batch))
        for key, delta in msg.batch:
            _w_bytes(out, key)
            _w_delta(out, msg.name, delta)
    elif isinstance(msg, MsgDigestTree):
        out.append(_TAG_DIGEST_TREE)
        _w_str(out, msg.name)
        _w_varint(out, len(msg.leaves))
        for bucket, digest in msg.leaves:
            _w_varint(out, bucket)
            _w_bytes(out, digest)
    elif isinstance(msg, MsgRangeRequest):
        out.append(_TAG_RANGE_REQ)
        _w_str(out, msg.name)
        _w_varint(out, len(msg.buckets))
        for bucket in msg.buckets:
            _w_varint(out, bucket)
    elif isinstance(msg, MsgIntervalReset):
        out.append(_TAG_INTERVAL_RESET)
        _w_varint(out, msg.seq)
    elif isinstance(msg, MsgRelayPush):
        out.append(_TAG_RELAY_PUSH)
        _w_varint(out, msg.seq)
        _w_str(out, msg.origin)
        _w_varint(out, msg.oseq)
        _w_bytes(out, msg.span)
        _w_str(out, msg.name)
        _w_varint(out, len(msg.batch))
        for key, delta in msg.batch:
            _w_bytes(out, key)
            _w_delta(out, msg.name, delta)
    elif isinstance(msg, MsgRegionGossip):
        out.append(_TAG_REGION_GOSSIP)
        _w_varint(out, len(msg.regions))
        for addr_s, region, epoch in msg.regions:
            _w_str(out, addr_s)
            _w_str(out, region)
            _w_varint(out, epoch)
    else:
        raise CodecError(f"cannot encode {type(msg).__name__}")
    return bytes(out)


def _decode_oracle(body: bytes) -> Msg:
    r = _Reader(body)
    if not body:
        raise CodecError("empty message")
    tag = body[0]
    r.pos = 1
    if tag == _TAG_PONG:
        msg: Msg = MsgPong()
    elif tag == _TAG_SYNC_DONE:
        msg = MsgSyncDone(_r_svec(r))
    elif tag == _TAG_EXCHANGE:
        msg = MsgExchangeAddrs(_r_p2set(r))
    elif tag == _TAG_ANNOUNCE:
        msg = MsgAnnounceAddrs(_r_p2set(r))
    elif tag == _TAG_PUSH:
        name = r.str_()
        batch = tuple(
            (r.bytes_(), _r_delta(r, name)) for _ in range(r.varint())
        )
        msg = MsgPushDeltas(name, batch)
    elif tag == _TAG_SYNC_REQ:
        digests = tuple(r.bytes_() for _ in range(r.varint()))
        msg = MsgSyncRequest(digests, _r_svec(r))
    elif tag == _TAG_DELTA_ACK:
        msg = MsgDeltaAck(r.varint())
    elif tag == _TAG_SEQ_PUSH:
        seq = r.varint()
        oseq = r.varint()
        if seq > _U64_MAX or oseq > _U64_MAX:
            raise CodecError("seq exceeds u64")
        span = r.bytes_()
        name = r.str_()
        batch = tuple(
            (r.bytes_(), _r_delta(r, name)) for _ in range(r.varint())
        )
        msg = MsgSeqPush(seq, oseq, name, batch, span)
    elif tag == _TAG_DIGEST_TREE:
        name = r.str_()
        leaves = tuple(
            (r.varint(), r.bytes_()) for _ in range(r.varint())
        )
        msg = MsgDigestTree(name, leaves)
    elif tag == _TAG_RANGE_REQ:
        name = r.str_()
        buckets = tuple(r.varint() for _ in range(r.varint()))
        msg = MsgRangeRequest(name, buckets)
    elif tag == _TAG_INTERVAL_RESET:
        msg = MsgIntervalReset(r.varint())
    elif tag == _TAG_RELAY_PUSH:
        seq = r.varint()
        origin = r.str_()
        oseq = r.varint()
        if seq > _U64_MAX or oseq > _U64_MAX:
            raise CodecError("relay seq exceeds u64")
        span = r.bytes_()
        name = r.str_()
        batch = tuple(
            (r.bytes_(), _r_delta(r, name)) for _ in range(r.varint())
        )
        msg = MsgRelayPush(seq, origin, oseq, name, batch, span)
    elif tag == _TAG_REGION_GOSSIP:
        entries = []
        for _ in range(r.varint()):
            addr_s = r.str_()
            region = r.str_()
            epoch = r.varint()
            if epoch > _U64_MAX:
                raise CodecError("gossip epoch exceeds u64")
            entries.append((addr_s, region, epoch))
        msg = MsgRegionGossip(tuple(entries))
    else:
        raise CodecError(f"unknown message tag: {tag}")
    if not r.done():
        raise CodecError("trailing bytes after message")
    return msg
