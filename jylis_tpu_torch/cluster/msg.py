"""Cluster protocol messages.

The port's copy of jylis_tpu/cluster/msg.py, whole.

Reference analog: msg.pony:3-24 — four message kinds cross the cluster
wire: ``MsgPong`` (liveness ack), ``MsgExchangeAddrs`` (full membership
sync: carries the sender's whole P2Set, receiver converges and replies in
kind), ``MsgAnnounceAddrs`` (periodic membership gossip: receiver converges
and replies Pong), and ``MsgPushDeltas`` (anti-entropy: one data type's
drained delta batch).

The reference serialises these with the Pony runtime's whole-object-graph
``Serialise`` (_serialise.pony:3-14); here each message has an explicit
versioned binary encoding (codec.py) with a schema signature replacing the
reference's "same binary" handshake digest.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.p2set import P2Set
from ..utils.address import Address


@dataclass(frozen=True)
class MsgPong:
    pass


@dataclass(frozen=True)
class MsgSyncDone:
    """Reply closing a MsgSyncRequest: sent after the dump stream (or
    instead of one, when the request is deferred / digest-matched /
    rate-limited). Distinct from MsgPong so the requester's heartbeat
    round-trip histogram stays exact: every Pong the active side
    receives then answers a stamped push/announce send in FIFO order,
    and sync replies — whose timing includes digest computation or a
    whole dump stream — never consume a round-trip stamp.

    Schema v10: carries the responder's session vector — NON-EMPTY ONLY
    on the digest-match branch, where byte-equal state proves every
    write the responder's vector covers is in the requester's state too
    (the adoption rule sessions.py relies on; any other branch sends it
    empty). This is how a fresh joiner's session index bootstraps and
    how a rebooted origin re-learns its own pre-crash watermark."""

    svec: tuple = ()  # tuple[(rid: str, seq: int), ...]


@dataclass(frozen=True)
class MsgExchangeAddrs:
    known_addrs: P2Set  # P2Set[Address]


@dataclass(frozen=True)
class MsgAnnounceAddrs:
    known_addrs: P2Set  # P2Set[Address]


@dataclass(frozen=True)
class MsgPushDeltas:
    """(data-type name, [(key, delta)]) — the _SendDeltasFn payload shape
    (_send_deltas_fn.pony:1-2)."""

    name: str
    batch: tuple  # tuple[(key: bytes, delta), ...]


@dataclass(frozen=True)
class MsgSeqPush:
    """Schema v8 delta-interval broadcast: a MsgPushDeltas payload
    stamped with the SENDER's per-sender monotone batch sequence. The
    receiver tracks the highest contiguous seq per sender and answers
    every SeqPush with MsgDeltaAck(cum) — the sender retransmits only
    the unacked window on reconnection, so a short blip reships exactly
    the missed batches instead of falling through to a state sync
    ("Efficient State-based CRDTs by Delta-Mutation", arXiv:1410.2803's
    delta-interval algorithm). Content-free keepalives (the SYSTEM
    deltas_size()==1 quirk) stay unsequenced MsgPushDeltas: sequencing
    them would burn retransmit-window slots on frames that carry
    nothing.

    Schema v10: also carries ``oseq``, the sender's OWN-CONTENT ordinal
    — a second counter that ticks only for the sender's own batches,
    never for the relay frames a bridge interleaves into its transport
    stream. Session vectors (sessions.py) track oseq, not seq: oseq is
    gapless per origin, so the same contiguity rule works at direct
    receivers AND transitively through any number of relay hops, where
    the intermediate bridges' transport-seq consumption is invisible.
    The transport machinery (acks, retransmit, _recv_cum) stays on
    ``seq``.

    Schema v11: also carries ``span``, a sampled provenance trace
    (obs/jtrace.py — empty for the 1-in-N complement, one length byte
    on the wire). Transport-only like oseq: the delta signature is
    untouched. Declared LAST with a default so every positional
    construction (and the golden corpus) predating v11 stays valid."""

    seq: int
    oseq: int
    name: str
    batch: tuple  # tuple[(key: bytes, delta), ...]
    span: bytes = b""


@dataclass(frozen=True)
class MsgDeltaAck:
    """Cumulative contiguous ack of a sender's MsgSeqPush stream: "I
    have applied every batch of yours up to and including cum". Sent by
    the receiver for EVERY SeqPush (duplicates included — the ack
    re-states cum), it doubles as the push path's liveness reply, so it
    consumes the sender's rtt stamp exactly like a Pong."""

    cum: int


@dataclass(frozen=True)
class MsgDigestTree:
    """One type's keyspace-range digest tree (schema v8 Merkle-range
    repair, after "Big(ger) Sets", arXiv:1605.06424): sparse non-empty
    leaves of the 256-bucket tree over sha256(key)[0], each leaf the
    XOR of its keys' canonical per-key state hashes. Sent by a sync
    responder for each type whose ROOT digest mismatches the
    requester's — ~8 KB instead of a keyspace dump; the requester
    compares leaves and pulls only divergent buckets via
    MsgRangeRequest. An EMPTY tree (zero leaves) is legal: it means the
    responder holds no keys of that type."""

    name: str
    leaves: tuple = ()  # tuple[(bucket: int, digest: bytes32), ...]


@dataclass(frozen=True)
class MsgRangeRequest:
    """Pull one type's state for the named digest-tree buckets only.
    The responder streams the range as chunked MsgPushDeltas frames
    (the snapshot wire shape — converges idempotently) and closes with
    MsgSyncDone; the requester walks remaining divergent buckets in
    budgeted rounds, so repair bytes AND repair work scale with
    divergence, never with keyspace. An empty bucket list is legal and
    serves nothing but the SyncDone."""

    name: str
    buckets: tuple = ()  # tuple[int, ...]


@dataclass(frozen=True)
class MsgIntervalReset:
    """The sender's delta log can no longer replay this receiver's gap
    (held past the retransmit window, or evicted at the cap mid-
    partition): "re-baseline your contiguity cursor to seq and pull a
    range repair from me". The graceful-degradation rung between
    interval retransmit and range repair — the receiver clears its
    out-of-order set, adopts seq, and forces a digest-tree sync toward
    the sender, so held-window loss demotes to range repair instead of
    silent divergence (or a whole-state dump)."""

    seq: int


@dataclass(frozen=True)
class MsgSyncRequest:
    """Bootstrap/rejoin full-state sync (beyond the reference, which can
    permanently miss deltas flushed while a peer was away —
    cluster.pony:250-252 converges only what is pushed). The requester
    sends this after establishing an active connection (and periodically
    thereafter) WITH its own PER-TYPE data-state digests; a peer whose
    digests all match replies MsgSyncDone (the requester is already in sync
    — a flapping connection re-ships nothing), otherwise it streams ONLY
    the mismatched types' state as chunked MsgPushDeltas batches (the
    snapshot wire shape, persist.py), which converge idempotently.

    digests: one 32-byte incremental digest per DATA type, in
    Database.DATA_TYPES order (TREG, TLOG, GCOUNT, PNCOUNT, UJSON,
    TENSOR, MAP, BCOUNT — models/database.py DATA_REPO_CLASSES —
    SYSTEM excluded: its log advances on connection events themselves,
    which would make two in-sync peers never match). Each is the XOR of
    sha256(canonical per-key state) over the type's keys.

    Schema v10: also carries the requester's session vector, snapshotted
    BEFORE its digests were computed (so the vector never claims more
    than the digested state holds). On a digest match the responder
    adopts it — the symmetric half of MsgSyncDone's svec."""

    digests: tuple = ()
    svec: tuple = ()  # tuple[(rid: str, seq: int), ...]


@dataclass(frozen=True)
class MsgRelayPush:
    """Schema v10 origin-preserving relay: a MsgSeqPush whose content
    ORIGINATED at another replica, re-exported by a bridge (a region
    bridge between WAN meshes, or lane 0 between the lane bus and the
    external mesh). ``seq`` is the RELAYING sender's transport seq —
    the frame rides its delta log, is acked by MsgDeltaAck and
    retransmitted on reconnect exactly like a SeqPush, so transport
    contiguity per sender is preserved even though bridges fan subsets
    of traffic. ``origin``/``oseq`` are the originating incarnation's
    rid (sessions.make_rid) and ITS batch seq, carried verbatim hop to
    hop: receivers advance their session vector for the ORIGIN, which
    is what lets a session token minted in one region verify in
    another. name+batch bytes are msg3's after the prefix (native codec
    fast path serves the relay hot path too).

    Schema v11: carries ``span`` like MsgSeqPush — the relaying bridge
    appends its own hop stamp to the origin's chain before re-export,
    which is what makes the WAN leg visible in SYSTEM TRACE SPANS."""

    seq: int
    origin: str
    oseq: int
    name: str
    batch: tuple  # tuple[(key: bytes, delta), ...]
    span: bytes = b""


@dataclass(frozen=True)
class MsgRegionGossip:
    """Region membership gossip (schema v10): (advertised address,
    region name, epoch) triples, broadcast on the announce cadence.
    Regions also ride the handshake; the gossip is what lets a node
    classify addresses it has never dialed (the region-aware peering
    policy needs every KNOWN address's region to pick the
    deterministic bridge and prune out-of-region dials). Each entry is
    VERSIONED by the subject node's boot epoch and folds
    highest-epoch-wins — unversioned gossip would let stale maps
    oscillate the cluster's classification (and so bridge election)
    forever after a node's region changes across a restart."""

    regions: tuple = ()  # tuple[(addr: str, region: str, epoch: int), ...]


Msg = (
    MsgPong
    | MsgSyncDone
    | MsgExchangeAddrs
    | MsgAnnounceAddrs
    | MsgPushDeltas
    | MsgSyncRequest
    | MsgSeqPush
    | MsgDeltaAck
    | MsgDigestTree
    | MsgRangeRequest
    | MsgIntervalReset
    | MsgRelayPush
    | MsgRegionGossip
)
