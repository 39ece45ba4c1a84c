"""Cluster engine: gossip membership + anti-entropy delta broadcast.

Reference analog: cluster.pony:4-265 — the whole distributed backend:

* **Topology: full mesh.** Every node dials an *active* connection to every
  other known address (cluster.pony:51-71); inbound connections are
  *passive*. The cluster listener binds the port from ``--addr``.
* **Membership = CRDT gossip.** ``_known_addrs`` is a P2Set[Address] seeded
  with self + ``--seed-addrs`` (cluster.pony:39-40); ``MsgExchangeAddrs``
  full-syncs on establishment and after any membership change
  (cluster.pony:154,236-238,244-246); ``MsgAnnounceAddrs`` goes to all
  actives every 3rd tick (cluster.pony:123-128).
* **Self-healing names:** any gossiped address with my host:port but a
  different name is permanently blacklisted via P2Set removal
  (cluster.pony:215-230).
* **Failure detection:** per-connection activity tick; conns idle > 10
  ticks are closed (cluster.pony:118-121); dropped actives are re-dialed on
  the next sync (cluster.pony:92-99), dropped passives are forgotten.
* **Anti-entropy:** every tick ``database.flush_deltas(broadcast_deltas)``;
  each repo's drained batch is serialised ONCE as ``MsgPushDeltas`` and
  written to every active connection (cluster.pony:130-131,205-213) —
  fire-and-forget, no acks, no retransmit; duplicate delivery is harmless
  (idempotent lattice join). Receivers converge and reply ``MsgPong``
  (liveness only).

The Pony actor becomes an asyncio component: one read-task per connection,
all state mutation on the single event loop (the same no-data-races
guarantee the actor gave).

The port's copy of jylis_tpu/cluster/cluster.py: the same protocol and
message handling, so a port node and a JAX node share one cluster. It
meets the port's Database through ``converge_async(name, batch)``,
``flush_deltas_async``, ``dump_state_async``, ``dump_range_async``,
``sync_type_digests_async`` and ``sync_tree_async``; the Database runs
each dump, drain and digest fold in a worker thread on the node's
device (models/database.py). The Database's ``sessions`` index is bound
by the driving instance, and lanes.py wires the lane bus and lane 0's
bridge through ``drive_flush``, ``register_system``, ``flush_sink`` and
``on_push``.

One rule differs from the JAX engine, and only in the idle eviction
(``_evict_idle``); no wire byte changes. A connection is live while its
read loop holds a frame (``_Conn.holding``: parsed, its converge waiting
on a repo lock that a drain, a digest fold or a range dump holds), and
while its peer was heard within ``IDLE_TICKS_LIMIT`` ticks on any
connection (``_seen_tick``): a peer whose read loop waits on its own lock
sends no Pong meanwhile, though its heartbeat still reaches us. In the
JAX engine both count as idle, so at a short heartbeat (the lane bus's
0.25 s) a lock held for a few seconds evicts the connection and the
range walk it carries dies with it.
"""

from __future__ import annotations

import asyncio
import struct
import time
import zlib
from collections import deque

from .. import faults
from .. import sessions as sessions_mod
from ..obs import jtrace
from ..obs.trace import now_ms
from ..ops.p2set import P2Set
from ..utils.address import Address
from ..utils.config import Config
from ..utils.net import ipv4_port
from . import codec
from .framing import FrameReader, FramingError, frame
from .heart import Heart
from .msg import (
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

IDLE_TICKS_LIMIT = 10  # cluster.pony:118-121
ANNOUNCE_EVERY = 3  # cluster.pony:123-128
# bootstrap/rejoin sync: at most one full-state request per peer per this
# many ticks (re-establishment after any gap may have missed deltas —
# fire-and-forget has no retransmit; see MsgSyncRequest)
SYNC_REQUEST_COOLDOWN = 10
# periodic digest exchange: every this many ticks, each established
# active connection re-sends a MsgSyncRequest (subject to the cooldown).
# Fire-and-forget broadcast can lose deltas when the SENDER's outbound
# connection churns — a loss the RECEIVER cannot observe, so
# establishment-triggered requests alone never heal it. With the
# incremental digest a periodic check costs 32 bytes + a Pong when
# in sync, so convergence is guaranteed within one period of any loss.
SYNC_PERIOD_TICKS = 50
# keys per MsgPushDeltas frame in a sync dump: a million-key type streams
# as many bounded frames under writer backpressure instead of one frame
# that trips the 16 MB kill limit or monopolises the peer's read loop
SYNC_CHUNK_KEYS = 2048
# additional per-frame byte cap: a chunk whose ENCODED size crosses this
# re-splits by key, so a few huge values (an untrimmed TLOG, a wide UJSON
# doc) cannot produce one arbitrarily large frame / encode stall
SYNC_CHUNK_BYTES = 4 << 20
# ---- anti-entropy v2 (schema v8) -------------------------------------------
# retransmit window: how many sequenced delta batches the sender keeps
# for per-peer ack-gap replay. A peer whose unacked gap falls off this
# window is marked INTERVAL-DIRTY and demoted to range repair
# (MsgIntervalReset) — never silently lost, never a whole-state dump.
# Overridable via --delta-log-cap; the default VALUE lives on the
# Config dataclass (one source for the dataclass, the CLI and this
# fallback — three hardcoded copies would drift silently).
DELTA_LOG_CAP = Config.delta_log_cap
# requester-side repair budget: divergent digest-tree buckets pulled
# per MsgRangeRequest round. Each round is served as one backpressured
# stream; the requester walks remaining buckets on each MsgSyncDone, so
# one rejoining node's heal is paced in bounded slices instead of one
# keyspace-sized burst that starves serving. Overridable via
# --range-budget (default on Config).
RANGE_REQ_BUCKETS = Config.range_budget
# receiver-side out-of-order cap per sender: seqs above the contiguity
# cursor park here until retransmit fills the gap. Past the cap the
# interval bookkeeping is declared lost and the receiver self-demotes
# to range repair (rebase cum, pull the tree) — the ladder's promise
# that interval-state confusion degrades to range repair, not to
# unbounded memory.
RECV_OOO_CAP = 512
# reconnection-replay byte cap: _retransmit_unacked writes the unacked
# window synchronously (inside handshake handling, no drain between
# frames), so the whole replay must fit comfortably under the conn's
# 16 MB write-buffer limit. A gap bigger than this is demoted to range
# repair via MsgIntervalReset — bytes proportional to divergence is the
# range tier's job, not the interval tier's.
RETRANSMIT_BYTES_CAP = 4 << 20
# ---- bridge failover ------------------------------------------------------
# liveness-aware bridge succession: an address that produced NO
# received frame for this many heartbeat ticks is demoted from bridge
# election by every observer independently — the next-smallest LIVE
# address of the region takes over, with no election traffic (every
# node computes the same succession from its own evidence; transient
# disagreement costs a dual-bridge overlap window the origin-preserving
# MsgRelayPush dedup absorbs). Overridable via --bridge-demote-ticks
# (default on Config).
BRIDGE_DEMOTE_TICKS = Config.bridge_demote_ticks
# a candidate we have NEVER heard from is optimistic-live (bootstrap:
# gossip teaches addresses before contact) — until the dial state
# machine accumulates this many consecutive connect failures, which is
# the only death evidence available for an address we hold no conn to
BRIDGE_DEMOTE_FAILS = 3
# cross-bridge repair relay queue: a region bridge re-exports the
# sync/repair data it pulls across the WAN into its intra-region mesh
# (so a rejoining REGION heals through its bridge instead of waiting
# for each member's coincidental periodic sync), buffered in a
# byte-capped queue drained by one backpressured task — the
# RETRANSMIT_BYTES_CAP discipline applied to the WAN seam. Past the
# cap frames DROP (counted in relay_dropped): the members' own
# periodic digest syncs remain the correctness backstop, exactly as
# for any lost sync frame.
RELAY_QUEUE_BYTES_CAP = 4 << 20
# dial state machine defaults (overridable via --dial-timeout /
# --dial-backoff-cap; values live on Config): connect attempts are
# bounded by DIAL_TIMEOUT seconds (a blackholed peer must not hold a
# placeholder conn for the OS's minutes-long TCP timeout), and
# consecutive dial failures back off exponentially in heartbeat ticks
# up to DIAL_BACKOFF_CAP (plus a deterministic jitter of up to half the
# backoff, so a cluster-wide restart does not thundering-herd one
# recovering peer in lockstep)
DIAL_TIMEOUT = Config.dial_timeout
DIAL_BACKOFF_CAP = Config.dial_backoff_cap

# cluster transport integrity: every frame body is prefixed with its
# CRC32 (schema v5). TCP checksums are weak (16-bit, and they end at
# the kernel boundary); without this, the drill matrix demonstrated
# that a single bit flip inside a sync-dump or push frame can decode
# as a VALID message with a mutated counter value — which then
# converges cluster-wide as forged lattice state, digest-matched and
# permanently undetectable. With the CRC the corruption is detected at
# the receiver, the connection dropped (Drop.CRC), and the redial +
# sync heal re-ships the true state. The on-disk formats are unchanged:
# the journal has its own per-frame CRC, snapshots are
# write-then-rename + full validation.
#
# Schema v6 adds the sender's wall-clock origin (ms, u64be) between the
# CRC and the body, covered by the CRC: the one distributed quantity a
# delta-CRDT store exists to bound — how stale a delta is when it
# becomes visible on a replica — was observable nowhere before this.
# Receivers subtract the stamp at apply time to feed the per-peer
# converge_lag_ms gauge. Stamping the TRANSPORT (not MsgPushDeltas)
# keeps snapshots/journals — which store bare message payloads under
# delta_signature — loadable across the bump; origin 0 means unstamped.
_WIRE_CRC_LEN = 4
_WIRE_ORIGIN_LEN = 8


# one wall-clock-ms source for origin stamps AND trace timestamps, so
# the two surfaces can never disagree about when an event happened
_now_ms = now_ms


class Clock:
    """Injectable time source for one Cluster instance. Production runs
    on wall time (this class); jmodel (scripts/jmodel) substitutes a
    virtual clock that advances only when the explorer says so, which is
    what makes exhaustive schedule exploration deterministic and
    wall-time-free. ``now_ms`` feeds origin stamps, held-delta ages and
    the backlog gauge; ``perf`` feeds the rtt histogram's send→Pong
    stamps."""

    __slots__ = ()

    def now_ms(self) -> int:
        return _now_ms()

    def perf(self) -> float:
        return time.perf_counter()


REAL_CLOCK = Clock()


async def tcp_connect(addr: Address):
    """The default transport seam: one real TCP dial. jmodel swaps this
    for an in-memory pipe factory; everything above the seam — the dial
    state machine, handshake, read loop, every message handler — is the
    same code either way (the explorer drives the REAL protocol, not a
    re-model)."""
    return await asyncio.open_connection(addr.host, int(addr.port))


def wire_frame(body: bytes, origin_ms: int | None = None) -> bytes:
    """One cluster transport frame: framing header + crc32(stamp+body)
    + origin stamp + body. ``origin_ms`` defaults to now."""
    stamped = struct.pack(
        ">Q", _now_ms() if origin_ms is None else origin_ms
    ) + body
    return frame(struct.pack(">I", zlib.crc32(stamped)) + stamped)


def check_frame(raw: bytes) -> tuple[int, bytes] | None:
    """CRC-validate one received frame; (origin_ms, payload), or None
    if corrupt/short."""
    if len(raw) < _WIRE_CRC_LEN + _WIRE_ORIGIN_LEN:
        return None
    (crc,) = struct.unpack_from(">I", raw)
    stamped = raw[_WIRE_CRC_LEN:]
    if zlib.crc32(stamped) != crc:
        return None
    (origin_ms,) = struct.unpack_from(">Q", stamped)
    return origin_ms, stamped[_WIRE_ORIGIN_LEN:]


class Drop:
    """Connection teardown reasons — stamped into every `_drop` log line
    and counted per reason in the CLUSTER metrics section."""

    IDLE = "idle"
    EOF = "eof"
    HANDSHAKE = "handshake_mismatch"
    CODEC = "codec_error"
    CRC = "crc_mismatch"
    WRITE_FAILED = "write_failed"
    UNEXPECTED = "unexpected_msg"
    DISPOSED = "disposed"
    BLACKLISTED = "blacklisted"
    # region-aware peering (schema v10): the conn is out of the sparse
    # WAN topology's policy (an out-of-region non-bridge peer) — dropped
    # without peer-fault backoff, and _sync_actives never redials while
    # the region map says so
    REGION = "region_scope"


class MsgDrop:
    """DECLARED message-level drops: a frame that arrives outside the
    protocol's expected (role, state, message) envelope is discarded —
    the connection stays up — but never silently: each drop is counted
    per reason (``msg_drop_<reason>`` in the CLUSTER metrics section)
    and traced. jlint pass 10's protocol atlas enumerates exactly these
    sites, so a new silent fall-through cannot be added unreviewed."""

    # a Pong on a passive conn: we never send Pong-soliciting frames on
    # passive conns, so nothing can legitimately answer with one
    PONG_UNSOLICITED = "pong_unsolicited"
    # a Pong on an active conn with no outstanding stamped send — the
    # peer ponged something we never asked about (or double-ponged)
    PONG_UNMATCHED = "pong_unmatched"
    # a SyncDone on a passive conn: sync replies close OUR requests,
    # which only ever go out on active conns
    SYNC_DONE_UNSOLICITED = "sync_done_unsolicited"
    # a DeltaAck with no outstanding stamped send — the cum is still
    # folded into the peer's interval state (the ack information is
    # valid regardless), but the rtt surface declares the mismatch
    ACK_UNMATCHED = "ack_unmatched"


# active-conn teardown reasons that mean the PEER (not the network)
# misbehaved after the TCP connect succeeded: an incompatible build
# (rolling upgrade across a schema bump), a corrupting link, a protocol
# violation. These engage the same dial backoff as a connect failure —
# without this, a persistently incompatible peer whose TCP connect
# works is re-dialed every heartbeat forever, the exact churn the
# backoff machinery exists to bound. Ordinary churn (eof, idle,
# write_failed) keeps the next-tick redial the reference promises.
_PEER_FAULT_DROPS = frozenset(
    {Drop.HANDSHAKE, Drop.CODEC, Drop.CRC, Drop.UNEXPECTED}
)


class _PeerState:
    """Per-address dial lifecycle: consecutive failures and the earliest
    tick the next dial may happen (exponential backoff, reset to 0 by a
    successful establishment or by inbound contact from that address) —
    plus the delta-interval SENDER state for that peer: the cumulative
    seq it has acked, and whether its unacked gap fell off the
    retransmit window (interval-dirty: the peer is owed a range repair,
    announced via MsgIntervalReset). Living on the ADDRESS, not the
    connection, is the point — acks survive conn churn, which is what
    makes reconnect retransmit exactly the missed window."""

    __slots__ = (
        "fails", "next_dial_tick", "dials",
        "acked", "interval_dirty", "reset_seq",
    )

    def __init__(self):
        self.fails = 0
        self.next_dial_tick = 0
        self.dials = 0  # total attempts (the drill's bounded-rate check)
        # highest cumulative MsgSeqPush seq this peer has acked; None
        # until its first ack (a brand-new peer bootstraps its history
        # through the digest-tree sync, not through replay)
        self.acked: int | None = None
        self.interval_dirty = False
        self.reset_seq = 0  # seq the last MsgIntervalReset re-based to


class _Conn:
    """One cluster TCP connection (either role), with its read task."""

    __slots__ = (
        "writer", "active_addr", "peer_addr", "established", "task",
        "sync_served_tick",
        "sync_digests", "sync_svec", "sync_defer_streak",
        "sync_defer_last_tick",
        "pong_sent", "last_write_dropped", "range_pending",
        "range_inflight", "peer_region", "peer_epoch", "peer_srid",
        "holding",
    )

    def __init__(self, writer, active_addr: Address | None):
        self.writer = writer
        self.active_addr = active_addr  # None for passive conns
        # advertised identity of a PASSIVE peer, learned from the v5
        # handshake's dialer-address suffix (teardown log identity +
        # the inbound-contact backoff reset); None until handshake
        self.peer_addr: Address | None = None
        # v10 handshake: the peer's region (topology classification)
        # and boot epoch; on passive conns the two combine into the
        # sender's session rid (sessions.make_rid), which keys every
        # applied-vector advance for its SeqPush stream
        self.peer_region = ""
        self.peer_epoch = 0
        self.peer_srid: str | None = None
        self.established = False
        self.task: asyncio.Task | None = None
        # tick of the last sync served on this conn (rate limit: repeated
        # requests within the cooldown get a SyncDone, not another dump)
        self.sync_served_tick: int | None = None
        self.sync_digests = ()  # the requester's per-type digests, if any
        self.sync_svec = ()  # ... and its session vector (v10 adoption)
        # consecutive mid-heal serve deferrals for THIS requester, capped
        # (see _passive_msg's MsgSyncRequest branch). Per-connection, not
        # global (ADVICE round 5): a single shared streak lets the serve
        # slot land repeatedly on one peer of several concurrently
        # rejoining in stable order, starving the others even though the
        # aggregate refusal chain is capped — per-peer streaks make the
        # finite-refusal guarantee hold for EACH requester.
        self.sync_defer_streak = 0
        self.sync_defer_last_tick: int | None = None
        # send time of EVERY Pong-soliciting frame (push/announce)
        # awaiting its Pong on this ACTIVE conn — the cluster.rtt
        # histogram's heartbeat-send→Pong seam. Every such send is
        # stamped and every Pong pops, so the FIFO match is exact even
        # through a held-delta flush that puts hundreds of sends in
        # flight at once (a maxlen here would evict under that burst and
        # desync every later match by the evicted count). Growth is
        # bounded without a cap: in-flight frames are limited by the
        # conn's WRITE_BUFFER_LIMIT, a peer that stops replying is
        # idle-evicted within IDLE_TICKS_LIMIT ticks, and the deque dies
        # with the conn.
        self.pong_sent: deque = deque()
        # requester-side range-walk cursor (ACTIVE conns): per type, the
        # divergent digest-tree buckets not yet pulled from this peer.
        # Each MsgSyncDone pops the next RANGE_REQ_BUCKETS-sized chunk
        # into a MsgRangeRequest, so a big heal walks the tree in
        # budgeted rounds. Dies with the conn: a reconnect re-compares
        # trees (cheap) rather than trusting a stale cursor.
        self.range_pending: dict[str, list[int]] = {}
        # True while a MsgRangeRequest round is outstanding on this conn
        # — the requester side of the repair budget. Without it, N
        # mismatched types (each tree handled as its own task) plus the
        # digest request's closing SyncDone would each start a round,
        # sustaining N+1 concurrent range streams against one responder.
        self.range_inflight = False
        # True while the read loop holds a parsed frame whose handling
        # awaits (a converge waiting on a repo lock): the idle clock does
        # not run meanwhile (_evict_idle)
        self.holding = False
        # True when the LAST send_raw "succeeded" only because an
        # injected cluster.write=drop swallowed it: no frame reached
        # the peer, so no Pong will answer — the rtt path must not
        # stamp, or every later FIFO match shifts by one for the
        # connection's lifetime
        self.last_write_dropped = False

    # a peer that keeps ponging but stops reading would otherwise grow the
    # transport write buffer without bound
    WRITE_BUFFER_LIMIT = 16 << 20

    def send_raw(self, data: bytes) -> bool:
        # asyncio transports never raise from write(); a dead peer shows up
        # as a closing transport, so check that to get working
        # dead-connection detection on the broadcast path
        if self.writer is None or self.writer.transport.is_closing():
            return False
        if self.writer.transport.get_write_buffer_size() > self.WRITE_BUFFER_LIMIT:
            return False  # backpressure: treat as dead, caller drops us
        try:
            # cluster.write: error -> conn treated dead (FaultError is a
            # ConnectionError, caught below); corrupt -> receiver's codec
            # refuses and drops us; drop -> silent send loss, healed only
            # by the periodic digest sync — the drill's loss-window case
            data = faults.point("cluster.write", data)
            if data is None:
                self.last_write_dropped = True
                return True  # injected send loss: pretend delivered
            self.last_write_dropped = False
            self.writer.write(data)
            return True
        except (ConnectionError, RuntimeError):
            return False

    def close(self) -> None:
        try:
            self.writer.close()
        except (ConnectionError, RuntimeError):
            pass


class Cluster:
    def __init__(
        self,
        config,
        database,
        drive_flush: bool = True,
        register_system: bool = True,
        clock: Clock | None = None,
        connect=None,
    ):
        self._config = config
        self._database = database
        self._log = config.log
        # injectable clock + transport (jmodel's two seams): defaults
        # are wall time and real TCP; the explorer passes a virtual
        # clock and an in-memory pipe factory. Everything downstream of
        # these two calls is identical in production and under the model
        # checker.
        self._clock = clock or REAL_CLOCK
        self._connect = connect or tcp_connect
        # multi-lane bridge hooks (lanes.py). A node running N serving
        # lanes has TWO Cluster instances on lane 0 — the external mesh
        # on config.addr and the loopback lane bus — sharing ONE
        # Database whose delta buffer must drain exactly once per
        # flush: `drive_flush=False` makes this instance's heartbeat
        # skip the database flush (dials/eviction/announce/sync still
        # run), and `flush_sink` (when set on the driving instance)
        # replaces broadcast_deltas as the flush sink so one drain can
        # tee to both meshes. `on_push` is called after every converged
        # MsgPushDeltas with (name, batch) — the bridge relays inbound
        # deltas to the OTHER mesh there (converge never re-exports, so
        # relaying cannot echo). `register_system=False` keeps this
        # instance from claiming the SYSTEM METRICS CLUSTER section.
        self._drive_flush = drive_flush
        self.flush_sink = None
        self.on_push = None
        # ---- provenance spans (schema v11, obs/jtrace.py) --------------
        # 1-in-N sequenced flushes get a trace span minted at
        # broadcast_deltas (0 disables). `last_span` exposes the span of
        # the most recent broadcast so the lane tee (lanes.py) can carry
        # the SAME chain onto the external mesh without widening the
        # broadcast_deltas signature tests and jlint pin. `relay_hop` is
        # the hop tag relay_deltas stamps — HOP_RELAY for a plain
        # bridge, overridden by lanes.py/main.py wiring so the bus and
        # the external cluster legs are distinguishable in a chain.
        self._trace_sample = max(0, getattr(config, "trace_sample", 0))
        self._trace_n = 0
        self.last_span = b""
        self.relay_hop = jtrace.HOP_RELAY
        # the node's PRIMARY cluster view owns the shared observability
        # names (cluster.rtt histogram, converge_lag_ms/backlog_ms
        # gauges, SYSTEM METRICS CLUSTER section). On lane 0 the
        # loopback bus instance is secondary (register_system=False):
        # letting it record would drown the external mesh's
        # microsecond-loopback-free rtt/lag signal — the exact
        # cross-node staleness surface the gauges exist to expose —
        # and flap the gauges last-writer-wins between the instances.
        self._obs_primary = register_system
        self._addr: Address = config.addr
        # ---- sessions & regions (schema v10) ---------------------------
        # boot epoch: the incarnation stamp of this instance's sequenced
        # stream. A crash-reboot restarts _delta_seq at 0; without the
        # epoch in the rid, peers' session vectors would alias the new
        # stream's seqs 1..k onto the old incarnation's watermark and
        # falsely verify post-reboot tokens (a real read-your-writes
        # hole — jmodel's crash schedules cover it). Wall-ms through the
        # injectable clock (deterministic under jmodel), floored by a
        # persisted per-address counter when --data-dir is set so a
        # clock stepping BACKWARDS across a reboot can never mint an
        # epoch the previous incarnation already used (review find);
        # clockless deployments accept the (sub-ms-window) residual.
        self._epoch = self._boot_epoch(config)
        self._srid = sessions_mod.make_rid(str(self._addr), self._epoch)
        self._region = getattr(config, "region", "")
        # {advertised address str -> (region name, epoch)}, learned
        # from v10 handshakes and MsgRegionGossip: what the peering
        # policy (_should_peer) classifies every known address with.
        # VERSIONED by the subject node's boot epoch (highest wins):
        # unversioned last-writer-wins would let peers re-gossiping a
        # stale map oscillate everyone's classification after a node's
        # region changes across a restart, flapping bridge election
        # forever (review find). An empty region with a higher epoch
        # legitimately CLEARS a stale one (the node restarted
        # region-less).
        self._regions: dict[str, tuple[str, int]] = {
            str(self._addr): (self._region, self._epoch)
        }
        # ---- bridge failover ----------------------------------------
        # per-address liveness evidence: the last tick a frame was
        # RECEIVED from that advertised address (any conn, either role).
        # Bridge election consults it (_addr_live): a bridge that
        # misses its announce cadence past --bridge-demote-ticks is
        # demoted by every observer and the next-smallest live address
        # succeeds it deterministically.
        self._seen_tick: dict[str, int] = {}
        self._bridge_demote = getattr(
            config, "bridge_demote_ticks", BRIDGE_DEMOTE_TICKS
        )
        # last elected bridge of OUR region ((), an impossible value,
        # until the first heartbeat computes one — the first election
        # is not a handover)
        self._bridge_seen: object = ()
        # cross-bridge repair relay queue: (name, batch, accounted
        # bytes) entries, drained FIFO by one backpressured task
        self._relay_queue: deque = deque()
        self._relay_queue_bytes = 0
        self._relay_inflight = False
        # the node's session index (sessions.SessionIndex) — owned by
        # the Database and SHARED by every cluster instance of the node
        # (bus + external on lane 0): applied-vector advances and
        # digest-match adoptions feed it from any mesh; only the
        # DRIVING instance binds its rid + flush hook for token minting
        self._sessions = getattr(database, "sessions", None)
        self._owns_session = drive_flush and self._sessions is not None
        if self._owns_session:
            self._sessions.bind(self._srid, self.flush_now)
        self._known_addrs: P2Set = P2Set([self._addr])
        for seed in config.seed_addrs:
            self._known_addrs.add(seed)
        self._actives: dict[Address, _Conn] = {}
        self._passives: set[_Conn] = set()
        self._last_activity: dict[_Conn, int] = {}
        # per-address dial lifecycle (timeout + exponential backoff with
        # deterministic jitter) — replaces the redial-every-tick loop: a
        # dead peer is re-dialed at a rate bounded by the backoff cap,
        # not once per heartbeat, and inbound contact from an address
        # resets its state so a rebooted peer is re-dialed immediately
        self._peers: dict[Address, _PeerState] = {}
        self._dial_timeout = getattr(config, "dial_timeout", DIAL_TIMEOUT)
        self._backoff_cap = getattr(config, "dial_backoff_cap", DIAL_BACKOFF_CAP)
        # CLUSTER metrics (SYSTEM METRICS): lifecycle counters + teardown
        # reasons; live peer-state counts are computed on demand
        self._stats = {
            "dials": 0, "dial_fails": 0,
            "sync_served": 0, "sync_deferred": 0, "sync_done_recv": 0,
            "held_drops": 0,
            # anti-entropy v2 (schema v8) repair-cost counters: repair
            # is observable, not inferred (docs/replication.md ladder)
            "deltas_reshipped": 0,      # retransmitted unacked batches
            "ranges_requested": 0,      # divergent buckets we pulled
            "ranges_served": 0,         # divergent buckets we streamed
            "sync_bytes_sent": 0,       # tree/range/dump frame bytes out
            "sync_bytes_recv": 0,       # tree/range/dump frame bytes in
            "sync_trees_sent": 0,       # digest trees streamed (per type)
            "sync_full_dumps": 0,       # legacy-shape fallback dumps ONLY
            "interval_resets_sent": 0,  # gaps we demoted to range repair
            "interval_resets_recv": 0,  # gaps peers demoted us over
            # sessions & regions (schema v10): bridge relay traffic and
            # topology prunes — WAN cost is observable, not inferred
            "relays_sent": 0,           # origin-preserving re-exports out
            "relays_recv": 0,           # relayed batches converged here
            "region_prunes": 0,         # conns dropped to topology policy
            # bridge failover: handovers this node OBSERVED
            # (its computed bridge-of-own-region changed), cross-bridge
            # repair batches re-exported into the intra mesh, and
            # repair relay frames dropped at the queue's byte cap
            "bridge_handovers": 0,
            "repair_relays": 0,
            "relay_dropped": 0,
        }
        self._drop_counts: dict[str, int] = {}
        # declared message-level drops (MsgDrop reasons): frame
        # discarded, conn kept — counted so an out-of-envelope peer is
        # visible in SYSTEM METRICS instead of silently tolerated
        self._msg_drops: dict[str, int] = {}
        self._held_drop_episode = False  # warn once per eviction episode
        self._tick = 0
        self._serial = codec.signature()
        self._server: asyncio.base_events.Server | None = None
        self._heart = Heart(self, config.heartbeat_time)
        self._disposed = False
        # Deltas flushed while ZERO established connections exist would be
        # pure loss (the reference loses them the same way — a known gap,
        # SURVEY.md §2.5); holding them until a peer is reachable strictly
        # reduces loss without changing fire-and-forget semantics. Bounded:
        # oldest batches drop past the cap. Entries are (held_at_ms,
        # frame): the age of the OLDEST entry is the anti-entropy
        # backlog's time dimension (the backlog_ms gauge).
        self._held: list[tuple[int, bytes]] = []
        self._held_cap = 1024
        # ---- delta-interval replication (schema v8) --------------------
        # per-sender monotone sequence over CONTENT-CARRYING delta
        # batches, and the bounded retransmit window of (seq, wired
        # frame) those batches live in. On (re)establishment the sender
        # reships exactly the entries past the peer's acked watermark;
        # an unacked gap that fell off the window demotes that peer to
        # range repair via MsgIntervalReset (see _log_delta /
        # _retransmit_unacked). The window holds pre-framed bytes: a
        # retransmit reships the ORIGINAL origin stamp, so the lag gauge
        # reports the delta's true staleness, not a fresh-looking lie.
        self._delta_seq = 0
        # own-content ordinal (schema v10): ticks ONLY for this
        # instance's own batches, never for relay frames — the session
        # counter (gapless per origin, so contiguity survives relay
        # hops; msg.py MsgSeqPush)
        self._own_seq = 0
        self._delta_log: deque = deque()  # (seq, wired frame)
        self._delta_log_cap = getattr(config, "delta_log_cap", DELTA_LOG_CAP)
        self._range_budget = getattr(config, "range_budget", RANGE_REQ_BUCKETS)
        # receiver-side interval state per SENDER identity (str addr):
        # the highest contiguous seq applied, plus the bounded
        # out-of-order park for seqs above it (collapsed when retransmit
        # fills the gap; rebased by MsgIntervalReset or the ooo cap)
        self._recv_cum: dict[str, int] = {}
        self._recv_ooo: dict[str, set[int]] = {}
        # server-side range-serve queue: (conn, type, buckets) FIFO
        # drained by ONE task with writer backpressure — the per-peer
        # repair budget (one outstanding request per requester, one
        # stream at a time) that keeps a rejoining node from starving
        # serving
        self._range_queue: list = []
        self._range_serve_inflight = False
        self._flush_tasks: set = set()  # strong refs; asyncio's are weak
        self._sync_req_tick: dict[Address, int] = {}  # rate limit per peer
        self._sync_req_inflight: set[Address] = set()  # one request per peer
        self._sync_waiters: list[_Conn] = []  # conns awaiting a sync dump
        self._sync_dump_inflight = False  # one dump task at a time
        self._local_writes_seen = False  # defers the periodic digest pull
        self._sync_defer_streak = 0  # consecutive deferred periods (capped)
        # tick of the last sync DATA frame received: while this node is
        # itself ingesting a heal, it defers serving dumps (Pong) — a
        # behind peer re-dumping its stale keyspace every period while
        # converging the very stream that fixes it starves its repo
        # locks (dump + converge + digest all contend) and wedges reads.
        # The deferrals themselves are capped PER REQUESTER (the streak
        # fields live on _Conn) so every rejoiner's refusal chain is
        # finite even when several rejoin concurrently in stable order —
        # PLUS a looser aggregate cap below: per-conn streaks reset on
        # reconnect, so a requester whose connection churns every period
        # would otherwise present a fresh allowance forever.
        self._sync_rx_tick: int | None = None
        self._sync_serve_defer_total = 0  # consecutive defers, any conn
        self._sync_defer_total_tick: int | None = None
        # observability (obs/): round-trip + convergence-lag histograms
        # from the owning Database's registry, per-peer lag EWMAs, and
        # the wall clock the backlog gauge ages held deltas against
        from ..utils import metrics as _metrics

        self._reg = _metrics.resolve_registry(database)
        self._h_rtt = self._reg.hist("cluster.rtt")
        self._h_lag = self._reg.hist("cluster.converge_lag")
        # peer identity (str address) -> push→apply lag EWMA in ms; a
        # digest match folds in as a zero-lag sample (the peer is
        # provably converged at that wall instant)
        self._lag_ms: dict[str, float] = {}
        # wall time the current consecutive-defer episode began (the
        # deferred-sync side of the backlog gauge); None when serving
        self._defer_since_ms: int | None = None
        # SYSTEM METRICS' CLUSTER section reads straight from this
        # instance (wired here, not in main, so in-process test nodes
        # get the same observability as spawned ones)
        system = getattr(database, "system", None)
        if system is not None and register_system:
            system.cluster_fn = self.metrics_totals
            system.lag_fn = self.lag_snapshot
            system.topology_fn = self.topology_lines
        # SYSTEM TOPOLOGY carries the node's client-facing RESP port so
        # a cluster-aware client (client.py) can map its seed endpoint
        # onto this cluster identity; main.py pushes the bound port in
        # after the server starts listening (0 until then)
        self.resp_port = 0

    # ---- lifecycle --------------------------------------------------------

    def _boot_epoch(self, config) -> int:
        """max(wall-ms, persisted floor + 1): epochs must be strictly
        monotone per address across reboots — see the __init__ comment.
        The sidecar file (`epoch.<addr-hash>` in --data-dir) is outside
        every pinned on-disk format; all I/O is best-effort (a missing
        dir or full disk degrades to the wall-clock epoch, never a
        boot failure)."""
        import os

        now = int(self._clock.now_ms())
        data_dir = getattr(config, "data_dir", "") or ""
        if not data_dir:
            return now
        path = os.path.join(data_dir, f"epoch.{self._addr.hash64():016x}")
        prev = -1
        try:
            # one tiny read at instance construction, before this
            # cluster serves anything (the async call sites in main.py
            # carry the blocking-ok suppressions)
            with open(path, encoding="utf-8") as f:
                prev = int(f.read().strip() or -1)
        except (OSError, ValueError):
            prev = -1
        epoch = max(now, prev + 1)
        try:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(str(epoch))
            os.replace(tmp, path)
        except OSError:
            pass  # best-effort: next boot falls back to wall time
        return epoch

    async def start(self) -> None:
        try:
            self._server = await asyncio.start_server(
                self._accept, host=None, port=int(self._addr.port or 0)
            )
        except OSError as e:
            self._log.err() and self._log.e(f"cluster listen failed: {e}")
            raise
        self._log.info() and self._log.i("cluster listen ready")
        self._heart.start()
        self._heartbeat()  # immediate first tick (cluster.pony:42)

    @property
    def listen_port(self) -> int:
        assert self._server is not None
        return ipv4_port(self._server)

    def dispose(self) -> None:
        """Stop listener, heart, and all connections (cluster.pony:44-49)."""
        self._disposed = True
        self._heart.dispose()
        if self._server is not None:
            self._server.close()
        for conn in list(self._actives.values()) + list(self._passives):
            self._drop(conn, Drop.DISPOSED)

    # ---- heartbeat --------------------------------------------------------

    def _heartbeat(self) -> None:
        if self._disposed:
            return
        self._tick += 1
        self._evict_idle()
        if (
            self._defer_since_ms is not None
            and self._sync_defer_total_tick is not None
            and self._tick - self._sync_defer_total_tick
            > 6 * SYNC_PERIOD_TICKS
        ):
            # nobody has been deferred for several sync periods: every
            # live requester re-pulls at least that often, so the defer
            # episode is over (served requests clear the clock on the
            # serve path; a requester that crashed mid-episode would
            # otherwise leave backlog_ms climbing forever)
            self._defer_since_ms = None
        self._refresh_bridge_role()
        self._prune_region_conns()
        if self._tick % ANNOUNCE_EVERY == 0:
            if any(r for r, _ in self._regions.values()):
                # region membership rides the announce cadence (v10):
                # without it, an address learned through gossip could
                # never be classified before a wasted dial. Region-less
                # clusters skip the frame entirely — their wire traffic
                # is unchanged from v9's shape. Gossip goes out BEFORE
                # the announce: a receiver folds classifications before
                # _converge_addrs can trigger policy dials on the new
                # addresses (the reboot dial-storm fix).
                self._broadcast_msg(
                    MsgRegionGossip(self._region_entries())
                )
            self._broadcast_msg(MsgAnnounceAddrs(self._known_addrs.copy()))
        if self._tick % SYNC_PERIOD_TICKS == 0:
            # periodic anti-entropy digest exchange (see SYNC_PERIOD_TICKS).
            # Deferred while LOCAL writes are flowing: a write-hot node
            # pulling peers' full dumps mid-burst ingests mostly-no-op
            # deltas whose threshold drains wedge its own serving; the
            # node(s) that actually missed data are quiet receivers, and
            # they keep requesting. Local-write detection rides the
            # flush path (outbound deltas exist only for local applies).
            # the deferral is CAPPED: a steadily write-hot node still
            # checks every few periods, or a loss IT suffered while its
            # peers' outbound conns churned would never heal
            if self._local_writes_seen and self._sync_defer_streak < 3:
                self._local_writes_seen = False
                self._sync_defer_streak += 1
            else:
                self._sync_defer_streak = 0
                for conn in list(self._actives.values()):
                    if conn.established:
                        self._maybe_request_sync(conn)
        self._flush_held()
        # flush as a task taking each repo's lock: a repo mid-drain delays
        # only its own flush, never the tick (eviction/announce/dial
        # above). Hold a strong reference — asyncio keeps only weak task
        # refs — and surface exceptions through the log. On a lane-0
        # bridge the non-driving instance skips this (the driving
        # instance's flush_sink tees the one drain to both meshes).
        if self._drive_flush:
            task = asyncio.get_running_loop().create_task(
                self._database.flush_deltas_async(
                    self.flush_sink or self.broadcast_deltas
                )
            )
            self._flush_tasks.add(task)
            task.add_done_callback(self._flush_task_done)
        self._sync_actives()

    def metrics_totals(self) -> dict[str, int]:
        """The SYSTEM METRICS `CLUSTER` section: live peer-state counts
        plus lifecycle counters. Keys are documented in
        docs/operations.md (failure envelope glossary)."""
        connecting = sum(
            1 for c in self._actives.values() if not c.established
        )
        backoff = sum(
            1
            for a, st in self._peers.items()
            if a not in self._actives
            and a != self._addr
            and a in self._known_addrs
            and self._tick < st.next_dial_tick
        )
        out = {
            "peers_known": max(len(self._known_addrs) - 1, 0),
            "peers_established": len(self._actives) - connecting,
            "peers_connecting": connecting,
            "peers_backoff": backoff,
            "passives": len(self._passives),
            "dials": self._stats["dials"],
            "dial_fails": self._stats["dial_fails"],
            "evictions": sum(self._drop_counts.values()),
            "sync_served": self._stats["sync_served"],
            "sync_deferred": self._stats["sync_deferred"],
            "sync_done_recv": self._stats["sync_done_recv"],
            "held_now": len(self._held),
            "held_drops": self._stats["held_drops"],
            "delta_log_len": len(self._delta_log),
            "interval_dirty_peers": self._dirty_count(),
            # the time dimension of anti-entropy health: worst per-peer
            # push→apply staleness, and how long work has been backed up
            # (held deltas / deferred sync serves) — both also published
            # as registry gauges for the Prometheus scrape
            "converge_lag_ms": int(self._worst_lag_ms()),
            "backlog_ms": int(self._backlog_ms()),
        }
        for key in (
            "deltas_reshipped", "ranges_requested", "ranges_served",
            "sync_bytes_sent", "sync_bytes_recv", "sync_trees_sent",
            "sync_full_dumps", "interval_resets_sent",
            "interval_resets_recv", "relays_sent", "relays_recv",
            "region_prunes", "bridge_handovers", "repair_relays",
            "relay_dropped",
        ):
            out[key] = self._stats[key]
        # bridge failover: whether THIS node is its region's
        # elected bridge right now, and the repair-relay queue's live
        # byte depth — both also registry gauges for the Prometheus
        # scrape
        out["bridge_is_self"] = (
            1 if self._region and self._is_bridge() else 0
        )
        out["relay_queue_bytes"] = self._relay_queue_bytes
        for reason in sorted(self._drop_counts):
            out[f"drop_{reason}"] = self._drop_counts[reason]
        for reason in sorted(self._msg_drops):
            out[f"msg_drop_{reason}"] = self._msg_drops[reason]
        return out

    # ---- convergence lag / backlog (obs) -----------------------------------

    # EWMA weight for a fresh lag sample: heavy enough that a healed
    # partition's gauge decays back to baseline within a few pushes,
    # smooth enough that one GC pause doesn't spike the surface
    LAG_ALPHA = 0.5

    def _note_lag(self, peer: str, lag_ms: float) -> None:
        if not self._reg.enabled or not self._obs_primary:
            return  # obs kill switch / secondary (lane-bus) instance
        old = self._lag_ms.get(peer)
        self._lag_ms[peer] = (
            lag_ms if old is None
            else old + self.LAG_ALPHA * (lag_ms - old)
        )
        self._h_lag.record(lag_ms / 1e3)
        self._reg.gauge_set("cluster.converge_lag_ms", self._worst_lag_ms())

    def _worst_lag_ms(self) -> float:
        return max(self._lag_ms.values(), default=0.0)

    def _dirty_count(self) -> int:
        return sum(1 for st in self._peers.values() if st.interval_dirty)

    def _mark_dirty(self, st: _PeerState, dirty: bool) -> None:
        """Flip a peer's interval-dirty flag and republish the
        cluster.interval_dirty_peers gauge — every transition is
        observable (a dirty peer is a peer owed a range repair; the
        gauge pinned at 0 is the churn soak's no-silent-loss check)."""
        if st.interval_dirty == dirty:
            return
        st.interval_dirty = dirty
        if self._reg.enabled and self._obs_primary:
            self._reg.gauge_set(
                "cluster.interval_dirty_peers", float(self._dirty_count())
            )

    def lag_snapshot(self) -> dict[str, float]:
        """{peer address: push→apply lag EWMA ms} — SYSTEM LATENCY's
        per-peer lines."""
        return dict(self._lag_ms)

    def _backlog_ms(self) -> float:
        """Age of the oldest held delta batch, or of the current
        sync-serve defer episode — whichever says work has been waiting
        longer. Published as the cluster.backlog_ms gauge."""
        now = self._clock.now_ms()
        age = float(now - self._held[0][0]) if self._held else 0.0
        if self._defer_since_ms is not None:
            age = max(age, float(now - self._defer_since_ms))
        if self._reg.enabled:
            self._reg.gauge_set("cluster.backlog_ms", age)
        return age

    def _flush_task_done(self, task) -> None:
        self._flush_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            self._log.err() and self._log.e(
                f"cluster background task failed: {task.exception()!r}"
            )

    def _evict_idle(self) -> None:
        for conn, last in list(self._last_activity.items()):
            if self._tick - last <= IDLE_TICKS_LIMIT:
                continue
            if conn.holding or self._peer_heard(conn):
                # the silence is a repo lock's, ours or the peer's, not a
                # dead peer's: the idle clock restarts, and the range
                # walk this connection carries goes on
                self._last_activity[conn] = self._tick
                continue
            self._drop(conn, Drop.IDLE)

    def _peer_heard(self, conn: _Conn) -> bool:
        """Whether a frame from this connection's peer arrived, on any
        of its connections, within IDLE_TICKS_LIMIT ticks."""
        key = self._peer_key(conn)
        seen = self._seen_tick.get(key) if key != "unknown" else None
        return seen is not None and self._tick - seen <= IDLE_TICKS_LIMIT

    # ---- region-aware peering (schema v10) ---------------------------------

    def _note_seen(self, conn: _Conn) -> None:
        """Record liveness evidence for a peer's advertised address: a
        frame was RECEIVED from it this tick. Feeds bridge election
        (_addr_live) — the only consumer — so an address that goes
        silent ages out of the electorate within the demotion bound."""
        key = self._peer_key(conn)
        if key != "unknown":
            self._seen_tick[key] = self._tick

    def _addr_live(self, addr: Address) -> bool:
        """Bridge-election liveness: an address is live while frames
        from it are at most --bridge-demote-ticks old. Self is always
        live; an address we NEVER heard from is optimistic-live
        (bootstrap: gossip teaches addresses before contact) until the
        dial machine accumulates BRIDGE_DEMOTE_FAILS consecutive
        connect failures — the only death evidence available without a
        conn."""
        if addr == self._addr:
            return True
        seen = self._seen_tick.get(str(addr))
        if seen is None:
            st = self._peers.get(addr)
            return st is None or st.fails < BRIDGE_DEMOTE_FAILS
        return self._tick - seen <= self._bridge_demote

    def _bridge_of(self, region: str) -> str | None:
        """The deterministic bridge of ``region``: the lexicographically
        smallest LIVE known address classified into it (liveness per
        this observer's own evidence — _addr_live). Every node computes
        the same succession from the same gossiped region map plus its
        own observations, so a dead bridge is demoted within the
        demotion bound and the next-smallest live address takes over
        with NO election traffic; transient observer disagreement costs
        a dual-bridge overlap window that the origin-preserving relay
        dedup absorbs. When EVERY candidate looks dead the v10
        deterministic choice (smallest address) stands — the topology
        must stay computable, and a wrong-but-stable answer beats
        none."""
        cands = [
            a
            for a in self._known_addrs
            if self._regions.get(str(a), ("", 0))[0] == region
        ]
        live = [str(a) for a in cands if self._addr_live(a)]
        if live:
            return min(live)
        return min((str(a) for a in cands), default=None)

    def _refresh_bridge_role(self) -> None:
        """Heartbeat half of bridge failover: recompute our region's
        elected bridge, count a handover when it CHANGED (the
        bridge_handovers counter — the drill's successor-observed
        signal), and publish the bridge_is_self gauge. Bootstrap
        counts ONE reclassification (the initial self-only region map
        elects self until gossip arrives), so consumers compare
        against a baseline, never against zero. Succession needs no
        further action here: _sync_actives dials the WAN peers
        _should_peer now admits, and _prune_region_conns sheds the
        ones it no longer does."""
        if not self._region:
            return
        b = self._bridge_of(self._region)
        if b != self._bridge_seen:
            if self._bridge_seen != ():
                self._stats["bridge_handovers"] += 1
                self._reg.trace_event(
                    "cluster", "bridge_handover", "",
                    f"{self._bridge_seen} -> {b}",
                )
                self._log.info() and self._log.i(
                    f"region {self._region}: bridge handover "
                    f"{self._bridge_seen} -> {b}"
                )
            self._bridge_seen = b
        if self._reg.enabled and self._obs_primary:
            self._reg.gauge_set(
                "cluster.bridge_is_self",
                1.0 if b == str(self._addr) else 0.0,
            )

    def topology_lines(self) -> list[str]:
        """The SYSTEM TOPOLOGY reply body: this node first (advertised
        address, region, bridge role, RESP port), then one line per
        OTHER known address with its gossiped region and this
        observer's own liveness evidence (_addr_live — the same
        evidence bridge election runs on, so a client and the
        electorate age a dead node out on the same clock). Flat
        greppable lines, not structured data, matching the METRICS
        house style; client.py's ClusterClient parses them for
        nearest-replica routing and leave detection."""
        region = self._region or "-"
        lines = [
            f"self {self._addr} region {region} bridge "
            f"{1 if self._is_bridge() else 0} resp_port {self.resp_port}"
        ]
        for a in sorted(self._known_addrs, key=str):
            if a == self._addr:
                continue
            r = self._regions.get(str(a), ("", 0))[0] or "-"
            lines.append(
                f"node {a} region {r} live "
                f"{1 if self._addr_live(a) else 0}"
            )
        return lines

    def _region_entries(self) -> tuple:
        """The gossiped region map as sorted wire triples."""
        return tuple(
            (a, r, e) for a, (r, e) in sorted(self._regions.items())
        )

    def _is_bridge(self) -> bool:
        return bool(self._region) and (
            self._bridge_of(self._region) == str(self._addr)
        )

    def _should_peer(self, addr: Address) -> bool:
        """The dial policy: region-less nodes (and region-less or
        unknown peers) keep the classic full mesh — bootstrap and mixed
        deployments degrade to v9 behavior; within a region the mesh
        stays full; across regions only the two bridges dial each
        other. Never affects PASSIVE acceptance: transient policy
        disagreement while gossip spreads costs a redundant conn, not a
        partition."""
        if not self._region:
            return True
        r = self._regions.get(str(addr), ("", 0))[0]
        if not r:
            return True
        if r == self._region:
            return True
        return self._is_bridge() and str(addr) == self._bridge_of(r)

    def _fold_regions(self, entries) -> None:
        """Fold (addr, region, epoch) triples: higher epoch wins (the
        subject node's own boot epoch is the version — it stamped the
        value into its handshakes/gossip, so the freshest incarnation's
        classification converges monotonically everywhere). Our own
        entry is never re-classified: we ARE its authority."""
        me = str(self._addr)
        for addr_s, region, epoch in entries:
            if addr_s == me:
                continue
            cur = self._regions.get(addr_s)
            if cur is None or epoch > cur[1]:
                self._regions[addr_s] = (region, epoch)

    def _prune_region_conns(self) -> None:
        """Drop actives the (possibly just-gossiped) region map says we
        should not hold — the heartbeat half of the sparse topology
        (the other half is _sync_actives never redialing them)."""
        for addr, conn in list(self._actives.items()):
            if not self._should_peer(addr):
                self._stats["region_prunes"] += 1
                self._drop(conn, Drop.REGION)

    def _sync_actives(self) -> None:
        """Dial an active connection to every known peer we lack
        (cluster.pony:51-71). Unlike the reference's redial-every-tick
        loop, each address runs a dial state machine: a failed dial
        backs the address off exponentially (deterministic jitter,
        capped), so an unreachable peer costs a bounded trickle of
        attempts instead of one per heartbeat. Region-aware peering
        (v10) additionally skips addresses outside the sparse topology
        (_should_peer)."""
        for addr in self._known_addrs:
            if addr == self._addr or addr in self._actives:
                continue
            if not self._should_peer(addr):
                continue
            st = self._peers.get(addr)
            if st is None:
                st = self._peers[addr] = _PeerState()
            if self._tick < st.next_dial_tick:
                continue  # backing off
            st.dials += 1
            self._stats["dials"] += 1
            loop = asyncio.get_running_loop()
            task = loop.create_task(self._dial(addr))
            conn = _Conn(writer=None, active_addr=addr)
            conn.task = task
            self._actives[addr] = conn

    # ---- active (outbound) connections ------------------------------------

    async def _dial(self, addr: Address) -> None:
        async def connect():
            # cluster.dial: error -> the OSError recovery path below;
            # sleep -> a blackholed connect, which wait_for then bounds
            await faults.async_point("cluster.dial")
            return await self._connect(addr)

        try:
            # the OS would let a blackholed connect hang for minutes;
            # bound it so the placeholder conn frees (and backoff starts)
            # within one predictable window
            reader, writer = await asyncio.wait_for(
                connect(), timeout=self._dial_timeout
            )
        except (OSError, ValueError, asyncio.TimeoutError):
            self._active_missed(addr)
            return
        conn = self._actives.get(addr)
        if conn is None or self._disposed:
            writer.close()
            return
        conn.writer = writer
        self._mark_activity(conn)  # handshake counts against the idle clock
        # handshake (v10): our schema signature, plus the hello suffix —
        # advertised address (the passive side's teardown-log identity
        # and inbound-contact backoff reset), region (topology
        # classification) and boot epoch (the session-rid incarnation
        # stamp keying our SeqPush stream in the peer's applied vector)
        conn.send_raw(
            self._wire(
                self._serial
                + codec.encode_hello(self._addr, self._region, self._epoch)
            )
        )
        await self._read_loop(conn, reader, active=True)

    def _active_missed(self, addr: Address) -> None:
        """Connect failure: drop the placeholder and back the address
        off — it stays known, and is re-dialed once the backoff window
        passes (or immediately after inbound contact from it)."""
        self._actives.pop(addr, None)
        self._stats["dial_fails"] += 1
        self._reg.trace_event("cluster", "dial_fail", "", str(addr))
        st = self._peers.get(addr)
        if st is None:
            st = self._peers[addr] = _PeerState()
        st.fails += 1
        st.next_dial_tick = self._tick + self._backoff_ticks(addr, st.fails)

    def _backoff_ticks(self, addr: Address, fails: int) -> int:
        """Exponential backoff in heartbeat ticks, capped, with a
        deterministic jitter (a function of BOTH endpoints and the
        failure count, not of a PRNG: drills replay identically) of up
        to half the backoff. Mixing in our own identity de-phases the
        dialers: were the jitter a function of the target alone, every
        node of a restarting mesh would compute the same offsets and
        re-dial the recovering peer in lockstep."""
        base = min(1 << min(fails - 1, 30), self._backoff_cap)
        jitter = (self._addr.hash64() ^ addr.hash64() ^ fails) % (base // 2 + 1)
        return base + jitter

    def _inbound_contact(self, addr: Address) -> None:
        """The v5 handshake told us `addr` just dialed US: that address
        is alive, so any dial backoff against it is stale — reset it and
        let the next heartbeat re-dial immediately (a rebooted peer
        re-meshes in one tick instead of waiting out the cap)."""
        st = self._peers.get(addr)
        if st is not None and (st.fails or st.next_dial_tick > self._tick):
            st.fails = 0
            st.next_dial_tick = 0

    # ---- passive (inbound) connections -------------------------------------

    async def _accept(self, reader, writer) -> None:
        if self._disposed:
            writer.close()
            return
        conn = _Conn(writer=writer, active_addr=None)
        self._passives.add(conn)
        self._mark_activity(conn)  # a never-handshaking conn must still age out
        await self._read_loop(conn, reader, active=False)

    # ---- shared read loop with handshake -----------------------------------

    # before the handshake the only legal frame is the 32-byte signature;
    # a tiny cap stops unauthenticated clients buffering big bodies
    PRE_HANDSHAKE_MAX_FRAME = 1024

    async def _read_loop(self, conn: _Conn, reader, active: bool) -> None:
        frames = FrameReader(max_frame=self.PRE_HANDSHAKE_MAX_FRAME)
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                # cluster.read: error -> the ConnectionError path below;
                # drop -> this chunk is lost (mid-frame loss desyncs the
                # stream into a framing/codec drop, boundary loss loses
                # whole messages — both heal through redial + sync)
                data = await faults.async_point("cluster.read", data)
                if data is None:
                    continue
                frames.append(data)
                for raw in frames:
                    # cluster.decode (frame-decode): the failpoint fires
                    # on the RAW frame, BEFORE the CRC check — injected
                    # corruption is therefore detected exactly like real
                    # wire/memory corruption would be, and can never
                    # forge lattice state. drop -> one whole message
                    # silently lost.
                    raw = await faults.async_point("cluster.decode", raw)
                    if raw is None:
                        continue
                    checked = check_frame(raw)
                    if checked is None:
                        self._log.err() and self._log.e(
                            "cluster frame CRC mismatch"
                        )
                        self._drop(conn, Drop.CRC)
                        return
                    origin_ms, body = checked
                    if not conn.established:
                        if not self._handshake(conn, body, active):
                            return
                        frames.set_max_frame(1 << 30)  # authenticated peer
                        continue
                    self._mark_activity(conn)
                    self._note_seen(conn)  # bridge-election liveness
                    try:
                        with self._reg.span("decode.frame", len(body)):
                            msg = codec.decode(body)
                    except codec.CodecError as e:
                        self._log.err() and self._log.e(f"cluster codec error: {e}")
                        self._drop(conn, Drop.CODEC)
                        return
                    conn.holding = True
                    try:
                        if active:
                            await self._active_msg(
                                conn, msg, origin_ms, nbytes=len(body)
                            )
                        else:
                            await self._passive_msg(conn, msg, origin_ms)
                    finally:
                        conn.holding = False
        except (ConnectionError, asyncio.CancelledError, FramingError):
            pass
        finally:
            self._drop(conn, Drop.EOF)

    def _handshake(self, conn: _Conn, body: bytes, active: bool) -> bool:
        """First frame on a connection: the 32-byte schema signature,
        plus (from the DIALING side only, schema v5) the dialer's
        advertised address. False -> the conn was dropped."""
        sig_len = len(self._serial)
        if body[:sig_len] != self._serial:
            # wrong schema -> auth failure
            self._log.warn() and self._log.w(
                "cluster handshake signature mismatch"
            )
            self._drop(conn, Drop.HANDSHAKE)
            return False
        extra = body[sig_len:]
        if active:
            # the passive echo (v10) carries the peer's region + epoch;
            # we know who we dialed, so a successful handshake resets
            # the backoff
            try:
                conn.peer_region, conn.peer_epoch = codec.decode_echo(extra)
            except codec.CodecError:
                self._drop(conn, Drop.HANDSHAKE)
                return False
            self._fold_regions(
                ((str(conn.active_addr), conn.peer_region,
                  conn.peer_epoch),)
            )
            st = self._peers.get(conn.active_addr)
            if st is not None:
                st.fails = 0
                st.next_dial_tick = 0
        else:
            if extra:
                try:
                    conn.peer_addr, conn.peer_region, conn.peer_epoch = (
                        codec.decode_hello(extra)
                    )
                except codec.CodecError:
                    self._drop(conn, Drop.HANDSHAKE)
                    return False
                # the sender's session rid: every sequenced batch this
                # conn delivers advances the applied vector under it
                conn.peer_srid = sessions_mod.make_rid(
                    str(conn.peer_addr), conn.peer_epoch
                )
                self._fold_regions(
                    ((str(conn.peer_addr), conn.peer_region,
                      conn.peer_epoch),)
                )
                self._inbound_contact(conn.peer_addr)
        conn.established = True
        self._mark_activity(conn)
        self._note_seen(conn)  # the handshake frame is liveness evidence
        if active:
            if not self._should_peer(conn.active_addr):
                # the echo just taught us this peer is out of the sparse
                # topology (an out-of-region non-bridge): prune now
                # rather than carry a WAN conn policy forbids
                self._stats["region_prunes"] += 1
                self._drop(conn, Drop.REGION)
                return False
            # we initiated: gossip our region map FIRST (the receiver
            # must classify addresses BEFORE the exchange below makes
            # it dial them — region gossip riding only the announce
            # cadence left a window where a rebooting single-node
            # region's bridge re-dialed the whole cluster: the
            # dial-storm fix), announce our membership view, replay the
            # peer's unacked delta window (the blip-sized heal: exactly
            # the missed batches, schema v8), then ask for missed state
            # the other way (deltas pushed to us while we were down are
            # not replayable by anyone — the digest request covers them)
            if any(r for r, _ in self._regions.values()):
                self._send(conn, MsgRegionGossip(self._region_entries()))
            self._send(conn, MsgExchangeAddrs(self._known_addrs.copy()))
            self._retransmit_unacked(conn)
            self._maybe_request_sync(conn)
        else:
            # passive side echoes the signature + its region/epoch back
            conn.send_raw(
                self._wire(
                    self._serial
                    + codec.encode_echo(self._region, self._epoch)
                )
            )
        return True

    # ---- message handling --------------------------------------------------

    def _peer_key(self, conn: _Conn) -> str:
        """Stable per-peer identity for the lag gauge: the dialed
        address (actives) or the v5 handshake's advertised address
        (passives)."""
        if conn.active_addr is not None:
            return str(conn.active_addr)
        if conn.peer_addr is not None:
            return str(conn.peer_addr)
        return "unknown"

    def _record_push_lag(self, conn: _Conn, origin_ms: int) -> None:
        """Push→apply convergence lag: the frame's v6 origin stamp vs
        NOW (the converge just completed). origin 0 = unstamped sender
        (should not happen post-v6, but records nothing rather than a
        50-year lag)."""
        if origin_ms and self._reg.enabled:
            self._note_lag(
                self._peer_key(conn), max(self._clock.now_ms() - origin_ms, 0)
            )

    def _consume_rtt_stamp(self, conn: _Conn, unmatched_reason: str) -> None:
        """Close one cluster.rtt sample: a reply (Pong or DeltaAck) pops
        the oldest outstanding stamped send on its conn. The FIFO match
        is exact because replies are generated in receive order per conn
        and only stamped sends solicit them. Pop unconditionally; the
        enabled switch gates only the record, so a mid-conn toggle can
        never strand stamps and shift later matches. A reply with
        nothing outstanding is a DECLARED drop (an out-of-envelope peer
        a silent ignore would hide forever)."""
        if conn.pong_sent:
            dt = self._clock.perf() - conn.pong_sent.popleft()
            if self._reg.enabled and self._obs_primary:
                self._h_rtt.record(dt)
        else:
            self._drop_msg(conn, unmatched_reason)

    async def _active_msg(
        self, conn: _Conn, msg, origin_ms: int = 0, nbytes: int = 0
    ) -> None:
        if isinstance(msg, MsgDeltaAck):
            # the push path's reply (schema v8): fold the cumulative
            # watermark into the peer's interval state, then consume the
            # rtt stamp exactly like a Pong (acks answer stamped
            # SeqPush/retransmit sends in FIFO order on this conn)
            st = self._peers.get(conn.active_addr)
            if msg.cum > self._delta_seq:
                # the receiver's contiguity cursor outruns our counter:
                # it tracked a PREVIOUS incarnation of this address (we
                # crash-rebooted and restarted at seq 0). Re-base it
                # down — otherwise our new stream looks like duplicates
                # to its ack bookkeeping forever and reconnect replay
                # silently no-ops (data still heals via the periodic
                # digest sync, but the interval tier would be dead)
                if st is not None:
                    self._send_reset(conn, st)
            elif st is not None and (st.acked is None or msg.cum > st.acked):
                st.acked = msg.cum
            self._consume_rtt_stamp(conn, MsgDrop.ACK_UNMATCHED)
            return
        if isinstance(msg, MsgDigestTree):
            # sync response, range tier: the responder's keyspace-range
            # digest tree for one mismatched type. Compare against our
            # own tree (repo lock — a task, never the read loop) and
            # start the budgeted range walk.
            self._stats["sync_bytes_recv"] += nbytes
            task = asyncio.get_running_loop().create_task(
                self._handle_tree(conn, msg)
            )
            self._flush_tasks.add(task)
            task.add_done_callback(self._flush_task_done)
            return
        if isinstance(msg, MsgPong):
            # heartbeat-send → Pong round-trip (cluster.rtt): matched
            # against the oldest outstanding Pong-soliciting send. The
            # FIFO match is exact because Pongs answer ONLY stamped
            # push/announce sends, in order — sync replies are
            # MsgSyncDone, never Pong.
            self._consume_rtt_stamp(conn, MsgDrop.PONG_UNMATCHED)
            return  # liveness only
        if isinstance(msg, MsgSyncDone):
            # sync reply closing our request or one range round: no data
            # needed (deferred / digest-matched / end-of-stream).
            # Counted so the requester side of the sync conversation is
            # observable, not a silent ignore — then the range walk
            # continues if divergent buckets remain (each SyncDone
            # closes one budgeted round). A non-empty svec is the
            # responder's digest-match proof (v10): byte-equal state
            # means every write its vector covers is in ours — adopt.
            self._stats["sync_done_recv"] += 1
            if msg.svec and self._sessions is not None:
                self._sessions.adopt(dict(msg.svec))
            conn.range_inflight = False
            self._continue_ranges(conn)
            return
        if isinstance(msg, MsgRegionGossip):
            # the establishment-time gossip reply: the passive
            # side teaches the dialer its region map BEFORE the address
            # exchange, so a rebooting node classifies every address
            # it is about to learn — fold, same as the passive branch
            self._fold_regions(msg.regions)
            return
        if isinstance(msg, MsgExchangeAddrs):
            self._converge_addrs(msg.known_addrs)
            return
        if isinstance(msg, MsgPushDeltas):
            # range-scoped (or legacy full-state) sync data answering
            # our MsgSyncRequest / MsgRangeRequest: converge like any
            # push — the join is idempotent, so overlap with live
            # deltas is harmless. Unsequenced, so it advances no
            # session watermark (the digest-match adoption is the sync
            # path's session heal); the lane bridge still relays it
            # (origin None) so siblings converge within the proactive
            # cadence instead of a bus sync period.
            self._sync_rx_tick = self._tick  # mid-heal: defer serving dumps
            self._stats["sync_bytes_recv"] += nbytes
            await self._database.converge_async(msg.name, list(msg.batch))
            self._record_push_lag(conn, origin_ms)
            if self.on_push is not None:
                self.on_push(None, 0, msg.name, list(msg.batch))
            # cross-bridge repair relay: a region bridge that
            # just converged sync/repair data pulled ACROSS the WAN
            # re-exports it into its intra-region mesh through the
            # byte-capped relay queue — a rejoining region heals its
            # members through its bridge instead of waiting for each
            # member's coincidental periodic sync toward it
            if self._region and self._is_bridge():
                src = self._regions.get(
                    str(conn.active_addr), ("", 0)
                )[0]
                if src and src != self._region:
                    self._queue_repair_relay(
                        msg.name, msg.batch, max(nbytes, 1)
                    )
            return
        self._log.err() and self._log.e(
            f"unexpected active message: {type(msg).__name__}"
        )
        self._drop(conn, Drop.UNEXPECTED)

    async def _passive_msg(self, conn: _Conn, msg, origin_ms: int = 0) -> None:
        if isinstance(msg, MsgPong):
            # we never send Pong-soliciting frames on a passive conn, so
            # no Pong can legitimately arrive here: declared drop (the
            # frame, not the conn — one stray message is not a protocol
            # violation worth a teardown + redial churn)
            self._drop_msg(conn, MsgDrop.PONG_UNSOLICITED)
            return
        if isinstance(msg, MsgSyncDone):
            # sync replies close requests WE made, which only go out on
            # active conns — same declared-drop policy as the stray Pong
            self._drop_msg(conn, MsgDrop.SYNC_DONE_UNSOLICITED)
            return
        if isinstance(msg, MsgExchangeAddrs):
            # full sync: converge then reply with our own set — region
            # gossip FIRST, so the dialer classifies every address the
            # exchange teaches it before its policy pass dials them
            # (the establishment-time half of the dial-storm fix)
            self._converge_addrs(msg.known_addrs)
            if any(r for r, _ in self._regions.values()):
                self._send(conn, MsgRegionGossip(self._region_entries()))
            self._send(conn, MsgExchangeAddrs(self._known_addrs.copy()))
            return
        if isinstance(msg, MsgSeqPush):
            # the schema-v8 live delta path: track the sender's batch
            # sequence (contiguity cursor + bounded out-of-order park)
            # and ack the cumulative watermark FIRST — the ack is the
            # liveness signal (the v8 Pong of the push path), and a
            # large batch's converge must not delay it past the peer's
            # idle-eviction window. The awaited converge still paces
            # this connection, so backpressure and per-connection
            # ordering are unchanged. Duplicates (retransmit overlap)
            # converge harmlessly — the join is idempotent — and just
            # re-state the ack.
            self._send(conn, MsgDeltaAck(self._track_seq(conn, msg.seq)))
            await self._database.converge_async(msg.name, list(msg.batch))
            self._record_push_lag(conn, origin_ms)
            # session watermark AFTER the converge completes (a waiter
            # woken in between would serve a read the data has not
            # reached), then the bridge re-export for first-sight
            # content — the sender IS the origin on the direct path.
            # The note rides the OWN-CONTENT ordinal (msg.oseq), never
            # the transport seq: a bridge's relay frames consume
            # transport seqs that downstream receivers can never
            # observe under this rid, so transport-keyed watermarks
            # would park forever one relay hop out (review find).
            if msg.span:
                self._fold_span(msg.span)
            fresh = self._note_session(conn.peer_srid, msg.oseq)
            await self._relay_fresh(
                fresh, conn.peer_srid, msg.oseq, msg.name, msg.batch,
                msg.span,
            )
            return
        if isinstance(msg, MsgRelayPush):
            # the v10 origin-preserving relay: transport-wise exactly a
            # SeqPush from this conn's sender (acked, interval-tracked,
            # retransmittable), but the session watermark advances for
            # the ORIGIN incarnation carried in the message — which is
            # what lets a token minted in another region (or on another
            # lane) verify here
            self._stats["relays_recv"] += 1
            self._send(conn, MsgDeltaAck(self._track_seq(conn, msg.seq)))
            await self._database.converge_async(msg.name, list(msg.batch))
            self._record_push_lag(conn, origin_ms)
            if msg.span:
                self._fold_span(msg.span)
            fresh = self._note_session(msg.origin, msg.oseq)
            await self._relay_fresh(
                fresh, msg.origin, msg.oseq, msg.name, msg.batch,
                msg.span,
            )
            return
        if isinstance(msg, MsgRegionGossip):
            # region membership gossip (v10): fold and let the next
            # heartbeat's policy pass act on it (prune / dial)
            self._fold_regions(msg.regions)
            return
        if isinstance(msg, MsgIntervalReset):
            # the sender's retransmit window lost our gap: re-base our
            # contiguity cursor, drop the parked out-of-order seqs, and
            # demote this peering to range repair — force a digest-tree
            # sync toward the sender (the ladder's middle rung; the data
            # the interval machinery lost arrives as divergent ranges)
            self._stats["interval_resets_recv"] += 1
            skey = self._peer_key(conn)
            self._recv_cum[skey] = msg.seq
            self._recv_ooo.pop(skey, None)
            self._reg.trace_event(
                "cluster", "interval_reset", "recv", self._conn_desc(conn)
            )
            self._force_range_repair(conn.peer_addr)
            return
        if isinstance(msg, MsgRangeRequest):
            # range tier serve: queue the requested buckets for the
            # single range-serve task (FIFO across requesters, one
            # backpressured stream at a time). A request larger than our
            # own budget is split into budget-sized sub-rounds — NOT
            # truncated: a requester with a bigger --range-budget than
            # ours deletes the whole request from its pending cursor the
            # moment it sends, so any bucket we dropped here would stay
            # divergent until the next periodic digest exchange. Only
            # the last sub-round carries the closing MsgSyncDone (one
            # request, one SyncDone), and the FIFO interleaves other
            # requesters' rounds between our slices.
            if msg.name not in self._database.DATA_TYPES:
                # a type this build does not serve: protocol violation
                # (the handshake pinned the schema, so both ends know
                # the same name set)
                self._drop(conn, Drop.UNEXPECTED)
                return
            buckets = list(msg.buckets)
            self._stats["ranges_served"] += len(buckets)
            step = max(self._range_budget, 1)
            chunks = [
                buckets[i : i + step] for i in range(0, len(buckets), step)
            ] or [[]]  # an EMPTY request is legal: zero frames + SyncDone
            for i, chunk in enumerate(chunks):
                self._range_queue.append(
                    (conn, msg.name, tuple(chunk), i == len(chunks) - 1)
                )
            if not self._range_serve_inflight:
                self._range_serve_inflight = True
                task = asyncio.get_running_loop().create_task(
                    self._serve_ranges()
                )
                self._flush_tasks.add(task)
                task.add_done_callback(self._flush_task_done)
            return
        if isinstance(msg, MsgPushDeltas):
            # Pong FIRST: the pong is a liveness signal, and a large
            # batch's converge (or waiting out a repo lock held by a
            # digest pass) can exceed the peer's idle-eviction window —
            # acknowledging receipt must not wait on lattice work. The
            # awaited converge still paces this connection (the next
            # frame is not read until it finishes), so peer backpressure
            # and per-connection delta ordering are unchanged. Post-v8
            # this branch carries only content-free keepalives (live
            # data rides MsgSeqPush), but any joinable payload still
            # converges — dup delivery across the schema seam is safe.
            self._send(conn, MsgPong())
            await self._database.converge_async(msg.name, list(msg.batch))
            self._record_push_lag(conn, origin_ms)
            if self.on_push is not None:
                self.on_push(None, 0, msg.name, list(msg.batch))
            return
        if isinstance(msg, MsgAnnounceAddrs):
            self._converge_addrs(msg.known_addrs)
            self._send(conn, MsgPong())
            return
        if isinstance(msg, MsgSyncRequest):
            # serve as a TASK: the dump can take seconds (repo locks +
            # device drains + cold compiles), and blocking this read loop
            # would stop activity-marking AND Pong replies on the conn
            # pair — both sides would idle-evict before the state arrives.
            # Concurrent requesters queue and share ONE dump (a heal can
            # bring several rejoiners at once; each must get the state).
            # Repeat requests on a long-lived conn (the periodic digest
            # exchange) serve again, at most once per period per conn.
            # A node that is ITSELF mid-heal defers with a Pong: its
            # state is about to change anyway, and dumping it would
            # contend the same repo locks the inbound heal needs.
            # The mid-heal defer streak is CAPPED like the requester-side
            # write-hot defer: with cluster-wide aligned heartbeats, an
            # ahead node's own periodic pull makes the behind peer stream
            # its (stale) dump right before the behind peer's request
            # arrives — an uncapped defer then starves the rejoiner
            # FOREVER (each period repeats the same alignment). The
            # streak is PER REQUESTER (on _Conn, beside sync_served_tick):
            # a global streak would let the serve slot land repeatedly on
            # the same peer of several concurrently rejoining in stable
            # order. It decays only when the conn's last REFUSAL is much
            # older than a period: a per-rx-episode reset would hand each
            # aligned period a fresh defer allowance and reintroduce the
            # starvation, while never decaying would let a stale streak
            # from a long-dead episode skip the defers of the next one.
            rate_limited = (
                conn.sync_served_tick is not None
                and self._tick - conn.sync_served_tick < SYNC_PERIOD_TICKS
            )
            mid_heal = (
                self._sync_rx_tick is not None
                and self._tick - self._sync_rx_tick < SYNC_REQUEST_COOLDOWN
            )
            if (
                conn.sync_defer_last_tick is not None
                and self._tick - conn.sync_defer_last_tick
                > 6 * SYNC_PERIOD_TICKS
            ):
                # stale streak from a long-dead heal episode. The decay
                # window must EXCEED the slowest capped requester's pull
                # spacing — a write-hot requester pulls every 4th period
                # (heartbeat defer streak < 3) — or its refusals each
                # look stale, decay resets the streak between them, and
                # the cap never binds for exactly the starved node it
                # protects.
                conn.sync_defer_streak = 0
            if (
                self._sync_defer_total_tick is not None
                and self._tick - self._sync_defer_total_tick
                > 6 * SYNC_PERIOD_TICKS
            ):
                self._sync_serve_defer_total = 0  # same decay, aggregate
                # the old defer episode is dead with its streaks: a
                # fresh defer below starts a fresh backlog clock rather
                # than inheriting a long-gone requester's wait
                self._defer_since_ms = None
            # a defer needs BOTH allowances: the per-conn streak (< 2,
            # the fairness cap) and the aggregate consecutive-defer
            # count (< 6 — a churning requester presents a fresh conn
            # each period, so only an any-conn cap bounds ITS chain)
            defer = (
                mid_heal
                and conn.sync_defer_streak < 2
                and self._sync_serve_defer_total < 6
            )
            if rate_limited or defer:
                if defer and not rate_limited:
                    conn.sync_defer_streak += 1
                    conn.sync_defer_last_tick = self._tick
                    self._sync_serve_defer_total += 1
                    self._sync_defer_total_tick = self._tick
                    self._stats["sync_deferred"] += 1
                    if self._defer_since_ms is None:
                        # the backlog gauge's defer clock: how long
                        # rejoiners have been waiting on this node
                        self._defer_since_ms = self._clock.now_ms()
                    self._log.info() and self._log.i(
                        "sync: mid-heal, deferring dump "
                        f"(streak {conn.sync_defer_streak}, "
                        f"total {self._sync_serve_defer_total})"
                    )
                self._send(conn, MsgSyncDone())
                return
            conn.sync_defer_streak = 0
            self._sync_serve_defer_total = 0
            self._defer_since_ms = None  # serving again: backlog clock off
            conn.sync_served_tick = self._tick
            self._stats["sync_served"] += 1
            conn.sync_digests = tuple(msg.digests)
            conn.sync_svec = tuple(msg.svec)
            self._sync_waiters.append(conn)
            if self._sync_dump_inflight:
                return  # the running dump task will serve this waiter too
            self._sync_dump_inflight = True
            task = asyncio.get_running_loop().create_task(self._serve_syncs())
            self._flush_tasks.add(task)
            task.add_done_callback(self._flush_task_done)
            return
        self._log.err() and self._log.e(
            f"unexpected passive message: {type(msg).__name__}"
        )
        self._drop(conn, Drop.UNEXPECTED)

    # ---- delta-interval receiver state (schema v8) -------------------------

    def _track_seq(self, conn: _Conn, seq: int) -> int:
        """Advance one sender's contiguity cursor for a received
        MsgSeqPush; returns the cumulative watermark to ack. First
        contact baselines at the observed seq (earlier history arrives
        through the bootstrap tree sync, not through the interval
        machinery); a gap parks the seq in the bounded out-of-order set
        until retransmit fills it; ooo overflow declares the interval
        relationship lost and self-demotes to range repair."""
        skey = self._peer_key(conn)
        cum = self._recv_cum.get(skey)
        if cum is None:
            self._recv_cum[skey] = seq
            return seq
        if seq == cum + 1:
            cum += 1
            ooo = self._recv_ooo.get(skey)
            if ooo:
                while cum + 1 in ooo:
                    cum += 1
                    ooo.discard(cum)
                if not ooo:
                    del self._recv_ooo[skey]
            self._recv_cum[skey] = cum
        elif seq > cum + 1:
            ooo = self._recv_ooo.setdefault(skey, set())
            ooo.add(seq)
            if len(ooo) > RECV_OOO_CAP:
                # the gap is not getting filled: rebase past it and pull
                # the divergence as ranges instead of holding seqs
                # forever (ladder: interval -> range, never unbounded)
                self._recv_cum[skey] = max(ooo)
                del self._recv_ooo[skey]
                self._reg.trace_event(
                    "cluster", "interval_overflow", "", skey
                )
                self._force_range_repair(conn.peer_addr)
        # seq <= cum: retransmit duplicate — cursor unchanged
        return self._recv_cum[skey]

    def _force_range_repair(self, addr: Address | None) -> None:
        """Clear the sync-request cooldown toward one peer and request
        immediately if its active conn is up: the receiver-side entry
        into range repair (driven by MsgIntervalReset / ooo overflow,
        where waiting out the periodic cadence would stretch a known
        divergence window for no reason)."""
        if addr is None:
            return
        self._sync_req_tick.pop(addr, None)
        conn = self._actives.get(addr)
        if conn is not None and conn.established:
            self._maybe_request_sync(conn)

    # ---- sessions (schema v10) ---------------------------------------------

    def _note_session(self, origin: str | None, seq: int) -> bool:
        """Advance the node's applied-interval vector for one CONVERGED
        sequenced batch of ``origin``'s stream; True when it was
        first-sight (the bridge relay predicate). A conn whose
        handshake carried no identity tracks nothing — safe: the vector
        under-approximates and reads go STALE, never stale-served."""
        if self._sessions is None or not origin:
            return False
        return self._sessions.note_applied(origin, seq)

    # ---- provenance spans (schema v11) -------------------------------------

    def _fold_span(self, span: bytes) -> None:
        """Fold one arrived provenance chain into the registry's span
        stats, stamped with THIS replica's apply hop. Called after the
        converge completes (the chain measures applied, not received).
        A malformed span counts and is dropped — it rides inside the
        CRC-covered frame, so garbage here means a peer bug, and the
        frame's deltas have already converged regardless. Every lane
        folds into the shared registry (SpanStats is locked), so the
        node-level SLO covers all lanes without aggregator math."""
        if not self._reg.enabled:
            return
        worst = self._reg.spans.ingest(
            span, self._srid, self._region, self._clock.now_ms()
        )
        if worst is not None:
            self._reg.trace_event("jtrace", "worst_span", "", worst)

    async def _relay_fresh(
        self, fresh: bool, origin: str | None, oseq: int, name: str, batch,
        span: bytes = b"",
    ) -> None:
        """Bridge re-export of one first-sight sequenced batch. Lane
        bridge: the on_push hook hands it to the sibling mesh instance.
        Region bridge: this instance re-broadcasts it into its own
        conns (intra peers + other regions' bridges; receivers' own
        first-sight checks stop echo loops). The dedup is BEST-EFFORT
        at-most-once: a seq evicted from the bounded park (PARK_CAP
        overflow) reads as first-sight again if redelivered, costing a
        redundant relay — never a correctness problem (joins are
        idempotent), and retransmit overlap in the common case costs
        no WAN traffic. Broadcasting to ALL actives (intra dups
        included) is deliberate: subset sends would punch seq gaps in
        this sender's stream at the skipped receivers, churning the
        interval machinery and stalling session watermarks — the
        amplification tradeoff is documented in operations.md."""
        if not fresh or not origin:
            return
        relay_lane = self.on_push is not None
        relay_region = bool(self._region) and self._is_bridge()
        if not (relay_lane or relay_region):
            return
        try:
            # cluster.relay: the WAN seam. sleep injects inter-region
            # RTT (pacing this conn like real WAN backpressure — the
            # wan-converge bench's knob); drop/error lose the relay,
            # healed by the periodic digest sync.
            await faults.async_point("cluster.relay")
        except faults.FaultError:
            return
        if relay_lane:
            self.on_push(origin, oseq, name, list(batch), span)
        if relay_region:
            self.relay_deltas(origin, oseq, (name, list(batch)), span)

    async def flush_now(self) -> None:
        """Token minting's flush barrier (sessions.SessionIndex.bind):
        drain the pending local deltas through the same sink the
        heartbeat uses, awaited — every prior local write is sequenced
        (and note_local'd) before SESSION TOKEN reads the vector, so
        the minted token provably covers the client's writes."""
        await self._database.flush_deltas_async(
            self.flush_sink or self.broadcast_deltas
        )

    def _session_svec(self) -> tuple:
        """The vector as sorted wire pairs — snapshotted BEFORE the sync
        digests it travels with are computed, so it never claims more
        than the digested state holds."""
        if self._sessions is None:
            return ()
        return tuple(sorted(self._sessions.vector().items()))

    # ---- bootstrap / rejoin full-state sync --------------------------------

    def _maybe_request_sync(self, conn: _Conn) -> None:
        """Ask a freshly-established peer for its full state, rate-limited
        per address. Covers both bootstrap (new node joins, gets
        everything) and partition heal (deltas pushed while we were
        unreachable are not retransmitted; the reference loses them
        permanently — cluster.pony:250-252 converges only what arrives).
        The request carries OUR data digest, so an up-to-date peer
        answers with a SyncDone instead of re-shipping everything."""
        addr = conn.active_addr
        last = self._sync_req_tick.get(addr)
        if last is not None and self._tick - last < SYNC_REQUEST_COOLDOWN:
            return
        if addr in self._sync_req_inflight:
            # connection churn within one digest computation must not
            # spawn concurrent passes (each takes every repo lock)
            return
        self._sync_req_inflight.add(addr)
        task = asyncio.get_running_loop().create_task(self._request_sync(conn))
        self._flush_tasks.add(task)
        task.add_done_callback(self._flush_task_done)

    async def _request_sync(self, conn: _Conn) -> None:
        try:
            # session vector BEFORE the digests (v10): the responder
            # adopts it only on a digest match, and the proof argument
            # needs vector <= digested state
            svec = self._session_svec()
            # O(keys-written-since-last-pass): the incremental digests
            # never dump the keyspace to produce these 5 x 32 bytes
            digests = await self._database.sync_type_digests_async()
            # record the cooldown only once the request is really on the
            # wire — a conn that died in between must not suppress the
            # retry on the re-established connection
            if conn.writer is None or conn.writer.transport.is_closing():
                return
            self._log.info() and self._log.i(
                f"sync: requesting state from {conn.active_addr}"
            )
            self._send(conn, MsgSyncRequest(digests, svec))
            self._sync_req_tick[conn.active_addr] = self._tick
        finally:
            self._sync_req_inflight.discard(conn.active_addr)

    async def _chunk_frames(self, name: str, batch):
        """Async generator over one batch's bounded sync frames: each
        frame is encoded off the loop just before it yields — the
        responder never materialises the whole encoded batch (round-5
        verdict item 3). Frames are bounded both by key count
        (SYNC_CHUNK_KEYS) and by encoded size (SYNC_CHUNK_BYTES: an
        oversized chunk re-splits by key down to single-key frames)."""
        if name == "TLOG":
            # equal-timestamp entries order by interner-local ids on
            # device, which differ across nodes; ship ties by value
            # (converge is order-insensitive, so any order is legal)
            batch = [
                (key, (sorted(entries, key=lambda e: (e[1], e[0])), cutoff))
                for key, (entries, cutoff) in batch
            ]
        batch = tuple(batch)
        stack = [
            batch[i : i + SYNC_CHUNK_KEYS]
            for i in range(0, len(batch), SYNC_CHUNK_KEYS)
        ] or [()]
        stack.reverse()  # key order on the wire (cosmetic)
        while stack:
            chunk = stack.pop()
            data = await asyncio.to_thread(
                codec.encode, MsgPushDeltas(name, chunk)
            )
            if len(data) > SYNC_CHUNK_BYTES and len(chunk) > 1:
                mid = len(chunk) // 2
                stack.append(chunk[mid:])
                stack.append(chunk[:mid])
                continue
            yield self._wire(data)

    async def _data_frames(self, name: str):
        """One type's WHOLE-state sync frames: the legacy-shape fallback
        (a requester whose digest vector we cannot interpret — the
        degradation ladder's last rung). The dump happens under its repo
        lock with device touches threaded; chunking via _chunk_frames."""
        dump = await self._database.dump_state_async(names=(name,))
        async for fr in self._chunk_frames(name, dump[0][1] if dump else []):
            yield fr

    async def _range_frames(self, name: str, buckets):
        """One type's state RESTRICTED to the requested digest-tree
        buckets, as bounded sync frames: bytes proportional to the
        divergence the requester measured, never to the keyspace."""
        batch = await self._database.dump_range_async(name, buckets)
        async for fr in self._chunk_frames(name, batch):
            yield fr

    async def _serve_ranges(self) -> None:
        """Drain the range-request queue: ONE backpressured stream at a
        time (writer.drain between frames), FIFO across requesters —
        the server side of the per-peer repair budget. Each request is
        closed with MsgSyncDone, which is the requester's cue to pull
        its next budgeted bucket round (an over-budget request streams
        as several queue entries; only the last is ``done``)."""
        try:
            while self._range_queue:
                conn, name, buckets, done = self._range_queue.pop(0)
                if conn.writer is None or conn.writer.transport.is_closing():
                    continue
                self._log.info() and self._log.i(
                    f"sync: serving {len(buckets)} {name} range(s)"
                )
                ok = True
                async for fr in self._range_frames(name, buckets):
                    try:
                        # sync.range: drop -> this range frame is lost
                        # (the requester's next tree compare re-pulls
                        # the bucket); error -> conn drop + redial heal
                        fr = await faults.async_point("sync.range", fr)
                    except faults.FaultError:
                        self._drop(conn, Drop.WRITE_FAILED)
                        ok = False
                        break
                    if fr is None:
                        continue
                    if not await self._send_frame(conn, fr):
                        ok = False
                        break
                if ok and done:
                    self._send(conn, MsgSyncDone())
        finally:
            self._range_serve_inflight = False

    async def _handle_tree(self, conn: _Conn, msg: MsgDigestTree) -> None:
        """Requester side of the range tier: diff the responder's
        digest-tree leaves against our own and start the budgeted walk
        of divergent buckets. Runs as a task (our tree takes the repo
        lock). Buckets where we hold keys the responder lacks also
        mismatch — requesting them is harmless (the responder serves
        what it has; our surplus flows to it when IT pulls)."""
        if msg.name not in self._database.DATA_TYPES:
            self._drop(conn, Drop.UNEXPECTED)
            return
        mine = dict(await self._database.sync_tree_async(msg.name))
        theirs = dict(msg.leaves)
        divergent = sorted(
            b
            for b in set(mine) | set(theirs)
            if mine.get(b) != theirs.get(b)
        )
        if not divergent:
            return  # leaf-equal: root mismatch was healed in flight
        if conn.writer is None or conn.writer.transport.is_closing():
            return
        self._log.info() and self._log.i(
            f"sync: {len(divergent)} divergent {msg.name} range(s), "
            f"walking {self._range_budget} per round"
        )
        conn.range_pending[msg.name] = divergent
        self._continue_ranges(conn)

    def _continue_ranges(self, conn: _Conn) -> None:
        """Pull the next budgeted round of divergent buckets, one
        outstanding MsgRangeRequest per conn (each MsgSyncDone clears
        the in-flight flag and re-enters here; concurrent entries —
        several mismatched types' tree tasks finishing together — see
        the flag and yield to the round already in flight). No-op once
        the walk is done — the next periodic digest exchange is the
        convergence check."""
        if conn.range_inflight:
            return
        for name in list(conn.range_pending):
            pending = conn.range_pending[name]
            if not pending:
                del conn.range_pending[name]
                continue
            chunk = pending[: self._range_budget]
            del pending[: self._range_budget]
            if not pending:
                del conn.range_pending[name]
            self._stats["ranges_requested"] += len(chunk)
            conn.range_inflight = True
            self._send(conn, MsgRangeRequest(name, tuple(chunk)))
            return

    async def _system_frames(self) -> list[bytes]:
        """The SYSTEM log as sync frames, dumped fresh (it is tiny —
        trimmed to ~200 entries — and deliberately outside the digest, so
        a digest-matched peer still recovers log lines it missed)."""
        dump = await self._database.dump_state_async(names=("SYSTEM",))
        return [
            self._wire(codec.encode(MsgPushDeltas(name, tuple(batch))))
            for name, batch in dump
        ]

    async def _serve_syncs(self) -> None:
        """Drain the sync-waiter queue (schema v8: the range tier). A
        requester whose digests all match ours gets the (tiny) SYSTEM
        frames and a SyncDone — zero data frames, zero-lag proof. A
        requester with MISMATCHED types gets one ~8 KB MsgDigestTree per
        mismatched type instead of a keyspace dump: it compares leaves
        and pulls only divergent buckets (MsgRangeRequest), so rejoin
        bytes scale with divergence. Only a requester whose digest
        vector shape we cannot interpret falls through to the legacy
        whole-state dump — the degradation ladder's last rung, counted
        in sync_full_dumps (the churn soak pins it at zero)."""
        try:
            while self._sync_waiters:
                waiters, self._sync_waiters = self._sync_waiters, []
                svec_snap = self._session_svec()  # before the digests
                mine = await self._database.sync_type_digests_async()
                types = self._database.DATA_TYPES
                sys_frames = await self._system_frames()
                dump_all: list[_Conn] = []
                for conn in waiters:
                    theirs = conn.sync_digests
                    if len(theirs) != len(types):
                        dump_all.append(conn)  # unknown digest shape
                        continue
                    miss = [
                        n for n, a, b in zip(types, mine, theirs) if a != b
                    ]
                    if not miss:
                        # replicated observability (SYSTEM GETLOG): an
                        # in-sync rejoin is provably zero-cost. The
                        # digest match also PROVES the peer converged as
                        # of this wall instant — fold it into the lag
                        # gauge as a zero-lag sample, and clear any
                        # interval-dirty debt we held against it (the
                        # range repair it was owed has demonstrably
                        # happened)
                        self._note_lag(self._peer_key(conn), 0.0)
                        if conn.peer_addr is not None:
                            st = self._peers.get(conn.peer_addr)
                            if st is not None:
                                self._mark_dirty(st, False)
                        # digest match = byte-equal state: adopt the
                        # requester's vector, and reply with ours (the
                        # one place MsgSyncDone carries a non-empty
                        # svec) — the session heal both ways (v10)
                        if self._sessions is not None and conn.sync_svec:
                            self._sessions.adopt(dict(conn.sync_svec))
                        self._log.info() and self._log.i(
                            "sync: peer digest match, zero data frames"
                        )
                        await self._stream_sync(
                            conn, sys_frames, svec=svec_snap
                        )
                        continue
                    self._log.info() and self._log.i(
                        f"sync: digest trees for {'+'.join(miss)}"
                    )
                    ok = True
                    for name in miss:
                        leaves = await self._database.sync_tree_async(name)
                        fr = self._wire(
                            codec.encode(MsgDigestTree(name, leaves))
                        )
                        try:
                            # sync.digest: drop -> this tree frame is
                            # lost (the requester re-pulls next period);
                            # error -> conn drop + redial heal
                            fr = await faults.async_point("sync.digest", fr)
                        except faults.FaultError:
                            self._drop(conn, Drop.WRITE_FAILED)
                            ok = False
                            break
                        if fr is None:
                            continue
                        self._stats["sync_trees_sent"] += 1
                        if not await self._send_frame(conn, fr):
                            ok = False
                            break
                    if ok:
                        await self._stream_sync(conn, sys_frames)
                if not dump_all:
                    continue
                self._stats["sync_full_dumps"] += len(dump_all)
                self._log.info() and self._log.i(
                    f"sync: full dump to {len(dump_all)} legacy-shape peer(s)"
                )
                # per type, encode-and-fan one bounded chunk at a time:
                # responder memory holds ONE encoded chunk, never the
                # keyspace
                for name in types:
                    targets = list(dump_all)
                    async for fr in self._data_frames(name):
                        targets = [
                            c for c in targets if await self._send_frame(c, fr)
                        ]
                        if not targets:
                            break
                live = [
                    c
                    for c in dump_all
                    if c.writer is not None
                    and not c.writer.transport.is_closing()
                ]
                for conn in live:
                    await self._stream_sync(conn, sys_frames)
                self._log.info() and self._log.i(
                    f"sync: dump complete, {len(live)} peer(s) still live"
                )
        finally:
            self._sync_dump_inflight = False

    async def _send_frame(self, conn: _Conn, data: bytes) -> bool:
        """One framed write under backpressure; drops the conn on error.
        A successful write IS activity: the stream is paced by the
        receiver's converge speed, so a multi-second dump produces no
        inbound traffic on this conn — without the mark, the idle
        eviction would kill every large sync mid-flight."""
        try:
            # cluster.sync_dump: drop -> this dump frame is silently
            # lost (the requester stays behind until the next periodic
            # digest exchange); error/corrupt behave like cluster.write
            data = await faults.async_point("cluster.sync_dump", data)
        except faults.FaultError:
            self._drop(conn, Drop.WRITE_FAILED)
            return False
        if data is None:
            return True
        if not conn.send_raw(data):
            self._drop(conn, Drop.WRITE_FAILED)
            return False
        try:
            await conn.writer.drain()
        except (ConnectionError, RuntimeError):
            self._drop(conn, Drop.WRITE_FAILED)
            return False
        self._stats["sync_bytes_sent"] += len(data)
        self._mark_activity(conn)
        return True

    async def _stream_sync(
        self, conn: _Conn, frames: list[bytes], svec: tuple = ()
    ) -> None:
        for data in frames:
            if not await self._send_frame(conn, data):
                return
        self._send(conn, MsgSyncDone(svec))

    def _converge_addrs(self, other: P2Set) -> None:
        """Membership gossip convergence with stale-name self-healing
        (cluster.pony:215-239)."""
        changed = self._known_addrs.converge(other)
        # any address claiming my host:port under another name is outdated;
        # P2Set removal blacklists it permanently
        for a in list(self._known_addrs):
            if (
                a.host == self._addr.host
                and a.port == self._addr.port
                and a.name != self._addr.name
            ):
                self._known_addrs.unset(a)
                changed = True
        if changed:
            # drop actives to now-blacklisted addresses
            for addr in list(self._actives):
                if addr not in self._known_addrs:
                    self._drop(self._actives[addr], Drop.BLACKLISTED)
            # and their sync-request + dial-lifecycle bookkeeping:
            # blacklisted addresses never re-establish, so their entries
            # are dead weight that would otherwise grow with name churn
            for addr in list(self._sync_req_tick):
                if addr not in self._known_addrs:
                    del self._sync_req_tick[addr]
            for addr in list(self._peers):
                if addr not in self._known_addrs:
                    del self._peers[addr]
            for skey in list(self._recv_cum):
                if not any(str(a) == skey for a in self._known_addrs):
                    self._recv_cum.pop(skey, None)
                    self._recv_ooo.pop(skey, None)
            for skey in list(self._seen_tick):
                if not any(str(a) == skey for a in self._known_addrs):
                    del self._seen_tick[skey]  # dead weight like above
            self._sync_actives()
            self._broadcast_msg(MsgExchangeAddrs(self._known_addrs.copy()))

    # ---- sending -----------------------------------------------------------

    def _wire(self, body: bytes) -> bytes:
        """One transport frame origin-stamped by THIS instance's clock
        (virtual under jmodel, wall time in production) — every send in
        this class goes through here so no frame can pick up a wall
        stamp behind the seam's back."""
        return wire_frame(body, origin_ms=self._clock.now_ms())

    def broadcast_deltas(self, deltas):
        """The _SendDeltasFn sink (cluster.pony:209-213), schema v8:
        serialise the batch once, write to every established active
        connection. Content-carrying batches are SEQUENCED (MsgSeqPush
        with this sender's monotone seq) and logged into the retransmit
        window; content-free keepalives (the SYSTEM deltas_size()==1
        quirk) stay unsequenced MsgPushDeltas — they solicit the Pong
        that feeds the rtt histogram and never burn window slots.
        Anything already held ships FIRST (strict FIFO: a late-joining
        peer sees pre-join writes in flush order, never a fresh batch
        jumping the queue), and a fresh batch that cannot ship queues
        behind them. Returns (own srid, assigned seq) for sequenced
        content — the lane bridge's tee relays the SAME batch into the
        sibling mesh under that origin — or (None, 0) for keepalives."""
        name, batch = deltas
        if batch and name != "SYSTEM":
            # outbound data deltas exist only for LOCAL applies: the
            # signal that defers the periodic digest pull (heartbeat)
            self._local_writes_seen = True
        if not self._worth_holding(name, batch):
            # keepalive: best-effort liveness traffic, never held
            data = self._wire(codec.encode(MsgPushDeltas(name, tuple(batch))))
            self._flush_held()
            if not self._held:
                self._send_to_actives(data, expect_pong=True)
            return None, 0
        self._delta_seq += 1
        self._own_seq += 1
        seq = self._delta_seq
        # provenance sampling (schema v11): every Nth sequenced flush
        # carries a span minted here — the chain every later hop
        # appends to. `last_span` stays set (or cleared) until the next
        # sequenced flush so the lane tee can read it synchronously.
        span = b""
        if self._trace_sample > 0:
            self._trace_n += 1
            if self._trace_n >= self._trace_sample:
                self._trace_n = 0
                span = jtrace.append_hop(
                    b"", jtrace.HOP_ORIGIN, self._srid, self._region,
                    self._clock.now_ms(),
                )
        self.last_span = span
        data = self._wire(
            codec.encode(
                MsgSeqPush(seq, self._own_seq, name, tuple(batch), span)
            )
        )
        if self._owns_session:
            # every local write in this batch is now sequenced: the
            # vector's own entry advances, which is what a token minted
            # after the flush barrier reads (sessions.py). The vector
            # tracks the OWN-CONTENT ordinal, not the transport seq —
            # relay frames never consume it, so receivers (direct or
            # relay-hops away) see a gapless stream per origin.
            self._sessions.note_local(self._srid, self._own_seq)
        self._ship_sequenced(seq, data)
        return self._srid, self._own_seq

    def relay_deltas(self, origin: str, oseq: int, deltas,
                     span: bytes = b"") -> None:
        """Re-export one first-sight sequenced batch into THIS mesh
        with origin attribution preserved (lane bridge: called by the
        sibling instance's on_push / the tee; region bridge:
        _relay_fresh). Transport-wise identical to broadcast_deltas'
        sequenced path — the frame takes this sender's next seq, rides
        the delta log, is acked and retransmitted — so receivers'
        per-sender contiguity survives bridge fan-out; only the session
        watermark semantics differ (the ORIGIN's, carried verbatim).
        A sampled span gets this hop's stamp appended (`relay_hop` —
        bus/cluster/relay depending on which leg this instance is)."""
        name, batch = deltas
        self._delta_seq += 1
        seq = self._delta_seq
        self._stats["relays_sent"] += 1
        if span:
            span = jtrace.append_hop(
                span, self.relay_hop, self._srid, self._region,
                self._clock.now_ms(),
            )
        data = self._wire(
            codec.encode(
                MsgRelayPush(seq, origin, oseq, name, tuple(batch), span)
            )
        )
        self._ship_sequenced(seq, data)

    def push_unsequenced(self, deltas) -> None:
        """Best-effort unsequenced content push (MsgPushDeltas) to the
        established actives — the lane bridge's carrier for relayed
        SYNC data (origin None). Deliberately outside the seq/ack/
        retransmit machinery AND the session surface: re-originating
        sync data as this instance's own sequenced stream would mint
        own-content ordinals that one side of the bridge can never
        observe, stranding every token that references them (review
        find). Loss is healed by the receivers' own periodic digest
        syncs, exactly like any sync-dump frame."""
        name, batch = deltas
        data = self._wire(codec.encode(MsgPushDeltas(name, tuple(batch))))
        self._send_to_actives(data, expect_pong=True)

    def _queue_repair_relay(self, name: str, batch, nbytes: int) -> None:
        """Enqueue one cross-WAN sync/repair batch for re-export into
        the intra-region mesh. Byte-capped (RELAY_QUEUE_BYTES_CAP, the
        retransmit-cap discipline applied to the WAN seam): past the
        cap the frame DROPS, counted in relay_dropped — the members'
        periodic digest syncs stay the correctness backstop, so the
        drop costs latency, never convergence. One drain task at a
        time, writer backpressure per frame — a slow member paces the
        relay instead of the queue buffering without bound."""
        if self._relay_queue_bytes + nbytes > RELAY_QUEUE_BYTES_CAP:
            self._stats["relay_dropped"] += 1
            self._reg.trace_event(
                "cluster", "relay_drop", "",
                f"{name} {nbytes}B over queue cap",
            )
            return
        self._relay_queue.append((name, batch, nbytes))
        self._relay_queue_bytes += nbytes
        if self._reg.enabled and self._obs_primary:
            self._reg.gauge_set(
                "cluster.relay_queue_bytes", float(self._relay_queue_bytes)
            )
        if not self._relay_inflight:
            self._relay_inflight = True
            task = asyncio.get_running_loop().create_task(
                self._drain_repair_relays()
            )
            self._flush_tasks.add(task)
            task.add_done_callback(self._flush_task_done)

    async def _drain_repair_relays(self) -> None:
        """Drain the repair-relay queue: encode off the loop, write one
        frame to every established INTRA-REGION active conn under
        writer backpressure (drain between frames — the queue's cap
        plus this pacing is what 'backpressure instead of unbounded
        buffering' means at this seam). Frames ride as unsequenced
        MsgPushDeltas exactly like the sync data they re-export:
        re-originating them as our own sequenced stream would mint
        own-content ordinals one side can never observe (the lane
        bridge's push_unsequenced lesson). cluster.relay fires per
        batch — the WAN seam's failpoint paces/drops here too."""
        try:
            while self._relay_queue:
                name, batch, nbytes = self._relay_queue.popleft()
                self._relay_queue_bytes -= nbytes
                if self._reg.enabled and self._obs_primary:
                    self._reg.gauge_set(
                        "cluster.relay_queue_bytes",
                        float(self._relay_queue_bytes),
                    )
                try:
                    # drop/error -> this repair frame is lost (members
                    # heal on their periodic sync); sleep paces like
                    # WAN RTT — the same seam contract as _relay_fresh
                    await faults.async_point("cluster.relay")
                except faults.FaultError:
                    continue
                data = self._wire(
                    await asyncio.to_thread(
                        codec.encode, MsgPushDeltas(name, tuple(batch))
                    )
                )
                self._stats["repair_relays"] += 1
                for addr, conn in list(self._actives.items()):
                    if not conn.established:
                        continue
                    if (
                        self._regions.get(str(addr), ("", 0))[0]
                        != self._region
                    ):
                        continue  # intra-region fan-out only
                    if not conn.send_raw(data):
                        self._drop(conn, Drop.WRITE_FAILED)
                        continue
                    if not conn.last_write_dropped:
                        # a MsgPushDeltas solicits the receiver's Pong
                        conn.pong_sent.append(self._clock.perf())
                    try:
                        await conn.writer.drain()
                    except (ConnectionError, RuntimeError):
                        self._drop(conn, Drop.WRITE_FAILED)
        finally:
            self._relay_inflight = False

    def _ship_sequenced(self, seq: int, data: bytes) -> None:
        """Common tail of the two sequenced send paths: log into the
        retransmit window, flush anything held first (strict FIFO),
        then broadcast-or-hold."""
        self._log_delta(seq, data)
        self._flush_held()
        if self._held or not self._send_to_actives(data, expect_pong=True):
            # nobody reachable right now (maybe nobody known yet): hold
            # instead of losing, so a late-joining peer still converges on
            # pre-join writes up to the cap (the delta log ALSO keeps the
            # frame, but replay only serves peers with ack history — the
            # held queue is what reaches a first-ever joiner).
            self._held.append((self._clock.now_ms(), data))
            over = len(self._held) - self._held_cap
            if over > 0:
                # oldest-first eviction at the cap: DOCUMENTED data
                # loss (SURVEY.md §2.5's known gap, bounded) — made
                # visible per the robustness round: counted in the
                # CLUSTER metrics and warned once per episode
                del self._held[:over]
                self._note_held_drop(over)

    @staticmethod
    def _worth_holding(name: str, batch) -> bool:
        return codec.batch_has_content(name, batch)

    def _log_delta(self, seq: int, data: bytes) -> None:
        """Append one sequenced batch frame to the retransmit window.
        Past the cap the oldest entries leave the window — and every
        known peer whose acked watermark predates an evicted seq is
        marked INTERVAL-DIRTY right here (the satellite fix: cap
        eviction mid-partition used to be a counter + warn; now it is a
        per-peer demotion to range repair, announced by
        MsgIntervalReset the moment the peer is reachable)."""
        self._delta_log.append((seq, data))
        evicted_to = None
        while len(self._delta_log) > self._delta_log_cap:
            evicted_to, _ = self._delta_log.popleft()
        if evicted_to is None:
            return
        for addr, st in self._peers.items():
            if st.acked is not None and st.acked < evicted_to:
                self._mark_dirty(st, True)
                conn = self._actives.get(addr)
                if conn is not None and conn.established:
                    self._send_reset(conn, st)

    def _send_reset(
        self, conn: _Conn, st: _PeerState, force: bool = False
    ) -> None:
        """Demote one peer's interval relationship to range repair: the
        retransmit window can no longer replay its gap, so re-base its
        contiguity cursor at the current seq and let the reset push it
        into a digest-tree sync toward us. Idempotent per seq (a dirty
        peer is reset once per watermark, not once per frame) — EXCEPT
        at re-establishment (``force``): any previous reset rode a conn
        whose fate is unknown, and without the re-send a reset lost
        with no new writes in between would never go out again (the
        guard's own acked/reset_seq bookkeeping satisfies itself
        forever at an unchanged delta_seq). Re-delivery is harmless:
        the receiver re-bases idempotently."""
        if (
            not force
            and st.reset_seq == self._delta_seq
            and st.acked == self._delta_seq
        ):
            return
        self._stats["interval_resets_sent"] += 1
        st.reset_seq = self._delta_seq
        # optimistic: frames after the reset arrive contiguous at the
        # re-based cursor; if the reset itself is lost to churn the
        # peer's next (stale) ack re-opens the gap and the next
        # establishment re-sends the reset — self-correcting, and any
        # interval confusion in between is healed by the periodic
        # digest sync regardless
        st.acked = self._delta_seq
        self._reg.trace_event(
            "cluster", "interval_reset", "sent", self._conn_desc(conn)
        )
        self._send(conn, MsgIntervalReset(self._delta_seq))

    def _retransmit_unacked(self, conn: _Conn) -> None:
        """Reconnection replay (the delta-interval payoff): ship exactly
        the window entries past this peer's acked watermark. A peer with
        NO ack history gets nothing — its history arrives through the
        digest-tree bootstrap sync, not through a 1024-frame replay of
        writes it may never have been owed. A peer whose gap fell off
        the window gets the MsgIntervalReset demotion instead."""
        st = self._peers.get(conn.active_addr)
        if st is None or st.acked is None:
            return
        if st.interval_dirty or (
            self._delta_log and self._delta_log[0][0] > st.acked + 1
        ):
            self._mark_dirty(st, True)
            self._send_reset(conn, st, force=True)
            return
        # frames still sitting in the held queue reach this peer through
        # the upcoming _flush_held (strict FIFO, next broadcast tick) —
        # replaying them here would ship every one twice and answer with
        # duplicate acks. Held frames are always the most-recent seq run
        # (flush-first ordering: nothing newer is ever sent while older
        # frames are held), so skipping them keeps the replay contiguous
        # below the held run and per-peer seq order intact.
        held = {data for _, data in self._held}
        pending = [
            (seq, data)
            for seq, data in self._delta_log
            if seq > st.acked and data not in held
        ]
        if sum(len(data) for _, data in pending) > RETRANSMIT_BYTES_CAP:
            # the replay loop writes synchronously (no drain between
            # frames — it runs inside handshake handling): a window
            # bigger than the cap would blow through the conn's write
            # buffer limit mid-replay, drop the freshly established
            # conn, and repeat on every redial. A gap that large is
            # range-repair territory anyway — demote instead of churn.
            self._mark_dirty(st, True)
            self._send_reset(conn, st, force=True)
            return
        n = 0
        for seq, data in pending:
            if not conn.send_raw(data):
                self._drop(conn, Drop.WRITE_FAILED)
                return
            if not conn.last_write_dropped:
                conn.pong_sent.append(self._clock.perf())
            n += 1
        if n:
            self._stats["deltas_reshipped"] += n
            self._reg.trace_event(
                "cluster", "reship", "", f"{n} to {self._conn_desc(conn)}"
            )

    def _send_to_actives(self, data: bytes, expect_pong: bool = False) -> bool:
        """Write one pre-framed message to every established active conn;
        True if it reached at least one. ``expect_pong`` stamps the send
        time per conn so the peer's Pong closes a cluster.rtt sample
        (pushes and announces solicit Pongs; exchanges do not)."""
        sent = False
        for conn in list(self._actives.values()):
            if conn.established:
                if conn.send_raw(data):
                    sent = True
                    if expect_pong and not conn.last_write_dropped:
                        # stamp unconditionally (one float append — not
                        # the serving hot path the enabled switch
                        # guards): stamping only-while-enabled would mix
                        # stamped and unstamped sends on one conn and
                        # desync the FIFO when the switch flips mid-conn.
                        # EXCEPT an injected-drop "send": no frame left,
                        # no Pong comes, the stamp would strand and
                        # shift every later match by one
                        conn.pong_sent.append(self._clock.perf())
                else:
                    self._drop(conn, Drop.WRITE_FAILED)
        return sent

    def _note_held_drop(self, n: int) -> None:
        self._stats["held_drops"] += n
        self._reg.trace_event("cluster", "held_evict", "", f"dropped {n}")
        if not self._held_drop_episode:
            # once per eviction EPISODE (a burst of over-cap flushes),
            # not per batch: a long-solo write-hot node would otherwise
            # spam one warn per flush for hours
            self._held_drop_episode = True
            self._log.warn() and self._log.w(
                f"held-delta cap {self._held_cap} reached: evicting "
                "oldest batches — writes made with zero reachable peers "
                "are being lost beyond the documented held window"
            )

    def _flush_held(self) -> None:
        while self._held:
            data = self._held[0][1]
            if not self._send_to_actives(data, expect_pong=True):
                return
            self._held.pop(0)
        self._held_drop_episode = False  # drained: next eviction is news

    def _broadcast_msg(self, msg) -> None:
        self._send_to_actives(
            self._wire(codec.encode(msg)),
            expect_pong=isinstance(msg, MsgAnnounceAddrs),
        )

    def _send(self, conn: _Conn, msg) -> None:
        if not conn.send_raw(self._wire(codec.encode(msg))):
            self._drop(conn, Drop.WRITE_FAILED)

    # ---- connection teardown -----------------------------------------------

    def _drop_msg(self, conn: _Conn, reason: str) -> None:
        """A DECLARED message drop (MsgDrop reasons): the frame is
        discarded, the connection stays up, and the event is counted
        (``msg_drop_<reason>`` in CLUSTER metrics) and traced — never a
        silent fall-through. The protocol atlas (jlint pass 10) extracts
        these sites, so every ignore in the handlers is reviewed."""
        self._msg_drops[reason] = self._msg_drops.get(reason, 0) + 1
        self._reg.trace_event(
            "cluster", "msg_drop", reason, self._conn_desc(conn)
        )

    def _mark_activity(self, conn: _Conn) -> None:
        self._last_activity[conn] = self._tick

    def _conn_desc(self, conn: _Conn) -> str:
        """Peer identity + role for teardown logs: actives name the
        address we dialed; passives name the advertised address the v5
        handshake carried (or admit they never learned one)."""
        if conn.active_addr is not None:
            return f"active {conn.active_addr}"
        if conn.peer_addr is not None:
            return f"passive {conn.peer_addr}"
        return "passive (pre-handshake)"

    def _drop(self, conn: _Conn, reason: str = Drop.EOF) -> None:
        """Close and untrack a connection, logging WHO and WHY and
        counting the reason (CLUSTER metrics). A dropped active's
        address stays in _known_addrs (unless blacklisting removed it),
        so _sync_actives re-dials it — immediately for a conn drop,
        after backoff for dial failures; passives are simply
        forgotten."""
        tracked = conn in self._passives or (
            conn.active_addr is not None
            and self._actives.get(conn.active_addr) is conn
        )
        if tracked:
            self._drop_counts[reason] = self._drop_counts.get(reason, 0) + 1
            self._reg.trace_event(
                "cluster", "drop", reason, self._conn_desc(conn)
            )
            self._log.info() and self._log.i(
                f"dropping {self._conn_desc(conn)} connection ({reason})"
            )
            if conn.active_addr is not None and reason in _PEER_FAULT_DROPS:
                # the peer answered TCP but violated the protocol:
                # back its address off exactly like a connect failure
                # (reset by a later clean establishment or by inbound
                # contact, like any backoff)
                st = self._peers.get(conn.active_addr)
                if st is None:
                    st = self._peers[conn.active_addr] = _PeerState()
                st.fails += 1
                st.next_dial_tick = self._tick + self._backoff_ticks(
                    conn.active_addr, st.fails
                )
        if tracked:
            # the lag gauge tracks LIVE peers: a departed conn's EWMA
            # must not pin the node-wide max forever (a rejoin restarts
            # sampling immediately). Secondary (lane-bus) instances
            # never own the gauge — writing their always-empty max
            # here would zero the primary's value on every bus drop.
            self._lag_ms.pop(self._peer_key(conn), None)
            if self._obs_primary:
                self._reg.gauge_set(
                    "cluster.converge_lag_ms", self._worst_lag_ms()
                )
        self._last_activity.pop(conn, None)
        self._passives.discard(conn)
        if conn.active_addr is not None:
            cur = self._actives.get(conn.active_addr)
            if cur is conn:
                self._actives.pop(conn.active_addr, None)
        if conn.task is not None and conn.task is not asyncio.current_task():
            conn.task.cancel()
        if conn.writer is not None:
            conn.close()
