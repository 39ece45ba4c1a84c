"""Session guarantees: read-your-writes / monotonic-reads tokens.

The port's copy of jylis_tpu/sessions.py, whole: the token codec, the
applied-interval vector (``SessionIndex``) and the incarnation ids the
cluster stamps its streams with. The token bytes are the JAX
package's, so a token minted on a port node is honoured by a JAX node of
the same cluster and the reverse.

The paper's store is eventually consistent: a client that writes on one
replica (or one serving lane) and reads on another can observe its own
write missing — fine for a single LAN socket, disqualifying for a
system serving one logical session across many replicas. This module
cashes in the schema-v8 delta-interval machinery for a client-visible
contract (the classic session-guarantee construction of Terry et al.,
"Session Guarantees for Weakly Consistent Replicated Data"):

* Every replica's cluster engine already runs a **per-sender monotone
  batch sequence** (``MsgSeqPush``): a sender's local writes are totally
  ordered by its seq counter, and a receiver knows exactly which prefix
  of each sender's stream it has applied.
* A **session token** is a compact vector of ``(origin rid, seq)``
  pairs: "the writes this session depends on are covered by these
  senders' streams up to these seqs". ``SESSION TOKEN`` / ``SESSION
  WRAP`` mint one after forcing the pending local deltas through the
  flush path, so the client's own writes are sequenced before the
  vector is read.
* A read presenting a token (``SESSION READ``) is served once the local
  **applied-interval vector** (:class:`SessionIndex`) dominates the
  token — bounded wait (``--session-wait-ms``), then a typed ``STALE``
  refusal. The reply carries the join of the token and the server's
  vector, which is what makes successive reads monotonic.

The applied vector is deliberately STRICTER than the transport's
``_recv_cum`` cursors: ``_track_seq`` baselines at the first observed
seq (history arrives via the digest-tree bootstrap sync, which is fine
for lattice convergence), but a session vector that jumped to a
first-observed seq would claim writes 1..seq-1 visible when they are
not — a real read-your-writes violation, and exactly the deliberately
broken variant jmodel minimizes a counterexample for
(``session_unsafe``). Here a per-origin watermark advances only by
**contiguous application from zero** (or from an adopted base), with a
bounded out-of-order park; everything else waits for **digest-match
adoption**: a sync digest match proves byte-equal state, so the peer's
whole vector folds in (``MsgSyncRequest``/``MsgSyncDone`` carry it both
ways). Adoption is also what heals a rebooted origin: its seq counter
restarts, so each boot mints a fresh rid (address + boot epoch) and the
old incarnation's entries survive on peers, frozen and adoptable.

Tokens survive a client bouncing across lanes because the lane bus IS a
cluster (each lane's vector tracks its siblings' bus streams), and
across replicas/regions because bridges relay foreign streams with
origin attribution preserved (``MsgRelayPush``). docs/sessions.md has
the token format, the guarantee matrix, and the STALE/BUSY contracts.
"""

from __future__ import annotations

import asyncio
import struct
import zlib

U64_MAX = (1 << 64) - 1

# wire format version byte of the token itself (not the cluster schema:
# tokens live in CLIENT hands across node upgrades, so they carry their
# own version and a CRC — a mangled or truncated token must be a typed
# BADTOKEN refusal, never a misread vector)
TOKEN_VERSION = 1
# decode-side bounds: a token is a per-origin vector, so its entry count
# is bounded by cluster size x retained epochs — 4096 is generous, and
# the cap stops a hostile client making the server allocate per junk byte
TOKEN_MAX_ENTRIES = 4096
TOKEN_MAX_RID = 512  # rid = "host:port:name!epoch" — far under this

# per-origin out-of-order park (seqs above the contiguity watermark,
# waiting for the gap): bounded like the transport's RECV_OOO_CAP; past
# the cap the lowest parked seqs drop — they re-enter via digest-match
# adoption, never via a watermark jump
PARK_CAP = 512
# retained (addr, epoch) incarnations per address: older epochs' entries
# are frozen-but-valid (their writes were applied); keeping a few lets
# pre-reboot tokens verify, pruning the tail bounds vector growth
EPOCHS_PER_ADDR = 4

SESSION_WAIT_MS_DEFAULT = 500


class SessionError(Exception):
    """Token decode failure — surfaces as the BADTOKEN refusal."""


def make_rid(addr: str, epoch: int) -> str:
    """One origin incarnation: advertised address + boot epoch. The
    epoch (boot wall-ms through the cluster's injectable clock) is what
    keeps a rebooted origin's restarted seq counter from aliasing its
    previous stream in every peer's vector."""
    return f"{addr}!{epoch}"


def rid_addr(rid: str) -> str:
    """The address part of a rid (epoch pruning groups by this)."""
    return rid.rsplit("!", 1)[0]


def encode_token(vec: dict[str, int]) -> bytes:
    """version u8, entry count varint, per entry (rid:str seq:varint)
    sorted by rid, then crc32 over everything before it (u32be). An
    empty vector is a legal token (it dominates trivially — the null
    session)."""
    out = bytearray((TOKEN_VERSION,))
    _w_varint(out, len(vec))
    for rid in sorted(vec):
        rb = rid.encode()
        _w_varint(out, len(rb))
        out += rb
        _w_varint(out, vec[rid])
    out += struct.pack(">I", zlib.crc32(bytes(out)))
    return bytes(out)


def decode_token(data: bytes) -> dict[str, int]:
    """Inverse of encode_token; every malformation — truncation at any
    byte, CRC mismatch, u64 overflow, duplicate rid, trailing bytes —
    raises :class:`SessionError`."""
    if len(data) < 1 + 1 + 4:
        raise SessionError("token too short")
    body, crc_bytes = data[:-4], data[-4:]
    if struct.unpack(">I", crc_bytes)[0] != zlib.crc32(body):
        raise SessionError("token crc mismatch")
    if body[0] != TOKEN_VERSION:
        raise SessionError(f"unknown token version {body[0]}")
    pos = 1
    count, pos = _r_varint(body, pos)
    if count > TOKEN_MAX_ENTRIES:
        raise SessionError("token entry count out of bounds")
    vec: dict[str, int] = {}
    for _ in range(count):
        rlen, pos = _r_varint(body, pos)
        if rlen > TOKEN_MAX_RID or pos + rlen > len(body):
            raise SessionError("token rid out of bounds")
        try:
            rid = body[pos : pos + rlen].decode()
        except UnicodeDecodeError as e:
            raise SessionError("token rid not utf-8") from e
        pos += rlen
        seq, pos = _r_varint(body, pos)
        if seq > U64_MAX:
            raise SessionError("token seq exceeds u64")
        if rid in vec:
            raise SessionError("duplicate token rid")
        vec[rid] = seq
    if pos != len(body):
        raise SessionError("trailing bytes after token")
    return vec


def dominates(vec: dict[str, int], token: dict[str, int]) -> bool:
    """True when the applied vector covers every token entry."""
    return all(vec.get(rid, 0) >= seq for rid, seq in token.items())


# decoded-token memo (per process): clients re-present the same token
# bytes on every read of a session, so the serving path pays the full
# decode+CRC once per distinct token instead of once per command.
# Bounded by wholesale clear; values are treated as immutable by every
# caller (declared in scripts/jlint/lanes_manifest.json — a pure
# derived-data cache, so per-lane copies are trivially correct).
_DECODE_MEMO: dict[bytes, dict[str, int]] = {}
_DECODE_MEMO_CAP = 128


def decode_token_memo(data: bytes) -> dict[str, int]:
    """decode_token with the serving-path memo; the returned dict is
    SHARED — callers must not mutate it."""
    vec = _DECODE_MEMO.get(data)
    if vec is None:
        vec = decode_token(data)
        if len(_DECODE_MEMO) >= _DECODE_MEMO_CAP:
            _DECODE_MEMO.clear()
        _DECODE_MEMO[bytes(data)] = vec
    return vec


def join_vec(a: dict[str, int], b: dict[str, int]) -> dict[str, int]:
    out = dict(a)
    for rid, seq in b.items():
        if seq > out.get(rid, 0):
            out[rid] = seq
    return out


def _w_varint(out: bytearray, v: int) -> None:
    if v < 0:
        raise SessionError(f"negative varint: {v}")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _r_varint(data: bytes, pos: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise SessionError("truncated varint")
        byte = data[pos]
        pos += 1
        v |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return v, pos
        shift += 7
        if shift > 70:
            raise SessionError("varint too long")


class SessionIndex:
    """One node's (or lane's) applied-interval vector + waiter queue.

    Owned by the Database; fed by the cluster engine: ``note_local``
    after every flush that sequenced own batches, ``note_applied`` after
    every sequenced (direct or relayed) batch converges, ``adopt`` on
    every digest-match proof. ``unsafe`` arms the deliberately broken
    watermark rule (first-observed jump) for jmodel's counterexample
    demonstration — never set in production wiring."""

    def __init__(self, unsafe: bool = False):
        self.unsafe = unsafe
        self.srid: str | None = None  # set by the driving cluster's bind
        # async callable that forces the pending local deltas through
        # the cluster flush path (Cluster.flush_now); None on a node
        # with no cluster — tokens then carry whatever is verified
        self.flush_fn = None
        self._vec: dict[str, int] = {}
        self._parked: dict[str, list[int]] = {}
        self._waiters: list[asyncio.Future] = []
        self._tok_cache: bytes | None = None  # encode_token(_vec) memo
        self.stats = {
            "tokens_minted": 0,
            "reads_served": 0,
            "reads_waited": 0,
            "stale_refusals": 0,
            "badtoken_refusals": 0,
            "adoptions": 0,
            "parked_dropped": 0,
        }

    # ---- vector advance paths ---------------------------------------------

    def bind(self, srid: str, flush_fn) -> None:
        """Wired by the DRIVING cluster instance (the one whose
        heartbeat drains the database): its rid is the self entry every
        minted token leads with."""
        self.srid = srid
        self.flush_fn = flush_fn

    def note_local(self, srid: str, seq: int) -> None:
        """Own flushes: every local write up to the just-assigned seq is
        in the own stream by construction — unconditional max."""
        if seq > self._vec.get(srid, 0):
            self._vec[srid] = seq
            self._wake()

    def note_applied(self, origin: str, seq: int) -> bool:
        """One sequenced batch of ``origin``'s stream has CONVERGED
        here (call after the converge completes, never before — a
        waiter woken between would serve a read the data hasn't
        reached). Returns True when the batch was first-sight (the
        bridge relay predicate); duplicates return False."""
        cum = self._vec.get(origin, 0)
        if seq <= cum:
            return False
        if self.unsafe:
            # the BROKEN rule (jmodel's counterexample target): adopt
            # any observed seq as the watermark — claims writes
            # 1..seq-1 visible without evidence
            self._vec[origin] = seq
            self._wake()
            return True
        parked = self._parked.get(origin)
        if seq == cum + 1:
            cum += 1
            if parked:
                parked.sort()
                while parked and parked[0] == cum + 1:
                    cum += 1
                    parked.pop(0)
                if not parked:
                    del self._parked[origin]
            self._vec[origin] = cum
            self._wake()
            return True
        if parked is None:
            parked = self._parked[origin] = []
        if seq in parked:
            return False
        parked.append(seq)
        if len(parked) > PARK_CAP:
            # the gap is not filling through this path: drop the LOWEST
            # parked seqs (the watermark can only reach them via
            # adoption now anyway) — bounded memory, never a jump
            parked.sort()
            drop = len(parked) - PARK_CAP
            del parked[:drop]
            self.stats["parked_dropped"] += drop
        return True

    def adopt(self, vec: dict[str, int]) -> None:
        """Digest-match proof: the peer's state equals ours, so every
        write its vector covers is in our state — pointwise max fold,
        then collapse any parked seqs the new watermarks subsume."""
        if not vec:
            return
        changed = False
        for rid, seq in vec.items():
            if seq > U64_MAX:
                continue  # never let a hostile peer poison the vector
            if seq > self._vec.get(rid, 0):
                self._vec[rid] = seq
                changed = True
        if changed:
            self.stats["adoptions"] += 1
            for origin in list(self._parked):
                cur = self._vec.get(origin, 0)
                cum = cur
                parked = sorted(s for s in self._parked[origin] if s > cum)
                while parked and parked[0] == cum + 1:
                    cum += 1
                    parked.pop(0)
                if cum > cur:
                    # only when the collapse actually advanced: an
                    # unconditional write would mint phantom 0-seq
                    # entries for origins that have ONLY parked seqs
                    # (review find)
                    self._vec[origin] = cum
                if parked:
                    self._parked[origin] = parked
                else:
                    del self._parked[origin]
            self._prune()
            self._wake()

    def _prune(self) -> None:
        """Keep the newest EPOCHS_PER_ADDR incarnations per address;
        pruning only ever makes dominance stricter (STALE, never a
        false serve)."""
        by_addr: dict[str, list[str]] = {}
        for rid in self._vec:
            by_addr.setdefault(rid_addr(rid), []).append(rid)
        for addr, rids in by_addr.items():
            if len(rids) <= EPOCHS_PER_ADDR:
                continue
            rids.sort(key=_rid_epoch)
            for rid in rids[: len(rids) - EPOCHS_PER_ADDR]:
                if rid != self.srid:
                    del self._vec[rid]
                    self._parked.pop(rid, None)

    # ---- the read side -----------------------------------------------------

    def vector(self) -> dict[str, int]:
        return dict(self._vec)

    def token_bytes(self) -> bytes:
        """The vector as encoded token bytes, memoised per advance —
        the common reply token: a SERVED read's join(token, vec) IS vec
        (the serve condition is exactly vec >= token), and minting
        after a no-op flush re-reads the same vector."""
        if self._tok_cache is None:
            self._tok_cache = encode_token(self._vec)
        return self._tok_cache

    def dominated(self, token: dict[str, int]) -> bool:
        return dominates(self._vec, token)

    async def wait_dominated(self, token: dict[str, int], wait_ms: int) -> bool:
        """Bounded wait for the applied vector to dominate ``token``;
        True = serve, False = the STALE refusal. Wakes on every vector
        advance (local flush, converge, adoption)."""
        if self.dominated(token):
            return True
        self.stats["reads_waited"] += 1
        loop = asyncio.get_running_loop()
        deadline = loop.time() + wait_ms / 1e3
        while True:
            remaining = deadline - loop.time()
            if remaining <= 0:
                return self.dominated(token)
            fut = loop.create_future()
            self._waiters.append(fut)
            try:
                await asyncio.wait_for(asyncio.shield(fut), remaining)
            except asyncio.TimeoutError:
                pass
            finally:
                if not fut.done():
                    fut.cancel()
                if fut in self._waiters:
                    self._waiters.remove(fut)
            if self.dominated(token):
                return True

    def _wake(self) -> None:
        self._tok_cache = None  # every wake is a vector change
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)

    # ---- observability -----------------------------------------------------

    def metrics_totals(self) -> dict[str, int]:
        """The SYSTEM METRICS `SESSION` section (docs/operations.md
        glossary)."""
        out = dict(self.stats)
        out["origins"] = len(self._vec)
        out["parked_seqs"] = sum(len(p) for p in self._parked.values())
        return out

    def canonical(self):
        """Protocol-relevant state for jmodel's state hash."""
        return (
            sorted(self._vec.items()),
            sorted((o, tuple(sorted(p))) for o, p in self._parked.items()),
        )


def _rid_epoch(rid: str) -> int:
    tail = rid.rsplit("!", 1)
    try:
        return int(tail[1]) if len(tail) == 2 else 0
    except ValueError:
        return 0
