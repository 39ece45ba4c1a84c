"""Database: keyspace router over the per-type repos, and the sync digest.

The port of jylis_tpu/models/database.py (reference analog:
database.pony:5-65): routes cmd[0] to the matching repo manager (case
sensitive) and renders the data-type help for any other first word,
exactly as the JAX node does for an unknown one. It serves the eight
data types of ``DATA_REPO_CLASSES`` in the JAX registry's order, plus
SYSTEM. The device state of the plane-backed types lives on one torch
device, or, in mesh mode, split over the keys shards of a mesh
(parallel/mesh.py): ``mesh="auto"`` shards every plane-backed type over
all visible cards when a host has more than one, as a JAX node does on
more than one device. TENSOR has no mesh mode in either package: it
stays on the mesh's first device. MAP, BCOUNT and SYSTEM are host-only
in both packages.

ONE native serving engine (``engine="auto"``, the default;
native/engine.py) is shared by the TREG, TLOG, GCOUNT, PNCOUNT and UJSON
repos and by the server's burst applier (server/server.py), the node's
single source of host truth, as in a JAX ``Database(engine="auto")``.
``engine="python"`` pins the pure-Python tables everywhere: the oracle
the parity tests hold the native node against. A library that cannot be
built or loaded raises; nothing falls back quietly.

``converge`` / ``converge_async`` take one type's anti-entropy delta
batch -- the entry the cluster calls. ``flush_deltas_async`` hands every
repo's drained local deltas to the cluster's broadcast, and
``dump_state_async`` / ``dump_range_async`` give the state a sync serves,
each repo's dump in a worker thread under its lock and on the node's
device. ``warmup`` builds and first-launches the serving kernels before
a node goes live (jylis_tpu/models/database.py:526-565).

The sync digest (jylis_tpu/models/database.py:26-37, :126-311) is the
JAX node's, byte for byte: per type, a map of key -> sha256(canonical
per-key state) and the running XOR of those hashes, folded in O(keys
dirty since the last pass), and 256 digest-tree leaves by
``sync_bucket``. ``SYSTEM DIGEST`` is the sha256 of the eight XORs in
registry order. The canon is host state (and UJSON's row decode), so a
mesh node and a single-device node give equal bytes.

The process glue (jylis_tpu/models/database.py:86-93, :164-173,
:313-417): ``sessions`` (the node's ``SessionIndex``, which the cluster
feeds and binds) and the ``SESSION TOKEN | WRAP | READ`` family served
in ``apply_async``; ``admission`` (the node-wide ``AdmissionController``
the Server consults, set by ``set_admission``) and the per-class cap of
``set_admission_cap``. SYSTEM METRICS' SESSION and OVERLOAD sections read
them.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib

import torch

from .. import sessions as sessions_mod
from ..admission import AdmissionController
from ..native.engine import resolve_engine
from ..obs.registry import MetricsRegistry
from ..parallel.mesh import resolve_mesh
from .help import DATATYPE_HELP, respond_help
from .manager import RepoManager
from .repo_bcount import RepoBCOUNT
from .repo_counters import RepoGCOUNT, RepoPNCOUNT
from .repo_map import RepoMAP
from .repo_system import RepoSYSTEM
from .repo_tensor import RepoTENSOR
from .repo_tlog import RepoTLOG
from .repo_treg import RepoTREG
from .repo_ujson import RepoUJSON

SESSION_HELP = """\
The following are valid SESSION commands (docs/sessions.md):
  SESSION TOKEN                 - mint this node's session token
  SESSION WRAP <command...>     - apply a command, reply [reply, token]
  SESSION READ <token> <command...> - serve once the token is covered
                                  (bounded wait, then a STALE error),
                                  reply [token', reply]"""

# keyspace-range fanout of the anti-entropy digest tree: every key lands
# in one of 256 stable buckets by the first byte of sha256(key) -- a
# function of the KEY alone, so converged replicas bucket identically
# regardless of write order or backend
SYNC_FANOUT = 256


def sync_bucket(key: bytes) -> int:
    """The digest-tree leaf a key belongs to (stable across replicas)."""
    return hashlib.sha256(key).digest()[0]


# THE data-type registry: every serving repo class, in the JAX package's
# fixed order (jylis_tpu/models/database.py:55-64), which is the digest
# vector's order; SYSTEM rides separately. Everything that enumerates
# types -- SERVED_TYPES, the digest, SYSTEM DIGEST TYPES -- derives from
# this tuple.
DATA_REPO_CLASSES = (
    RepoTREG, RepoTLOG, RepoGCOUNT, RepoPNCOUNT, RepoUJSON, RepoTENSOR,
    RepoMAP, RepoBCOUNT,
)
# the repos whose host tables live in the native serving engine (TENSOR,
# MAP and BCOUNT stay on Python tables, as in the JAX package)
ENGINE_REPO_CLASSES = (RepoTREG, RepoTLOG, RepoGCOUNT, RepoPNCOUNT, RepoUJSON)
SERVED_TYPES = tuple(cls.name for cls in DATA_REPO_CLASSES)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and
    there is none, rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


class Database:
    def __init__(
        self, identity: int, device="cuda", mesh="auto",
        system_repo: RepoSYSTEM | None = None, engine="auto",
    ):
        self.device = resolve_device(device)
        # JAX's Database takes no mesh: JAX picks its devices process-wide;
        # the explicit argument is the torch counterpart of that hook
        self.mesh = resolve_mesh(mesh, self.device)
        # THIS instance's observability surface (obs/registry.py): drain
        # counters, latency histograms, trace ring; every repo records
        # into it through its `metrics` attribute
        self.metrics = MetricsRegistry()
        # session guarantees (sessions.py): the node's applied-interval
        # vector and waiter queue, fed by the cluster and served by the
        # SESSION family; session_wait_ms is --session-wait-ms
        self.sessions = sessions_mod.SessionIndex()
        self.session_wait_ms = sessions_mod.SESSION_WAIT_MS_DEFAULT
        # main.py passes the System's repo, whose log lines ride the
        # anti-entropy path (system.py)
        self.system = system_repo if system_repo is not None else RepoSYSTEM(identity)
        # ONE native engine shared by the engine-backed repos and the
        # server's burst applier; None with engine="python"
        self.native_engine = resolve_engine(engine)
        # SYSTEM METRICS' "cmds" lines: this instance's Python-path tally
        # merged with this instance's engine counters
        self._served_py: dict[str, int] = {}
        self.system.served_fn = self._served_totals
        self.system.serving_fn = self.serving_totals
        self._map: dict[bytes, RepoManager] = {}
        for cls in DATA_REPO_CLASSES:
            if cls is RepoTENSOR:
                dev = self.device if self.mesh is None else self.mesh.keys_devices[0]
                repo = cls(identity, device=dev)
            elif cls in ENGINE_REPO_CLASSES:
                repo = cls(identity, device=self.device, mesh=self.mesh,
                           engine=self.native_engine)
            else:
                repo = cls(identity, device=self.device, mesh=self.mesh)
            self._add(repo)
        self._add(self.system)

        # the incremental sync digest: per data type, key -> sha256(canon)
        # and the running XOR of those hashes, the 256 digest-tree leaf
        # accumulators (leaf b = XOR over the keys of bucket b, so the XOR
        # of all leaves IS the type's XOR) and bucket -> live keys
        self.DATA_TYPES = SERVED_TYPES
        self._sync_hash: dict[str, dict[bytes, bytes]] = {
            n: {} for n in self.DATA_TYPES
        }
        self._sync_xor: dict[str, bytes] = {
            n: bytes(32) for n in self.DATA_TYPES
        }
        self._sync_leaf: dict[str, list[int]] = {
            n: [0] * SYNC_FANOUT for n in self.DATA_TYPES
        }
        self._sync_bkeys: dict[str, list[set]] = {
            n: [set() for _ in range(SYNC_FANOUT)] for n in self.DATA_TYPES
        }
        # SYSTEM DIGEST [TYPES] on the single-threaded path; the serving
        # path intercepts them in apply_async, under the repo locks
        self.system.digest_fn = self._sync_digest_blocking
        self.system.digest_types_fn = self._sync_digest_types_blocking
        # SYSTEM METRICS' SESSION section, and the node-wide overload
        # armor the Server consults at every Python-path dispatch: unarmed
        # by default (no policy, no byte bound) until set_admission
        self.system.session_fn = self.sessions.metrics_totals
        self.admission = AdmissionController(registry=self.metrics)
        self.system.overload_fn = self.admission.metrics_totals

    def _add(self, repo) -> None:
        repo.metrics = self.metrics  # timed_drain resolves through this
        mgr = RepoManager(repo.name, repo, repo.help, served=self._served_py)
        # the server's native burst locks the engine-backed types
        mgr.use_registry(self.metrics, native=self.native_engine is not None
                         and type(repo) in ENGINE_REPO_CLASSES)
        self._map[repo.name.encode()] = mgr

    def _served_totals(self) -> dict[str, int]:
        """Commands served per type on BOTH paths (SYSTEM METRICS)."""
        totals = dict(self._served_py)
        if self.native_engine is not None:
            for name, n in self.native_engine.served_counts().items():
                if n:
                    totals[name] = totals.get(name, 0) + n
        return totals

    def serving_totals(self) -> dict[str, int]:
        """The native-vs-demoted serving split of SYSTEM METRICS' SERVING
        lines: commands the engine settled in C++ against commands that
        went through the Python dispatch path (engine defers, demoted
        connections, direct applies), plus whole-connection demotions."""
        native = 0
        if self.native_engine is not None:
            native = sum(self.native_engine.served_counts().values())
        return {
            "native_cmds": native,
            "demoted_cmds": sum(self._served_py.values()),
            "demotions": self.metrics.serving_counters["demotions"],
            "busy_refusals": self.metrics.serving_counters["busy_refusals"],
        }

    # ---- the sync digest (jylis_tpu/models/database.py:202-311) -----------

    def _device_scope(self):
        """The node's CUDA device as the current one: the digest runs in
        a worker thread, whose current device is not the node's."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _sync_update_repo(self, name: str, repo) -> None:
        """Fold the repo's dirty keys into its digest accumulator (worker
        thread, repo lock held by the caller)."""
        with self._device_scope():
            prep = getattr(repo, "sync_prepare", None)
            if prep is not None:
                prep()
            dirty = repo.sync_dirty_keys()
            if not dirty:
                return
            hmap = self._sync_hash[name]
            leaves = self._sync_leaf[name]
            bkeys = self._sync_bkeys[name]
            x = int.from_bytes(self._sync_xor[name], "big")
            tag = name.encode()
            for key in dirty:
                bucket = sync_bucket(key)
                old = hmap.pop(key, None)
                if old is not None:
                    o = int.from_bytes(old, "big")
                    x ^= o
                    leaves[bucket] ^= o
                canon = repo.sync_canon(key)
                if canon is not None:
                    h = hashlib.sha256(
                        tag + b"\x00" + len(key).to_bytes(4, "big") + key + canon
                    ).digest()
                    hmap[key] = h
                    hi = int.from_bytes(h, "big")
                    x ^= hi
                    leaves[bucket] ^= hi
                    bkeys[bucket].add(key)
                else:
                    bkeys[bucket].discard(key)
            self._sync_xor[name] = x.to_bytes(32, "big")

    async def sync_type_digests_async(self) -> tuple[bytes, ...]:
        """One 32-byte digest PER data type (DATA_TYPES order). Each repo
        folds only its dirty keys, under its own lock, in a worker
        thread."""
        for name in self.DATA_TYPES:
            mgr = self._map[name.encode()]
            async with mgr.locked("sync"):
                await asyncio.to_thread(self._sync_update_repo, name, mgr.repo)
        return tuple(self._sync_xor[n] for n in self.DATA_TYPES)

    async def sync_digest_async(self) -> bytes:
        """The combined 32-byte digest over every data type."""
        return hashlib.sha256(
            b"".join(await self.sync_type_digests_async())
        ).digest()

    async def sync_tree_async(self, name: str) -> tuple:
        """One type's keyspace-range digest tree as SPARSE leaves:
        ((bucket, 32-byte digest), ...) for the non-empty buckets only.
        Folds the type's dirty keys first."""
        mgr = self._map[name.encode()]
        async with mgr.locked("sync"):
            await asyncio.to_thread(self._sync_update_repo, name, mgr.repo)
        return tuple(
            (i, v.to_bytes(32, "big"))
            for i, v in enumerate(self._sync_leaf[name])
            if v
        )

    async def dump_range_async(self, name: str, buckets) -> list:
        """One type's state RESTRICTED to the given digest-tree buckets,
        in the wire-delta shape; key selection goes through the bucket
        index (folded current first). A repo with ``dump_keys`` (the
        counters, TREG, TLOG) reads only the wanted keys' rows, where the
        JAX node dumps the whole repo and filters (jylis_tpu/models/
        database.py:267-292): the same entries, in the same order, so the
        same frames, at a cost that scales with the buckets asked for."""
        mgr = self._map[name.encode()]

        def dump_filtered():
            self._sync_update_repo(name, mgr.repo)
            bkeys = self._sync_bkeys[name]
            wanted = set()
            for b in buckets:
                if 0 <= b < len(bkeys):
                    wanted |= bkeys[b]
            with self._device_scope():
                dump_keys = getattr(mgr.repo, "dump_keys", None)
                if dump_keys is not None:
                    return dump_keys(wanted)
                return [
                    (key, delta)
                    for key, delta in mgr.repo.dump_state()
                    if key in wanted
                ]

        async with mgr.locked("sync"):
            return await asyncio.to_thread(dump_filtered)

    def _sync_digest_blocking(self) -> bytes:
        """The combined digest for SINGLE-THREADED callers: same bytes as
        sync_digest_async, no locks."""
        for name in self.DATA_TYPES:
            self._sync_update_repo(name, self._map[name.encode()].repo)
        return hashlib.sha256(
            b"".join(self._sync_xor[n] for n in self.DATA_TYPES)
        ).digest()

    def _sync_digest_types_blocking(self) -> list[tuple[str, bytes]]:
        """Per-type digests for SINGLE-THREADED callers (the sync-path
        SYSTEM DIGEST TYPES)."""
        for name in self.DATA_TYPES:
            self._sync_update_repo(name, self._map[name.encode()].repo)
        return [(n, self._sync_xor[n]) for n in self.DATA_TYPES]

    def set_admission(self, policy: str, queue_bytes: int) -> None:
        """Arm the node-wide overload armor (--admission-policy /
        --admission-queue-bytes, admission.py): per-class shedding under
        the declared OVERLOAD state plus the hard queued-bytes bound."""
        self.admission = AdmissionController(
            policy, queue_bytes, registry=self.metrics
        )
        self.system.overload_fn = self.admission.metrics_totals

    def set_admission_cap(self, cap: int) -> None:
        """Per-command-class admission control (--admission-cap): each
        manager refuses lock-queued commands past ``cap`` in flight with
        a typed BUSY error. 0 = off."""
        for mgr in self._map.values():
            mgr.admission_cap = cap

    # ---- session guarantees (sessions.py) ---------------------------------

    async def _mint_token(self) -> bytes:
        """Force the pending local deltas through the cluster's flush
        (so every prior write of this connection is sequenced and the
        vector's own entry covers it), then encode the vector."""
        if self.sessions.flush_fn is not None:
            await self.sessions.flush_fn()
        self.sessions.stats["tokens_minted"] += 1
        return self.sessions.token_bytes()

    async def _apply_session(self, resp, cmd: list[bytes]) -> None:
        sess = self.sessions
        op = cmd[1] if len(cmd) > 1 else b""
        if op == b"TOKEN" and len(cmd) == 2:
            resp.string(await self._mint_token())
            return
        if op == b"WRAP" and len(cmd) > 2 and cmd[2] != b"SESSION":
            # [inner reply, token]: the token minted after the inner
            # command applied and flushed
            resp.array_start(2)
            await self.apply_async(resp, cmd[2:])
            resp.string(await self._mint_token())
            return
        if op == b"READ" and len(cmd) > 3 and cmd[3] != b"SESSION":
            try:
                token = sessions_mod.decode_token_memo(bytes(cmd[2]))
            except sessions_mod.SessionError as e:
                sess.stats["badtoken_refusals"] += 1
                resp.err(f"BADTOKEN (unusable session token: {e})")
                return
            if not await sess.wait_dominated(token, self.session_wait_ms):
                sess.stats["stale_refusals"] += 1
                resp.err(
                    "STALE (session token not covered within "
                    f"{self.session_wait_ms}ms; retry here later or "
                    "read where you wrote)"
                )
                return
            sess.stats["reads_served"] += 1
            # monotonic reads: a served read's vector dominates the
            # token, so the join of the two is the vector
            resp.array_start(2)
            resp.string(sess.token_bytes())
            await self.apply_async(resp, cmd[3:])
            return
        respond_help(resp, SESSION_HELP)

    def set_journal(self, journal) -> None:
        """Attach the delta journal (journal/): every repo's flushed
        batches append to it before reaching the network sink
        (manager._emit). None detaches. Attaching also arms the JOURNAL
        section of SYSTEM METRICS (explicit zeros from boot); the
        journal records into the registry it was built with (main.py
        passes this Database's)."""
        for mgr in self._map.values():
            mgr.journal = journal
        self.metrics.journal_enabled = journal is not None

    # ---- routing ----------------------------------------------------------

    def manager(self, name: str) -> RepoManager:
        return self._map[name.encode()]

    def managers(self):
        return self._map.values()

    def apply(self, resp, cmd: list[bytes]) -> None:
        mgr = self._map.get(cmd[0]) if cmd else None
        if mgr is None:
            respond_help(resp, DATATYPE_HELP)
            return
        mgr.apply(resp, cmd)

    async def apply_async(self, resp, cmd: list[bytes]) -> None:
        """Serving path: per-repo locking + threaded drains (manager.py).
        SYSTEM DIGEST [TYPES] is served here, not in RepoSYSTEM.apply
        (which is sync): the digest takes every data repo's lock in turn,
        which only the async path can await. SESSION is served here too
        (the native engine defers unknown first words)."""
        if cmd and cmd[0] == b"SESSION":
            await self._apply_session(resp, cmd)
            return
        if len(cmd) == 3 and cmd[0] == b"SYSTEM" and cmd[1] == b"DIGEST" \
                and cmd[2] == b"TYPES":
            digests = await self.sync_type_digests_async()
            resp.array_start(len(self.DATA_TYPES))
            for name, digest in zip(self.DATA_TYPES, digests):
                resp.string(f"{name} {digest.hex()}".encode())
            return
        if len(cmd) == 2 and cmd[0] == b"SYSTEM" and cmd[1] == b"DIGEST":
            digest = await self.sync_digest_async()
            resp.string(digest.hex().encode())
            return
        mgr = self._map.get(cmd[0]) if cmd else None
        if mgr is None:
            respond_help(resp, DATATYPE_HELP)
            return
        await mgr.apply_async(resp, cmd)

    def converge(self, name: str, batch) -> None:
        """Join one type's delta batch [(key: bytes, delta), ...]
        (single-threaded callers)."""
        mgr = self._map.get(name.encode())
        if mgr is not None:
            mgr.converge_deltas(batch)

    async def converge_async(self, name: str, batch) -> None:
        """``converge`` under the repo lock, for the serving loop."""
        mgr = self._map.get(name.encode())
        if mgr is not None:
            await mgr.converge_async(batch)

    def flush_deltas(self, fn) -> None:
        for mgr in self._map.values():
            mgr.flush_deltas(fn)

    async def flush_deltas_async(self, fn) -> None:
        """Every repo's drained local deltas to ``fn((name, batch))``,
        each under its repo lock (the cluster heartbeat's flush)."""
        for mgr in self._map.values():
            await mgr.flush_async(fn)

    async def dump_state_async(self, names=None) -> list:
        """Full state per type for the cluster sync path: [(name,
        batch)]. Each repo dumps under its own lock in a worker thread on
        the node's device, so serving stalls only per type. ``names``
        restricts the dump (the sync digest covers data types only;
        SYSTEM streams separately)."""
        out = []
        for mgr in self._map.values():
            if names is not None and mgr.name not in names:
                continue

            def dump(repo=mgr.repo):
                with self._device_scope():
                    return repo.dump_state()

            async with mgr.locked("sync"):
                batch = await asyncio.to_thread(dump)
            out.append((mgr.name, batch))
        return out

    def drain_all(self) -> None:
        for mgr in self._map.values():
            mgr.repo.drain()

    def stop_intake(self) -> None:
        """Reject new commands immediately (safe from a signal callback)."""
        for mgr in self._map.values():
            mgr._shutdown = True

    async def clean_shutdown_async(self) -> None:
        for mgr in self._map.values():
            await mgr.clean_shutdown_async()

    @contextlib.asynccontextmanager
    async def all_locks(self):
        """Every repo lock, in the map order every multi-lock holder
        takes (the server's burst path too): the shutdown snapshot dumps
        under it, so nothing mutates mid-dump."""
        async with contextlib.AsyncExitStack() as stack:
            for mgr in self._map.values():
                await stack.enter_async_context(mgr.locked("shutdown"))
            yield


class _NullRespond:
    """Discards replies; lets warmup drive the real command paths."""

    def __getattr__(self, name):
        return lambda *a, **k: None


def warmup(device="cuda", mesh="auto", engine="auto") -> None:
    """Build every serving kernel and the native library, and launch the
    serving paths once on ``device`` before a node goes live
    (jylis_tpu/models/database.py:526-565). On a card the kernels build
    first, all at once (ops/_build.py); with ``engine="auto"`` the native
    library builds and loads (native/__init__.py), raising if it cannot.
    A throwaway Database on the node's device then drives one command of
    each kind and a foreign delta per counter type, sparse and dense, so
    no first-use build or library load lands inside a drain that holds a
    repo lock while peers count idle heartbeat ticks. On the CPU it runs
    the plain versions."""
    dev = resolve_device(device)
    if engine == "auto":
        from .. import native

        native.lib()
    scope = contextlib.nullcontext()
    if dev.type == "cuda":
        from ..ops import _build

        _build.build()
        scope = torch.cuda.device(dev)
    with scope:
        db = Database(identity=0, device=dev, mesh=mesh, engine=engine)
        resp = _NullRespond()
        for line in (
            b"GCOUNT INC k 1",
            b"GCOUNT GET k",
            b"PNCOUNT INC k 1",
            b"PNCOUNT DEC k 1",
            b"PNCOUNT GET k",
            b"TREG SET k v 1",
            b"TREG GET k",
            b"TLOG INS k v 2",
            b"TLOG GET k",
            b"TLOG SIZE k",
            b"TLOG TRIM k 1",
            b"TLOG GET k",
            b"UJSON SET k a 1",
            b"UJSON GET k a",
            # the f32 payload (1.0f LE) is space-free, so the split survives
            b"TENSOR SET k MAX 1 \x00\x00\x80?",
            b"TENSOR GET k",
        ):
            db.apply(resp, line.split(b" "))
        # foreign deltas on a quarter of the smallest keyspace (1,024
        # rows) take the dense counter drain, then one key the sparse one
        keys = [b"k%d" % i for i in range(256)]
        for name, pols in (("GCOUNT", 1), ("PNCOUNT", 2)):
            for rows, v in ((keys, 1), (keys[:1], 2)):
                delta = {7: v} if pols == 1 else ({7: v}, {7: v})
                db.converge(name, [(k, delta) for k in rows])
                db.apply(resp, [name.encode(), b"GET", rows[0]])
        db.converge("TREG", [(b"k", (b"w", 2))])
        db.apply(resp, [b"TREG", b"GET", b"k"])
        db.drain_all()
        if db.mesh is not None and dev.type == "cuda":
            _warm_cards(db, resp)
        db._sync_digest_blocking()


def _warm_cards(db, resp) -> None:
    """A mesh node's drains on every card of the mesh before it listens.
    A kernel library loads into a card's CUDA context at its first
    launch there, and the warm-up keys above all land on the first card,
    so without this the first drain to reach each other card would load
    its libraries while it holds a repo lock. Writes to fresh keys fill
    the counter, TREG and TLOG keyspaces to their capacity (the last
    shard holds some; nothing grows), then one drain launches each
    sparse kernel once per card; the two UJSON kernels, which a mesh
    node launches per shard of its resident store, run once per card on
    one identity document."""
    from ..ops import ujson_device as udev
    from ..ops import ujson_resident as ures

    writes = {"GCOUNT": b"GCOUNT INC %s 1", "PNCOUNT": b"PNCOUNT INC %s 1",
              "TREG": b"TREG SET %s v 1", "TLOG": b"TLOG INS %s v 1"}
    for name, fmt in writes.items():
        repo = db._map[name.encode()].repo
        for i in range(repo._key_cap - repo._tbl.rows()):
            db.apply(resp, (fmt % (b"warm%d" % i)).split(b" "))
    db.drain_all()
    shift = udev.narrow_shift(1)
    for card in dict.fromkeys(db.mesh.keys_devices):
        def plane(shape, fill):
            return torch.full(shape, fill, dtype=torch.int32, device=card)

        pad = int(udev.PAD32)
        doc = udev.DocBatch(plane((1, 4), pad), plane((1, 4), -1), plane((1, 1), 0),
                            plane((1, 4), pad))
        udev.join_rows(doc, doc, shift)
        ures.fold_flat(udev.DocBatch(*(p.unsqueeze(1).contiguous() for p in doc)), shift)
    for card in dict.fromkeys(db.mesh.keys_devices):
        if card.type == "cuda":
            torch.cuda.synchronize(card)
