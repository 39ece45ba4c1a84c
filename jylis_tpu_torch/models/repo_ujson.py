"""UJSON repo: causal-document keyspace with device-RESIDENT hot keys.

The port of jylis_tpu/models/repo_ujson.py (reference analog:
repo_ujson.pony:14-110). Variadic argument shape: the first arg
is the database key, the LAST arg is the value/document (for SET/INS/RM),
and everything between is a path of nested-map keys
(repo_ujson.pony:45-49). GET/CLR take key + optional path only.

Every key is in exactly ONE of two modes:

* host mode (``_data``): the authoritative doc is a host ``UJSON``
  (ops/ujson_host.py). Keys are born here; local writes always happen
  here. This is the reference's shape.
* device mode (``_res``): the doc lives as a packed row in the
  device-resident store (ops/ujson_resident.ResidentStore). A key is
  promoted the first time its anti-entropy fan-in earns device work, and
  from then on drains encode ONLY the new deltas and fold them into the
  resident row on the device.

Reads on device-mode keys decode lazily and cache; the cache invalidates
per key when a fold touches the key. Local writes demote the key back to
host mode first (observed-remove mutators need the current doc anyway).
Seqs past u32 exceed every device layout; those keys fall back to host
mode permanently.

Mesh mode (``mesh``, parallel/mesh.py): the resident store's row axis
splits over the mesh's keys shards and its drains use the row-aligned
fold on every shard, like every plane-backed type.

With the node's native serving engine (``engine``, shared with the
server; native/engine.py) validated INS/SET/RM/CLR commands bank in the
engine's write queue and ``_flush_queue`` applies them, in arrival
order, before any other UJSON work reads or writes; GET replies this
repo renders are memoised per (key, path) in the engine, so a repeated
read settles in C++, and every write here drops the overlapping memos.

Delta wire shape: the UJSON object itself (entries + causal context);
from the native codec, a lazy ``ops/ujson_wire.WireUJSON`` that the
resident store encodes straight from its wire bytes.
"""

from __future__ import annotations

import torch

from ..ops.ujson_host import UJSON, parse_value
from ..parallel.mesh import resolve_mesh
from .base import ParseError, need
from .help import RepoHelp

# pending deltas per key at which a SINGLE non-resident key's drain moves
# to the device (and the key becomes resident)
DEVICE_FANIN_MIN = 256
# per-key fan-in worth joining a SEGMENTED drain: when many keys drain
# together the launches are shared, so smaller fan-ins pay their slice
SEG_FANIN_MIN = 64
# buffered remote deltas across all keys before the converge path forces
# a drain (bounds host memory for write-hot, never-read keys)
PENDING_TOTAL_MAX = 4096
# a GET-path drain on a RESIDENT key with fewer pending deltas than this
# serves them host-side into the read cache instead of a device fold: the
# join is idempotent, so the deltas stay pending and fold for real at the
# next full drain
TRICKLE_MAX = 16

UJSON_HELP = RepoHelp(
    "UJSON",
    {
        "GET": "key [key...]",
        "SET": "key [key...] ujson",
        "CLR": "key [key...]",
        "INS": "key [key...] value",
        "RM": "key [key...] value",
    },
)


def _decode_path(parts: list[bytes]) -> tuple[str, ...]:
    return tuple(p.decode("utf-8", "replace") for p in parts)


class RepoUJSON:
    name = "UJSON"
    help = UJSON_HELP

    def __init__(self, identity: int, device="cuda", mesh="auto", engine=None):
        self._identity = identity
        # the native serving engine (None: no write queue, no memo)
        self.engine = engine
        self._device = torch.device(device)
        self._mesh = resolve_mesh(mesh, self._device)
        self._data: dict[bytes, UJSON] = {}
        self._deltas: dict[bytes, UJSON] = {}
        self._pend: dict[bytes, list[UJSON]] = {}  # buffered remote deltas
        self._pend_total = 0  # deltas across keys, O(1) overdue check
        self._overdue = False  # some key's fan-in reached DEVICE_FANIN_MIN
        self._res = None  # ResidentStore, created on first promotion
        self._res_cache: dict[bytes, UJSON] = {}  # decoded device-mode docs
        # pending deltas already host-converged into the cached view (the
        # GET-path trickle), so repeat reads don't re-walk the doc
        self._res_applied: dict[bytes, int] = {}
        self._host_only: set[bytes] = set()  # seqs past u32: never promote
        self._sync_dirty: set[bytes] = set()  # since last digest pass
        # restored documents the next drain folds into resident rows
        # (load_state)
        self._restore_fold: set[bytes] = set()

    # -- mode plumbing -------------------------------------------------------

    def _store(self):
        if self._res is None:
            from ..ops.ujson_resident import ResidentStore

            self._res = ResidentStore(device=self._device, mesh=self._mesh)
        return self._res

    def _is_resident(self, key: bytes) -> bool:
        return self._res is not None and key in self._res

    def _view(self, key: bytes) -> UJSON | None:
        """The current doc for reading: host doc, or the resident row
        decoded through the per-key cache."""
        doc = self._data.get(key)
        if doc is not None:
            return doc
        if self._is_resident(key):
            doc = self._res_cache.get(key)
            if doc is None:
                doc = self._res.read(key)
                self._res_cache[key] = doc
            return doc
        return None

    def _demote(self, key: bytes) -> None:
        """Move a device-mode key back to host mode (before any local
        write)."""
        if not self._is_resident(key):
            return
        doc = self._res_cache.pop(key, None)
        self._res_applied.pop(key, None)
        if doc is not None:
            self._res.discard(key)
        else:
            doc = self._res.evict(key)
        self._data[key] = doc

    def _data_for(self, key: bytes) -> UJSON:
        d = self._data.get(key)
        if d is None:
            d = self._data[key] = UJSON()
        return d

    def _delta_for(self, key: bytes) -> UJSON:
        d = self._deltas.get(key)
        if d is None:
            d = self._deltas[key] = UJSON()
        return d

    def _path_and_value(self, args: list[bytes]):
        """key [path...] value — at least key and value (repo_ujson.pony:45-49)."""
        if len(args) < 3:
            raise ParseError()
        return args[1], _decode_path(args[2:-1]), args[-1].decode("utf-8", "replace")

    def _flush_queue(self) -> None:
        """Apply every write the native engine banked (in arrival order):
        INS, SET, RM and CLR, exactly the sequences their apply() branches
        run; observed-remove ops observe (drain) first. Runs before any
        other UJSON work, so the queue is invisible to reads, flushes,
        drains and snapshots. The engine validated each value token
        before banking it, so these applies cannot fail (their +OK
        replies are already on the wire)."""
        if self.engine is None or not self.engine.uq_count():
            return
        for args in self.engine.uq_drain():
            op = args[0]
            if op == b"CLR":
                key = args[1]
                self._drain_key(key)  # observed-remove: observe first
                self._demote(key)
                doc = self._data.get(key)
                if doc is not None:
                    doc.clr(self._identity, _decode_path(args[2:]), self._delta_for(key))
                self._sync_dirty.add(key)
                continue
            key, path, value = self._path_and_value(args)
            if op == b"SET":
                self._drain_key(key)  # SET clears OBSERVED dots
                self._demote(key)
                self._data_for(key).set_doc(self._identity, path, value, self._delta_for(key))
            elif op == b"RM":
                self._drain_key(key)  # observed-remove: observe first
                self._demote(key)
                doc = self._data.get(key)
                if doc is not None:
                    doc.rm(self._identity, path, value, self._delta_for(key))
            else:  # INS
                self._demote(key)
                self._data_for(key).ins(self._identity, path, value, self._delta_for(key))
            self._sync_dirty.add(key)

    def prepare_flush(self) -> None:
        """Manager hook (flush_async, clean shutdown): apply the write
        queue in a worker thread before the loop-side delta flush (a
        queued write on a resident key demotes, which decodes a row)."""
        self._flush_queue()

    def apply(self, resp, args: list[bytes]) -> bool:
        self._flush_queue()
        op = need(args, 0)
        if op in (b"SET", b"CLR", b"INS", b"RM") and len(args) >= 2:
            self._sync_dirty.add(args[1])
            if self.engine is not None:
                # a write applied on THIS path (deferred by the engine, or
                # a direct apply) drops the overlapping render memos, as a
                # natively banked one does when it banks
                self.engine.uj_invalidate(
                    args[1],
                    args[2:] if op == b"CLR" else args[2:-1],
                    subtree=op in (b"SET", b"CLR"),
                )
        if op == b"GET":
            key = need(args, 1)
            self._drain_key(key)
            doc = self._view(key)
            text = doc.render(_decode_path(args[2:])) if doc is not None else ""
            resp.string(text)
            if self.engine is not None and doc is not None:
                body = text.encode()
                # memo repair: the next GET of this (key, path) settles in
                # C++ on these bytes. Keys with no document never memoise,
                # so a read-only scan over absent keys grows no engine rows
                self.engine.uj_memo_put(key, args[2:], b"$%d\r\n%s\r\n" % (len(body), body))
            return False
        if op == b"SET":
            key, path, value = self._path_and_value(args)
            self._drain_key(key)  # SET clears OBSERVED dots: observe first
            self._demote(key)
            try:
                self._data_for(key).set_doc(
                    self._identity, path, value, self._delta_for(key)
                )
            except ValueError:
                raise ParseError() from None
            resp.ok()
            return True
        if op == b"CLR":
            key = need(args, 1)
            self._drain_key(key)  # observed-remove: observe first
            self._demote(key)
            doc = self._data.get(key)
            if doc is not None:
                doc.clr(self._identity, _decode_path(args[2:]), self._delta_for(key))
            resp.ok()
            return True
        if op == b"INS":
            key, path, value = self._path_and_value(args)
            self._demote(key)
            try:
                self._data_for(key).ins(
                    self._identity, path, value, self._delta_for(key)
                )
            except ValueError:
                raise ParseError() from None
            resp.ok()
            return True
        if op == b"RM":
            key, path, value = self._path_and_value(args)
            self._drain_key(key)  # observed-remove: observe first
            self._demote(key)
            doc = self._data.get(key)
            try:
                if doc is not None:
                    doc.rm(self._identity, path, value, self._delta_for(key))
                else:
                    parse_value(value)  # still validates the value (:107)
            except ValueError:
                raise ParseError() from None
            resp.ok()
            return True
        raise ParseError()

    def converge(self, key: bytes, delta: UJSON) -> None:
        if self.engine is not None:
            # a remote delta can change any subtree: drop every render
            # memo of the key (path () with subtree=True covers all)
            self.engine.uj_invalidate(key, (), subtree=True)
        lst = self._pend.setdefault(key, [])
        lst.append(delta)
        self._pend_total += 1
        self._sync_dirty.add(key)
        if len(lst) >= DEVICE_FANIN_MIN:
            self._overdue = True

    def drain_overdue(self) -> bool:
        """Cluster converge path: the manager offloads a full drain to a
        worker thread when a key's fan-in reaches device size or the
        total buffered deltas hit the cap."""
        return self._overdue or self._pend_total >= PENDING_TOTAL_MAX

    # banked native-queue commands above which even a host-only flush
    # offloads to a thread (a bounded event-loop stall beats none)
    UQ_INLINE_MAX = 1024

    # INS included: it never drains, but on a resident key it demotes —
    # which can decode (a blocking device pull) and must not run on the
    # event loop
    may_drain_OPS = (b"GET", b"SET", b"CLR", b"RM", b"INS")

    def may_drain(self, args: list[bytes]) -> bool:
        """Commands that will touch the device get offloaded to a thread
        (manager.apply_async): a device-sized pending fan-in, a resident
        key whose pending exceeds the trickle budget, or a resident
        read/demotion that must decode (cache miss). A non-empty native
        write queue offloads only when its flush can touch the device (a
        resident store exists, a fan-in reached device size, or the queue
        is large): a small host-only flush runs inline, so the command
        that flushes it opens no lock window that would route every other
        connection's burst off the native path."""
        if self.engine is not None and self.engine.uq_count():
            if (
                self._res is not None
                or self._overdue
                or self._pend_total >= PENDING_TOTAL_MAX
                or self.engine.uq_count() > self.UQ_INLINE_MAX
            ):
                return True
            # host-only flush: fall through to this command's own checks
        if len(args) < 2 or args[0] not in self.may_drain_OPS:
            return False
        key = args[1]
        if len(self._pend.get(key, ())) >= DEVICE_FANIN_MIN:
            return True
        if self._is_resident(key):
            return (
                len(self._pend.get(key, ())) > TRICKLE_MAX
                or key not in self._res_cache
            )
        return False

    def _drain_key(self, key: bytes) -> None:
        deltas = self._pend.get(key)
        if not deltas:
            return
        if self._is_resident(key):
            if len(deltas) <= TRICKLE_MAX:
                # read-path trickle: converge into the cached view on the
                # host; the deltas stay pending for the next full drain
                doc = self._res_cache.get(key)
                if doc is None:
                    doc = self._res.read(key)
                    self._res_cache[key] = doc
                    self._res_applied.pop(key, None)
                for d in deltas[self._res_applied.get(key, 0):]:
                    doc.converge(d)
                self._res_applied[key] = len(deltas)
                return
            self._pend.pop(key)
            self._pend_total -= len(deltas)
            rest = self._resident_fold({key: deltas})
            if not rest:
                return
            deltas = rest[key]
        elif len(deltas) >= DEVICE_FANIN_MIN and key not in self._host_only:
            self._pend.pop(key)
            self._pend_total -= len(deltas)
            rest = self._resident_fold({key: deltas})
            if not rest:
                return
            deltas = rest[key]
        else:
            self._pend.pop(key)
            self._pend_total -= len(deltas)
        doc = self._data_for(key)
        for d in deltas:
            doc.converge(d)

    def _resident_fold(self, groups: dict[bytes, list[UJSON]]):
        """Promote keys as needed and fold their pending deltas into the
        resident rows in one fused drain. Returns the groups that must
        fall back to the host loop (seqs beyond the device layouts)."""
        store = self._store()
        fallback: dict[bytes, list[UJSON]] = {}

        to_admit = [k for k in groups if k not in store]
        if to_admit and store.full():
            # admission gate (ResidentStore.BYTE_BUDGET): further keys
            # serve from the host lattice; resident keys keep their rows
            for k in to_admit:
                fallback[k] = groups[k]
            to_admit = []
        if to_admit:
            items = [(k, self._data.get(k) or UJSON()) for k in to_admit]
            try:
                store.admit(items)
            except OverflowError:
                # isolate the un-encodable docs; the rest still promote
                items, bulk = [], items
                for k, d in bulk:
                    try:
                        store.admit([(k, d)])
                    except OverflowError:
                        self._host_only.add(k)
                        fallback[k] = groups[k]
                        continue
                    items.append((k, d))
            for k, d in items:
                self._data.pop(k, None)
                self._res_cache[k] = d  # row state == this doc, cache it

        fold = {k: v for k, v in groups.items() if k not in fallback}
        try:
            store.fold_in(fold)
        except OverflowError:
            for k, v in fold.items():
                try:
                    store.fold_in({k: v})
                except OverflowError:
                    self._demote(k)
                    self._host_only.add(k)
                    fallback[k] = v
                else:
                    self._res_cache.pop(k, None)
                    self._res_applied.pop(k, None)
        else:
            for k in fold:
                self._res_cache.pop(k, None)
                self._res_applied.pop(k, None)
        return fallback

    # -- sync digest (models/database.py) ------------------------------------

    def sync_prepare(self) -> None:
        """Fold all pending deltas in ONE device/host pass before the
        canon reads (a per-key fold would launch per dirty key); on the
        card this is where the digest runs the fold kernels."""
        self._flush_queue()
        self.drain()

    def sync_dirty_keys(self) -> list[bytes]:
        out = list(self._sync_dirty)
        self._sync_dirty.clear()
        return out

    def sync_canon(self, key: bytes) -> bytes | None:
        """Canonical per-key state: the doc's dot-store + causal context
        with every unordered container sorted, so converged replicas
        (whose dict/set iteration orders differ) hash identically. A
        resident key decodes its row from the device (through the read
        cache)."""
        doc = self._view(key)
        if doc is None or not (doc.entries or doc.ctx.vv or doc.ctx.cloud):
            return None
        ents = sorted(
            (dot, path, token) for dot, (path, token) in doc.entries.items()
        )
        return repr(
            (ents, sorted(doc.ctx.vv.items()), sorted(doc.ctx.cloud))
        ).encode()

    # -- snapshot: full state in the wire-delta shape ------------------------

    def dump_state(self):
        self._flush_queue()
        self.drain()
        docs = dict(self._data)
        if self._res is not None:
            docs.update(self._res.dump())
        # keep docs whose causal context is non-trivial even when empty of
        # entries: the tombstone knowledge is what makes removals stick
        return [
            (key, doc)
            for key, doc in sorted(docs.items())
            if doc.entries or doc.ctx.vv or doc.ctx.cloud
        ]

    def load_state(self, batch) -> None:
        """Converge a snapshot's or a journal's batch. A restored
        document new to this node that holds at least SEG_FANIN_MIN
        entries goes back to a resident row: the next drain (the
        restore's ``drain_all``) folds all of them on the device in one
        shared fold, as a segmented drain folds keys whose fan-in earned
        it. The JAX package lands every restored key on the host (one
        delta a key never reaches SEG_FANIN_MIN); the documents, replies
        and digests are the same either way."""
        for key, delta in batch:
            n = getattr(delta, "n_entries", None)
            if n is None:
                n = len(delta.entries)
            if (n >= SEG_FANIN_MIN and key not in self._data
                    and key not in self._pend and key not in self._host_only
                    and not self._is_resident(key)):
                self._restore_fold.add(key)
            self.converge(key, delta)

    def deltas_size(self) -> int:
        # the banked queue is NOT applied here: this runs on the event
        # loop (the proactive flush), and a queued write on a resident key
        # demotes with a blocking row decode. prepare_flush (threaded)
        # applies it; deltas of still-banked writes ship on the next flush
        return len(self._deltas)

    def flush_deltas(self):
        out = sorted(self._deltas.items())
        self._deltas.clear()
        return out

    def drain(self) -> None:
        self._flush_queue()
        # device pass first: every resident key with pending, plus every
        # key whose fan-in earns a slice of a shared drain, folds at once;
        # what remains (small fan-ins on host-mode keys, or everything on
        # layout overflow) host-loops
        restored, self._restore_fold = self._restore_fold, set()
        groups = {
            k: lst
            for k, lst in self._pend.items()
            if k not in self._host_only
            and (self._is_resident(k) or len(lst) >= SEG_FANIN_MIN
                 or k in restored)
        }
        # SEG_FANIN_MIN only pays when the drain is SHARED: a lone
        # non-resident key below the single-drain crossover stays on the
        # host loop
        if len(groups) == 1:
            k = next(iter(groups))
            if (not self._is_resident(k) and len(groups[k]) < DEVICE_FANIN_MIN
                    and k not in restored):
                groups = {}
        if groups:
            for k in groups:
                self._pend.pop(k)
            self._pend_total -= sum(len(v) for v in groups.values())
            fallback = self._resident_fold(groups)
            for k, lst in fallback.items():
                doc = self._data_for(k)
                for d in lst:
                    doc.converge(d)
        for key in list(self._pend):
            self._drain_key(key)
        self._overdue = False
