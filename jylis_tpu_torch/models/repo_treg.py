"""TREG repo: device-mirrored last-writer-wins register keyspace.

The port of jylis_tpu/models/repo_treg.py (reference analog:
repo_treg.pony:11-68). The keyspace is the ops/treg planes.
Local SETs and incoming deltas coalesce on the host per key (the exact
LWW compare with full strings: the host has them), then drain in one
kernel launch whose results feed the host's mirror cache. Prefix ties
that the device cannot settle (flagged rows) are resolved here with the
full strings and patched with a small follow-up scatter.

Host bookkeeping (keys, winner, pending window, delta accumulator) lives
behind the table backends in treg_table.py: the native serving engine's
TREG table (``engine="auto"``, the same state the server's burst applier
mutates, so SETs settled in C++ and Python-side drains and flushes share
one source of truth) or the pure-Python oracle (``engine="python"``).
GET never pays a device round-trip: the winner is an O(1) host compare.

Drains are staged (ops/staging.py, parallel/sharded.py
``drain_unrouted_treg``): rows, timestamps, ranks and vids are written
straight into pinned host memory, copied to the card in one transfer,
joined in one launch and the packed (tie, ts, vid) read back in one
copy. The dense drain takes the same compact batch and also clears and
sets every key's tie flag. Mesh mode (``mesh``,
parallel/mesh.py) mirrors the counter repos:
the three planes live as one block of key rows per keys shard, and the
same unrouted drain makes one launch per card, the kernel finding each
row's shard itself; ties patch each shard's vid plane directly.

Delta wire shape: (value: bytes, ts: u64).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import treg
from ..native.engine import resolve_engine
from ..ops.interner import Interner, prefix_rank
from ..parallel import Keyspace, drain_unrouted_treg, fill_from, resolve_mesh
from ..utils.metrics import resolve_registry, timed_drain
from .base import ParseError, bucket, need, parse_u64
from .help import RepoHelp
from .treg_table import NativeTregTable, PyTregTable

TREG_HELP = RepoHelp("TREG", {"GET": "key", "SET": "key value timestamp"})

# pending writes/deltas flush to the device once they pile this high:
# reads never need the drain (GET computes the winner on the host), so
# this bounds host memory while keeping device batches large.
# native/src/serve_engine.cpp TREG_PENDING_DRAIN must match
PENDING_DRAIN_THRESHOLD = 4096

# interner compaction: once the table holds this many more ids than live
# registers, rebuild it from the live set (ops/interner.compact) so value
# churn can't grow host memory without bound
COMPACT_SLACK = 4096

# a batch covering >= 1/DENSE_FRACTION of the keyspace drains through the
# elementwise dense join (each plane streamed once, no random access)
DENSE_FRACTION = 4


# The three device steps of jylis_tpu/models/repo_treg.py:57-71. Each
# updates the state IN PLACE (JAX donates it). On a CUDA state the two
# drains launch one hand-written kernel each.
def _drain(state, ki, d_ts, d_rank, d_vid, out=None):
    """Sparse drain over a state or one card's ShardTable: (tie, out_ts,
    out_vid) per slot, into ``out`` when given (the staged outputs)."""
    return treg.drain_sparse(state, ki, d_ts, d_rank, d_vid, out)


def _drain_dense(plan, ki, d_ts, d_rank, d_vid, out=None):
    """Dense drain of the staged batch on one device through the
    keyspace's DensePlan: (every key's tie mask, (tie, out_ts, out_vid)
    per slot, into ``out`` when given)."""
    return treg.drain_dense(plan, ki, d_ts, d_rank, d_vid, out)


def _patch_vids(ks, rows, vids) -> None:
    """Scatter host-resolved vids at global ``rows`` into the vid plane of
    the shard holding each (plain torch: prefix ties are rare)."""
    for part, sel, local in ks.split_rows(rows):
        dev = part.vid.device
        part.vid[torch.from_numpy(local).to(dev)] = torch.from_numpy(vids[sel]).to(dev)


class RepoTREG:
    name = "TREG"
    help = TREG_HELP

    def __init__(self, identity: int, key_cap: int = 1024, device="cuda",
                 mesh="auto", engine="auto"):
        # identity is ignored: LWW needs no replica identity (repo_treg.pony:15)
        self._device = torch.device(device)
        self._ks = Keyspace(resolve_mesh(mesh, self._device), self._device)
        self._key_cap = self._ks.round_cap(key_cap)
        self._ks.init(self._key_cap, treg.init)
        self._interner = Interner()
        self._cache: dict[int, tuple[int, int]] = {}  # row -> (ts, vid)
        self.engine = engine = resolve_engine(engine)  # shared when given
        self._tbl = NativeTregTable(engine) if engine is not None else PyTregTable()

    @property
    def _state(self):
        """The whole state: the single device's own (drains update it in
        place), or a mesh's shards gathered (a copy, for reading)."""
        return self._ks.whole()

    # -- commands (repo_treg.pony:24-68) -----------------------------------

    def apply(self, resp, args: list[bytes]) -> bool:
        op = need(args, 0)
        if op == b"GET":
            # LWW winner = join(drained cache, un-drained pending) by the
            # exact (ts, value) rule: an O(1) host compare, never a device
            # round-trip
            row = self._tbl.find(need(args, 1))
            cand = self._tbl.winner(row) if row >= 0 else None
            if cand is None:
                resp.null()
            else:
                ts, value = cand
                resp.array_start(2)
                resp.string(value)
                resp.u64(ts)
            return False
        if op == b"SET":
            key = need(args, 1)
            value = need(args, 2)
            ts = parse_u64(need(args, 3))
            row = self._tbl.upsert(key)
            self._tbl.write(row, ts, value)
            # the local delta coalesces by the same LWW rule
            self._tbl.note_delta(row, ts, value)
            if self._tbl.pend_count() >= PENDING_DRAIN_THRESHOLD:
                self.drain()
            resp.ok()
            return True
        raise ParseError()

    def converge(self, key: bytes, delta: tuple) -> None:
        # buffer only: the manager drains when drain_overdue trips
        value, ts = delta
        self._tbl.write(self._tbl.upsert(key), ts, value)

    def load_state(self, batch) -> None:
        """Converge a snapshot's or a journal's batch (buffered; the
        restore's ``drain_all`` lands it on the device)."""
        for key, delta in batch:
            self.converge(key, delta)

    def deltas_size(self) -> int:
        return self._tbl.deltas_size()

    def may_drain(self, args: list[bytes]) -> bool:
        """GET never drains; a SET may trigger the threshold drain, which
        the manager offloads to a thread. +1: the SET about to run adds a
        row, so the threshold it will see inside apply is one higher."""
        return (
            bool(args)
            and args[0] == b"SET"
            and self._tbl.pend_count() + 1 >= PENDING_DRAIN_THRESHOLD
        )

    def drain_overdue(self) -> bool:
        """After a converged batch, the manager drains in a worker thread
        when this trips."""
        return self._tbl.pend_count() >= PENDING_DRAIN_THRESHOLD

    def flush_deltas(self):
        return self._tbl.flush_deltas()

    # -- sync digest (models/database.py) ------------------------------------

    def sync_dirty_keys(self) -> list[bytes]:
        return [self._tbl.key_of(r) for r in self._tbl.export_sync_dirty()]

    def sync_canon(self, key: bytes) -> bytes | None:
        """Canonical per-key state: the LWW winner -- an O(1) host read
        (every converged replica agrees on it by the exact (ts, value)
        rule)."""
        row = self._tbl.find(key)
        w = self._tbl.winner(row) if row >= 0 else None
        return None if w is None else repr(w).encode()

    def dump_state(self):
        """Full state in the wire-delta shape, keys sorted: the host
        winner IS the join the device converges to; the drain brings the
        device mirror up to date first."""
        self.drain()
        return self._tbl.dump()

    def dump_keys(self, keys):
        """``dump_state()`` restricted to ``keys`` (the range sync's
        serve): the same entries in the same order, from those keys'
        winners alone."""
        self.drain()
        out = []
        for key in sorted(keys):
            row = self._tbl.find(key)
            w = self._tbl.winner(row) if row >= 0 else None
            if w is not None:
                out.append((key, (w[1], w[0])))
        return out

    # -- device drain -------------------------------------------------------

    @timed_drain("TREG")
    def drain(self) -> int:
        """Join the pending window into the planes; returns its key count
        (timed_drain's ``keys``). Its phases are the registry's
        ``drain.TREG.{collect,fill,launch,wait,finish}`` spans (collect:
        the pending read and interning up to staging; finish: the tie
        patch and the host mirror)."""
        reg = resolve_registry(self)
        with reg.span("drain.TREG.collect") as span:
            pend = self._tbl.export_pend()  # [(row, ts, value)], not yet cleared
            if not pend:
                span.cancel()  # nothing pending: no drain to count
                return 0
            n = span.items = len(pend)
            cap = self._ks.round_cap(bucket(max(self._tbl.rows(), 1), self._key_cap))
            if cap != self._key_cap:
                self._key_cap = cap
                self._ks.grow(lambda st: treg.grow(st, cap))
            self._maybe_compact_interner()
            rows = np.fromiter((p[0] for p in pend), np.int64, n)
            vids = np.fromiter(
                (self._interner.intern(p[2]) for p in pend), np.int32, n
            )
            ts = np.fromiter((p[1] for p in pend), np.uint64, n)
            rank = np.fromiter((prefix_rank(p[2]) for p in pend), np.uint64, n)
        dense = self._ks.mesh is None and n * DENSE_FRACTION >= self._key_cap
        # fresh host arrays: out_vid is patched below
        tie, out_ts, out_vid = drain_unrouted_treg(
            self._ks, rows, fill_from(ts, rank, vids),
            _drain_dense if dense else _drain, dense, reg)
        with reg.span("drain.TREG.finish", n):
            out_ts = out_ts.view(np.uint64)
            if tie.any():
                # prefix collision: the full-string compare decides; patch
                # the rows where the delta's value is the greater
                patch = []
                for i in np.flatnonzero(tie):
                    cur_val = self._interner.lookup(int(out_vid[i]))
                    if pend[i][2] > cur_val:
                        patch.append(i)
                        out_vid[i] = vids[i]
                if patch:
                    _patch_vids(self._ks, rows[patch], vids[patch])
            self._cache.update(
                zip(rows.tolist(), zip(out_ts.tolist(), out_vid.tolist()))
            )
            self._tbl.fold_pend()
        return n

    def _maybe_compact_interner(self) -> None:
        """Epoch compaction: every value ever SET keeps its interner slot
        until then. The host cache mirrors the device vid plane exactly
        (drain writes both), so when the table outgrows the live
        registers, rebuild it from the cache and REPLACE the device vid
        plane with the host-built remapped mirror: one transfer, no
        kernel. Runs under the repo lock at drain time, before any new
        pending values intern."""
        if len(self._interner) <= 2 * len(self._cache) + COMPACT_SLACK:
            return
        remap = self._interner.compact(
            vid for _ts, vid in self._cache.values() if vid >= 0
        )
        self._cache = {
            row: (ts, int(remap[vid]) if vid >= 0 else -1)
            for row, (ts, vid) in self._cache.items()
        }
        vids_by_row = np.full(self._key_cap, -1, np.int32)
        for row, (_ts, vid) in self._cache.items():
            vids_by_row[row] = vid
        self._ks.set_plane("vid", vids_by_row)
