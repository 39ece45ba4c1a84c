"""TREG repo: device-mirrored last-writer-wins register keyspace.

The port of jylis_tpu/models/repo_treg.py (reference analog:
repo_treg.pony:11-68). The keyspace is the ops/treg planes.
Local SETs and incoming deltas coalesce on the host per key (the exact
LWW compare with full strings: the host has them), then drain in one
kernel launch whose results feed the host's mirror cache. Prefix ties
that the device cannot settle (flagged rows) are resolved here with the
full strings and patched with a small follow-up scatter.

Host bookkeeping (keys, winner, pending window, delta accumulator) lives
in treg_table.PyTregTable. GET never pays a device round-trip: the
winner is an O(1) host compare.

Mesh mode (``mesh``, parallel/mesh.py) mirrors the counter repos: the
three planes live as one block of key rows per keys shard, and a drain
routes its rows to the shards and launches the sparse drain once per
shard (parallel/sharded.drain_sharded_treg); ties patch through the
routed vid scatter.

Delta wire shape: (value: bytes, ts: u64).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import planes, treg
from ..ops.interner import Interner, prefix_rank
from ..parallel import Keyspace, drain_sharded_treg, patch_sharded_treg, resolve_mesh
from ..utils.metrics import timed_drain
from .base import ParseError, bucket, need, pad_rows, parse_u64
from .help import RepoHelp
from .treg_table import PyTregTable

TREG_HELP = RepoHelp("TREG", {"GET": "key", "SET": "key value timestamp"})

# pending writes/deltas flush to the device once they pile this high:
# reads never need the drain (GET computes the winner on the host), so
# this bounds host memory while keeping device batches large
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
def _drain(state, ki, d_ts, d_rank, d_vid):
    """Sparse drain: (tie, out_ts, out_vid) per slot."""
    return treg.drain_sparse(state, ki, d_ts, d_rank, d_vid)


def _drain_dense(state, d_ts, d_rank, d_vid):
    """Dense drain: the tie mask, and the state planes themselves as the
    outputs (dense key order)."""
    tie = treg.drain_dense(state, d_ts, d_rank, d_vid)
    return tie, state.ts, state.vid


def _patch_vids(state, ki, vids) -> None:
    """Scatter host-resolved vids; pad rows (>= K) are dropped, as JAX's
    mode="drop" scatter drops them."""
    live = planes.live_rows(ki, state.vid.shape[0])
    state.vid[ki[live].long()] = vids[live]


class RepoTREG:
    name = "TREG"
    help = TREG_HELP

    def __init__(self, identity: int, key_cap: int = 1024, device="cuda",
                 mesh="auto"):
        # identity is ignored: LWW needs no replica identity (repo_treg.pony:15)
        self._device = torch.device(device)
        self._ks = Keyspace(resolve_mesh(mesh, self._device), self._device)
        self._key_cap = self._ks.round_cap(key_cap)
        self._ks.init(self._key_cap, treg.init)
        self._interner = Interner()
        self._cache: dict[int, tuple[int, int]] = {}  # row -> (ts, vid)
        self._tbl = PyTregTable()

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

    # -- device drain -------------------------------------------------------

    @timed_drain("TREG", lambda self: self._tbl.pend_count())
    def drain(self) -> None:
        pend = self._tbl.export_pend()  # [(row, ts, value)], not yet cleared
        if not pend:
            return
        cap = self._ks.round_cap(bucket(max(self._tbl.rows(), 1), self._key_cap))
        if cap != self._key_cap:
            self._key_cap = cap
            self._ks.grow(lambda st: treg.grow(st, cap))
        self._maybe_compact_interner()
        if self._ks.mesh is not None:
            self._drain_sharded(pend)
            self._tbl.fold_pend()
            return
        n = len(pend)
        rows = np.fromiter((p[0] for p in pend), np.int64, n)
        dense = n * DENSE_FRACTION >= self._key_cap
        b = self._key_cap if dense else bucket(n)
        slots = rows if dense else np.arange(n)
        d_ts = np.zeros(b, np.uint64)
        d_rank = np.zeros(b, np.uint64)
        d_vid = np.full(b, -1, np.int32)
        vids = np.fromiter(
            (self._interner.intern(p[2]) for p in pend), np.int32, n
        )
        d_ts[slots] = np.fromiter((p[1] for p in pend), np.uint64, n)
        d_rank[slots] = np.fromiter((prefix_rank(p[2]) for p in pend), np.uint64, n)
        d_vid[slots] = vids
        dev = self._device
        deltas = (planes.to_tensor(d_ts, dev), planes.to_tensor(d_rank, dev),
                  torch.from_numpy(d_vid).to(dev))
        if dense:
            tie, out_ts, out_vid = _drain_dense(self._state, *deltas)
        else:
            ki = pad_rows(b)
            ki[:n] = rows
            tie, out_ts, out_vid = _drain(
                self._state, torch.from_numpy(ki).to(dev), *deltas
            )
        tie = tie.cpu().numpy()[slots]
        out_ts = planes.to_u64_np(out_ts)[slots]
        out_vid = out_vid.cpu().numpy()[slots]  # a copy: patched below
        if tie.any():
            # prefix collision: the full-string compare decides; patch
            # the rows where the delta's value is the greater
            patch_ki, patch_vid = [], []
            for i in np.flatnonzero(tie):
                cur_val = self._interner.lookup(int(out_vid[i]))
                if pend[i][2] > cur_val:
                    patch_ki.append(int(rows[i]))
                    patch_vid.append(int(vids[i]))
                    out_vid[i] = vids[i]
            if patch_ki:
                pb = bucket(len(patch_ki))
                pk = pad_rows(pb)  # distinct out-of-range pads drop
                pv = np.full(pb, -1, np.int32)
                pk[: len(patch_ki)] = patch_ki
                pv[: len(patch_vid)] = patch_vid
                _patch_vids(self._state, torch.from_numpy(pk).to(dev),
                            torch.from_numpy(pv).to(dev))
        self._cache.update(
            zip(rows.tolist(), zip(out_ts.tolist(), out_vid.tolist()))
        )
        self._tbl.fold_pend()

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

    def _drain_sharded(self, pend) -> None:
        """Mesh-mode drain: payload columns [ts, rank, vid] route to the
        key blocks; ties come back per slot and resolve on the host as
        the single-device path resolves them, patched with a routed vid
        scatter."""
        rows = [row for row, _ts, _v in pend]
        payload = np.zeros((len(rows), 3), np.uint64)
        values: dict[int, bytes] = {}
        for i, (row, ts, value) in enumerate(pend):
            payload[i, 0] = ts
            payload[i, 1] = prefix_rank(value)
            payload[i, 2] = self._interner.intern(value)  # vids are >= 0
            values[row] = value
        ks = self._ks
        lr, pay, slots = ks.route(rows, payload)
        tie, out_ts, out_vid = drain_sharded_treg(ks.mesh, ks.parts, lr, pay)
        out_ts = out_ts.view(np.uint64)
        patch_rows: list[int] = []
        patch_vids: list[int] = []
        for j in np.flatnonzero(slots >= 0):
            row = int(slots[j])
            if tie[j]:
                cur_val = self._interner.lookup(int(out_vid[j]))
                if values[row] > cur_val:
                    my_vid = self._interner.intern(values[row])
                    patch_rows.append(row)
                    patch_vids.append(my_vid)
                    out_vid[j] = my_vid
            self._cache[row] = (int(out_ts[j]), int(out_vid[j]))
        if patch_rows:
            pp = np.asarray(patch_vids, np.uint64).reshape(-1, 1)
            lr2, p2, _slots = ks.route(patch_rows, pp)
            patch_sharded_treg(ks.mesh, ks.parts, lr2, p2[:, 0].astype(np.int32))
