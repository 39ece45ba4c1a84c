"""TLOG repo: device-resident timestamped-log keyspace.

The port of jylis_tpu/models/repo_tlog.py (reference analog:
repo_tlog.pony:16-111). The keyspace is the ops/tlog plane block
(narrow 2-plane layout until the first 64-bit timestamp widens it);
local INS and incoming delta logs buffer host-side per key and drain as
ONE batched merge launch at write thresholds and snapshots. TRIM/TRIMAT/
CLR fuse into that same launch (the kernel's per-row count column), and
the returned (length, cutoff) pairs maintain the host caches. Reads never
drain: GET/SIZE/CUTOFF serve the exact merged view (union + dedup +
cutoff filter over the drained base and the pending buffer, memoised per
row); the only device touch a read can make is the one-row gather that
rebuilds the render base after a drain whose merged view was not
current.

Host bookkeeping lives behind the table backends in tlog_table.py: the
native serving engine's TLOG table (``engine="auto"``, the same state the
server's burst applier mutates, so INS/SIZE/GET/CUTOFF settled in C++ and
Python-side drains and flushes share one source of truth) or the
pure-Python oracle (``engine="python"``).

Mesh mode (``mesh``, parallel/mesh.py) mirrors the counter and TREG
repos: the segment tensors live as one block of key rows per keys shard,
always in the wide (3-plane) layout, and drains and trims route to the
shards as one sparse drain launch per shard
(parallel/sharded.drain_sharded_tlog), with the same overflow-retry
contract.

Delta wire shape: (entries: list[(value: bytes, ts: u64)], cutoff: u64).
"""

from __future__ import annotations

import numpy as np
import torch

from ..native.engine import resolve_engine
from ..ops import planes, tlog
from ..ops.interner import Interner
from ..parallel import Keyspace, drain_sharded_tlog, resolve_mesh
from ..utils.metrics import timed_drain
from .base import PAD_ROW, ParseError, bucket, need, parse_opt_count, parse_u64
from .help import RepoHelp
from .tlog_table import (
    PENDING_DRAIN_THRESHOLD,
    ROW_DRAIN_THRESHOLD,
    NativeTlogTable,
    PyTlogTable,
)

# interner compaction: once the table holds this many more ids than live
# log entries, rebuild it from the live set (ops/interner.compact) so
# INS/TRIM churn can't grow host memory without bound
COMPACT_SLACK = 8192

TLOG_HELP = RepoHelp(
    "TLOG",
    {
        "GET": "key [count]",
        "INS": "key value timestamp",
        "SIZE": "key",
        "CUTOFF": "key",
        "TRIMAT": "key timestamp",
        "TRIM": "key count",
        "CLR": "key",
    },
)


# The device steps of jylis_tpu/models/repo_tlog.py:69-93. The drains
# update the state IN PLACE and leave every row they flag as overflow
# untouched (JAX returns a new state and the caller keeps the old one on
# overflow). On a CUDA state each launches one hand-written kernel.
def _drain(state, ki, d_ts, d_vid, d_cut, counts):
    """Sparse drain with fused trims: (overflow, length, cutoff) per slot."""
    return tlog.drain_sparse(state, ki, d_ts, d_vid, d_cut, counts)


def _drain_dense(state, d_ts, d_vid, d_cut, trim_ki, counts):
    """Dense drain: the overflow mask, and the state's length and cutoff
    planes themselves (dense key order)."""
    ovf = tlog.drain_dense(state, d_ts, d_vid, d_cut, trim_ki, counts)
    return ovf, state.length, state.cutoff


def _get_row(state, k: int):
    """One row gathered and decoded: (ts as u64, vid) host arrays."""
    ts, vid, _length = tlog.read_row(state, k)
    return planes.to_u64_np(ts), vid.cpu().numpy()


class RepoTLOG:
    name = "TLOG"
    help = TLOG_HELP

    def __init__(self, identity: int, key_cap: int = 1024, len_cap: int = 16,
                 device="cuda", mesh="auto", engine="auto"):
        # identity unused: log entries carry no replica identity
        self._device = torch.device(device)
        self._ks = Keyspace(resolve_mesh(mesh, self._device), self._device)
        self._key_cap = self._ks.round_cap(key_cap)
        self._len_cap = len_cap
        # mesh mode always uses the wide layout: one fixed plane set for
        # every shard's drain
        wide = self._ks.mesh is not None
        self._ks.init(self._key_cap,
                      lambda n, d: tlog.init(n, len_cap, wide=wide, device=d))
        self._interner = Interner()
        self.engine = engine = resolve_engine(engine)  # shared when given
        self._tbl = NativeTlogTable(engine) if engine is not None else PyTlogTable()
        # row -> desc-sorted [(ts, value)], the rendered drained part; built
        # on first read, dropped whenever a drain or trim touches the row
        self._render: dict[int, list[tuple[int, bytes]]] = {}
        # row -> (table gen, desc-sorted merged list): the GET-order memo
        # over the table's merged view
        self._sorted: dict[int, tuple[int, list[tuple[int, bytes]]]] = {}

    @property
    def _state(self):
        """The whole state: the single device's own (drains update it in
        place), or a mesh's shards gathered (a copy, for reading)."""
        return self._ks.whole()

    def _grow(self, kcap: int, lcap: int) -> None:
        self._ks.grow(lambda st: tlog.grow(st, kcap, lcap))

    # -- commands (repo_tlog.pony:29-111) ----------------------------------

    def apply(self, resp, args: list[bytes]) -> bool:
        op = need(args, 0)
        if op == b"GET":
            self._cmd_get(resp, need(args, 1), parse_opt_count(args, 2))
            return False
        if op == b"INS":
            key = need(args, 1)
            value = need(args, 2)
            ts = parse_u64(need(args, 3))
            row = self._tbl.upsert(key)
            self._tbl.ins(row, ts, value)
            if (
                self._tbl.pend_len(row) >= ROW_DRAIN_THRESHOLD
                or self._tbl.pend_rows_count() >= PENDING_DRAIN_THRESHOLD
            ):
                self.drain()
            resp.ok()
            return True
        if op == b"SIZE":
            row = self._tbl.find(need(args, 1))
            if row < 0:
                resp.u64(0)
            elif self._tbl.quiescent(row):
                resp.u64(self._tbl.len_cache(row))  # O(1), no gather
            else:
                resp.u64(self._size_nonquiescent(row))
            return False
        if op == b"CUTOFF":
            row = self._tbl.find(need(args, 1))
            resp.u64(self._tbl.cutoff_view(row) if row >= 0 else 0)
            return False
        if op == b"TRIMAT":
            key = need(args, 1)
            ts = parse_u64(need(args, 2))
            self._device_trimat(key, ts)
            resp.ok()
            return True
        if op == b"TRIM":
            key = need(args, 1)
            count = parse_u64(need(args, 2))
            self._device_trim(key, count)
            resp.ok()
            return True
        if op == b"CLR":
            self._device_trim(need(args, 1), 0)
            resp.ok()
            return True
        raise ParseError()

    def _drained_entries(self, row: int) -> list[tuple[int, bytes]]:
        """The drained part of a row, (ts, value) desc — the render cache.
        A miss serves from the table's carried base when it is valid; only
        a base-invalid row pays the ONE device row gather, and then
        repairs the table's base from it."""
        ents = self._render.get(row)
        if ents is None:
            length = self._tbl.len_cache(row)
            if length == 0:
                ents = []
            else:
                base = self._tbl.base_entries(row)
                if base is not None:
                    ents = sorted(base, reverse=True)
                else:
                    ts_row, vid_row = _get_row(*self._ks.locate(row))
                    ents = [
                        (int(ts_row[i]), self._interner.lookup(int(vid_row[i])))
                        for i in range(length)
                    ]
                    ents.sort(reverse=True)
            self._render[row] = ents
        if not self._tbl.base_valid(row):
            self._tbl.set_base(row, ents)
        return ents

    def _size_nonquiescent(self, row: int) -> int:
        """Merged-view size: host-side unless the table's base is unknown
        (a drain landed while the merged memo was stale); then ONE device
        row gather rebuilds it."""
        n = self._tbl.size(row)
        if n < 0:
            self._drained_entries(row)
            n = self._tbl.size(row)
        return n

    def _merged_view(self, row: int) -> tuple[list[tuple[int, bytes]], int]:
        """The exact log as a drain would leave it, (ts, value) desc —
        computed on the host: reads never drain."""
        cut = self._tbl.cutoff_view(row)
        if self._tbl.quiescent(row):
            return self._drained_entries(row), cut
        self._size_nonquiescent(row)  # ensure the merged memo is current
        gen = self._tbl.gen(row)
        hit = self._sorted.get(row)
        if hit is not None and hit[0] == gen:
            return hit[1], cut
        ents = sorted(self._tbl.merged_entries(row), reverse=True)
        self._sorted[row] = (gen, ents)
        return ents, cut

    def _cmd_get(self, resp, key: bytes, count: int) -> None:
        row = self._tbl.find(key)
        if row < 0:
            resp.array_start(0)
            return
        ents, _cut = self._merged_view(row)
        n = min(count, len(ents))
        resp.array_start(n)
        for ts, value in ents[:n]:
            resp.array_start(2)
            resp.string(value)
            resp.u64(ts)

    def _device_trimat(self, key: bytes, ts: int) -> None:
        """TRIMAT == a raised pending cutoff and ONE drain: the merge joins
        pending entries and the new cutoff in the same lattice op."""
        row = self._tbl.upsert(key)
        self._tbl.converge_cutoff(row, ts)
        self.drain()
        self._tbl.delta_raise_cutoff(row, self._tbl.cut_cache(row))

    def _device_trim(self, key: bytes, count: int) -> None:
        """TRIM/CLR: the trim needs the row's pending entries merged
        first, so it rides the drain launch as the fused per-row count."""
        row = self._tbl.upsert(key)
        # counts above any possible length are no-ops (tlog.md:58); clamping
        # to the kernel sentinel keeps huge client counts in int64 range
        self.drain(trim=(row, min(count, tlog.TRIM_NOOP)))
        self._tbl.delta_raise_cutoff(row, self._tbl.cut_cache(row))

    # -- lattice plumbing ---------------------------------------------------

    def converge(self, key: bytes, delta: tuple) -> None:
        # buffer only: the manager drains when drain_overdue trips
        entries, cutoff = delta
        row = self._tbl.upsert(key)
        for value, ts in entries:
            self._tbl.converge_entry(row, ts, value)
        if cutoff:
            self._tbl.converge_cutoff(row, cutoff)

    def deltas_size(self) -> int:
        return self._tbl.deltas_size()

    def may_drain(self, args: list[bytes]) -> bool:
        """Device-bound commands the manager offloads to a thread: trims
        always launch; an INS that will tip a drain threshold does; a
        GET/SIZE that must rebuild the drained base gathers one row."""
        if not args:
            return False
        op = args[0]
        if op in (b"TRIM", b"TRIMAT", b"CLR"):
            return True
        if op == b"INS" and len(args) >= 2:
            row = self._tbl.find(args[1])
            in_row = self._tbl.pend_len(row) if row >= 0 else 0
            return (
                in_row + 1 >= ROW_DRAIN_THRESHOLD
                or self._tbl.pend_rows_count() + 1 >= PENDING_DRAIN_THRESHOLD
            )
        if op in (b"GET", b"SIZE") and len(args) >= 2:
            row = self._tbl.find(args[1])
            if row < 0:
                return False
            if self._tbl.quiescent(row):
                if op == b"SIZE":
                    return False  # O(1) length-cache answer, no gather
                return (
                    row not in self._render
                    and self._tbl.len_cache(row) > 0
                    and not self._tbl.base_valid(row)  # a real device gather
                )
            return self._tbl.size(row) < 0  # gather only when base unknown
        return False

    def drain_overdue(self) -> bool:
        """After a converged batch, the manager drains in a worker thread
        when a threshold trips (the table flags row crossings as it
        appends)."""
        return (
            self._tbl.row_overdue()
            or self._tbl.pend_rows_count() >= PENDING_DRAIN_THRESHOLD
        )

    def flush_deltas(self):
        return self._tbl.flush_deltas()

    # -- sync digest (models/database.py) ------------------------------------

    def sync_dirty_keys(self) -> list[bytes]:
        return [self._tbl.key_of(r) for r in self._tbl.export_sync_dirty()]

    def sync_canon(self, key: bytes) -> bytes | None:
        """Canonical per-key state: the merged view (the exact post-drain
        lattice content, pending included) plus the grow-only cutoff --
        host-side except for the rare base-invalid row's one-row gather."""
        row = self._tbl.find(key)
        if row < 0:
            return None
        ents, cut = self._merged_view(row)
        if not ents and not cut:
            return None
        return repr((ents, cut)).encode()

    # -- snapshot: full state in the wire-delta shape -------------------------

    @staticmethod
    def _decode_planes(st):
        """(ts as u64, vid) of every slot of the planes ``st``."""
        nth = None if st.nth is None else st.nth.cpu().numpy()
        return (tlog.decode_ts_np(nth, st.ntl.cpu().numpy()),
                tlog.decode_vid_np(st.nv.cpu().numpy()))

    def _host_planes(self):
        """(ts as u64, vid) of every slot: one bulk device-to-host pull."""
        return self._decode_planes(self._state)

    def _host_rows(self, rows: np.ndarray):
        """(ts as u64, vid) of the slots of global ``rows``, in order:
        only those rows leave the device."""
        ts = vid = None
        for part, sel, local in self._ks.split_rows(rows):
            idx = torch.from_numpy(local).to(part.ntl.device)
            t, v = self._decode_planes(part._replace(
                nth=None if part.nth is None else part.nth[idx], ntl=part.ntl[idx],
                nv=part.nv[idx]))
            if ts is None:
                ts = np.zeros((len(rows), *t.shape[1:]), t.dtype)
                vid = np.zeros((len(rows), *v.shape[1:]), v.dtype)
            ts[sel], vid[sel] = t, v
        return ts, vid

    def _dump(self, items, all_ts, all_vid):
        """(key, (entries, cutoff)) of each (key, row, i) of ``items`` with
        entries or a cutoff, the entries from row i of the host planes."""
        out = []
        for key, row, i in items:
            length = self._tbl.len_cache(row)
            cutoff = self._tbl.cut_cache(row)
            entries = [
                (self._interner.lookup(int(all_vid[i, j])), int(all_ts[i, j]))
                for j in range(length)
            ]
            if entries or cutoff:
                out.append((key, (entries, cutoff)))
        return out

    def dump_state(self):
        self.drain()
        all_ts, all_vid = self._host_planes()
        return self._dump(
            ((key, row, row) for key, row in sorted(
                (self._tbl.key_of(r), r) for r in range(self._tbl.rows()))),
            all_ts, all_vid)

    def dump_keys(self, keys):
        """``dump_state()`` restricted to ``keys`` (the range sync's
        serve): the same entries in the same order, reading only those
        keys' rows from the device."""
        self.drain()
        found = sorted((k, r) for k in keys if (r := self._tbl.find(k)) >= 0)
        if not found:
            return []
        all_ts, all_vid = self._host_rows(np.fromiter((r for _, r in found), np.int64,
                                                      len(found)))
        return self._dump(((key, row, i) for i, (key, row) in enumerate(found)),
                          all_ts, all_vid)

    def load_state(self, batch) -> None:
        for key, delta in batch:
            self.converge(key, delta)

    def _maybe_compact_interner(self) -> None:
        """Epoch compaction: every value ever INSerted keeps its interner
        slot after being trimmed away. Live ids are exactly the device
        rows' first `length` slots, so pull the vid plane once, rebuild
        the table from the live set, and push the remapped plane back.
        Runs under the repo lock at drain time, before any new pending
        values intern."""
        # the native value interner compacts itself on the same cadence
        # (a cheap floor check per drain; a full walk only once it grew)
        self._tbl.compact_values()
        live = self._tbl.live_total()  # O(1): maintained at finish_row
        if len(self._interner) <= 2 * live + COMPACT_SLACK:
            return
        lengths = {r: self._tbl.len_cache(r) for r in range(self._tbl.rows())}
        all_vid = tlog.decode_vid_np(self._state.nv.cpu().numpy())  # one pull
        rows = [all_vid[row, :n] for row, n in lengths.items() if n > 0]
        flat = np.concatenate(rows) if rows else np.empty(0, np.int64)
        remap = self._interner.compact(flat[flat >= 0])
        new_vid = np.full(all_vid.shape, -1, np.int64)
        for row, n in lengths.items():
            if n > 0:
                src = all_vid[row, :n]
                # mask negatives on application exactly as on collection:
                # remap[-1] would silently alias the last live id
                new_vid[row, :n] = np.where(src >= 0, remap[np.clip(src, 0, None)], -1)
        new_nv = tlog.encode_vid_np(new_vid).view(np.int32)
        self._ks.set_plane("nv", new_nv)

    def _finish_drain(self, updates) -> None:
        """Common drain epilogue: refresh the per-row host caches from the
        kernel's (row, length, cutoff) read-backs, then clear pending."""
        for row, ln, ct in updates:
            self._render.pop(row, None)
            self._sorted.pop(row, None)
            self._tbl.finish_row(row, int(ln), int(ct))
        self._tbl.finish_drain_end()

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        if x.dtype == np.uint64:
            return planes.to_tensor(x, self._device)
        return torch.from_numpy(x).to(self._device)

    @timed_drain("TLOG")
    def drain(self, trim: tuple[int, int] | None = None) -> int:
        """Flush pending entries/cutoffs in one launch; with ``trim`` =
        (row, count), the TRIM/CLR of that row fuses into the SAME launch
        via the kernel's per-row count column (counts of TRIM_NOOP leave
        other rows untouched). Returns the pending rows' count
        (timed_drain's ``keys``), at least 1 for a trim, so a pure trim's
        cost stays visible."""
        row_set = set(self._tbl.touched_rows())
        if not row_set and trim is None:
            return 0
        keys = max(len(row_set), 1)
        self._maybe_compact_interner()
        if trim is not None:
            row_set.add(trim[0])
        rows = sorted(row_set)
        pend = self._tbl.export_pend_bulk(rows)
        cuts_in = {r: self._tbl.pend_cutoff(r) for r in rows}
        # adaptive layout: the narrow (2-plane) state holds every ts below
        # TS32_MAX; the first wider timestamp or cutoff upgrades it
        # losslessly before this drain ships (mesh states start wide)
        if not self._ks.parts[0].wide and (
            any(ts > tlog.TS32_MAX for lst in pend.values() for ts, _ in lst)
            or any(c > tlog.TS32_MAX for c in cuts_in.values())
        ):
            self._ks.map(tlog.widen)
        # capacity: keys, then entry slots (worst case current + pending)
        kcap = self._ks.round_cap(bucket(max(self._tbl.rows(), 1), self._key_cap))
        need_len = max(self._tbl.len_cache(r) + len(pend.get(r, ())) for r in rows)
        lcap = bucket(max(need_len, 1), self._len_cap)
        if kcap != self._key_cap or lcap != self._len_cap:
            self._key_cap, self._len_cap = kcap, lcap
            self._grow(kcap, lcap)
        if self._ks.mesh is not None:
            self._drain_sharded(rows, pend, cuts_in, trim)
            return keys
        while True:
            ld = bucket(max((len(pend.get(r, ())) for r in rows), default=1), 1)
            # dense path (repo_counters precedent): when the batch covers a
            # quarter of the keyspace and rows are narrow, aligned delta
            # rows skip the gather/scatter entirely
            dense = len(rows) * 4 >= self._key_cap and ld <= 64
            nb = self._key_cap if dense else bucket(len(rows))
            slots = rows if dense else range(len(rows))
            d_ts = np.zeros((nb, ld), np.uint64)
            d_vid = np.full((nb, ld), -1, np.int64)
            d_cut = np.zeros(nb, np.uint64)
            for i, row in zip(slots, rows):
                for j, (ts, value) in enumerate(pend.get(row, ())):
                    d_ts[i, j] = ts
                    d_vid[i, j] = self._interner.intern(value)
                d_cut[i] = cuts_in.get(row, 0)
            deltas = tuple(self._tensor(x) for x in (d_ts, d_vid, d_cut))
            if dense:
                tb = bucket(1)
                trim_ki = np.full(tb, PAD_ROW, np.int32)
                counts = np.full(tb, tlog.TRIM_NOOP, np.int64)
                if trim is not None:
                    trim_ki[0], counts[0] = trim
                ovf, lens, cuts = _drain_dense(
                    self._state, *deltas, self._tensor(trim_ki), self._tensor(counts)
                )
                # check EVERY row: the dense rule flags any row whose
                # entries reach into the tail the delta would take,
                # including rows with no pending delta
                flagged = bool(ovf.any().item())
            else:
                ki = np.full(nb, PAD_ROW, np.int32)
                ki[: len(rows)] = rows
                counts = np.full(nb, tlog.TRIM_NOOP, np.int64)
                if trim is not None:
                    counts[rows.index(trim[0])] = trim[1]
                ovf, lens, cuts = _drain(
                    self._state, self._tensor(ki), *deltas, self._tensor(counts)
                )
                flagged = bool(ovf[: len(rows)].any().item())
            if flagged:
                # the flagged rows are untouched and the others merged:
                # grow and drain the same delta again (idempotent)
                self._len_cap *= 2
                self._grow(self._key_cap, self._len_cap)
                continue
            lens = lens.cpu().numpy()
            cuts = planes.to_u64_np(cuts)
            self._finish_drain(zip(rows, lens[slots], cuts[slots]))
            return keys

    def _drain_sharded(self, rows, pend, cuts_in, trim=None) -> None:
        """Mesh-mode drain: per-row deltas route as u64 payload columns
        [ts(ld) | vid(ld) | cutoff | count]; the merge + fused trim runs
        per key block with per-slot lengths and cutoffs read back. On a
        flagged live row: grow and drain the same delta again, as the
        single-device path does (the flagged rows are untouched, the
        others merged, and the merge is idempotent)."""
        while True:
            ld = bucket(max((len(pend.get(r, ())) for r in rows), default=1), 1)
            payload = np.zeros((len(rows), 2 * ld + 2), np.uint64)
            # empty vid slots must read back as -1, not id 0
            payload[:, ld : 2 * ld] = np.uint64(0xFFFFFFFFFFFFFFFF)
            payload[:, 2 * ld + 1] = np.uint64(tlog.TRIM_NOOP)
            for i, row in enumerate(rows):
                for j, (ts, value) in enumerate(pend.get(row, ())):
                    payload[i, j] = ts
                    payload[i, ld + j] = self._interner.intern(value)
                payload[i, 2 * ld] = cuts_in.get(row, 0)
                if trim is not None and row == trim[0]:
                    payload[i, 2 * ld + 1] = trim[1]
            lr, pay, slots = self._ks.route(rows, payload)
            ovf, lens, cuts = drain_sharded_tlog(self._ks.mesh, self._ks.parts, lr, pay, ld)
            live = slots >= 0
            if bool(ovf[live].any()):
                self._len_cap *= 2
                self._grow(self._key_cap, self._len_cap)
                continue
            cuts = cuts.view(np.uint64)
            self._finish_drain(zip(slots[live].tolist(), lens[live], cuts[live]))
            return
