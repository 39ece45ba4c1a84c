"""GCOUNT / PNCOUNT repos: device-resident counter keyspaces.

The port of jylis_tpu/models/repo_counters.py. The whole keyspace of a
type is ONE (keys x replicas) plane per polarity (ops/gcount,
ops/pncount). Local INCs and incoming anti-entropy deltas
funnel into a coalesced pending batch that drains as one fused
join + row-sum kernel launch; the row sums feed a host value cache, so
GET is a table lookup and the device only ever sees whole batches.

Host bookkeeping (keys, own contributions, value cache, dirty/pending/
foreign flags) lives behind the table backends in counter_table.py:
the native serving engine's tables (``engine="auto"``, the default) --
the SAME state the server's native burst applier mutates, so commands
settled in C++ and Python-side drains and flushes share one source of
truth -- or the pure-Python oracle (``engine="python"``). Foreign delta
columns (sparse per-replica maps from the cluster) join into dense u64
host planes, (rows x replica columns) per polarity, a converge slice at
a time; a drain gathers its rows from them in one pass, merges the
engine's exported pending-own values, and its row sums go back to the
engine as u64 bit patterns.

Delta wire shape: GCOUNT -> dict {replica_id: u64}; PNCOUNT -> a
(p_dict, n_dict) pair. Outbound deltas carry only this node's own column
(absolute values — joinable delta-state), which the table tracks exactly,
so flushes never need a device read.

Drains are staged (ops/staging.py, parallel/sharded.py
``drain_unrouted_g`` / ``_pn``): the batch's rows and delta columns are
written straight into pinned host memory, copied to the card in one
transfer, joined in one launch and read back in one copy. A dense drain
takes the same compact batch: its kernel walks every row of the state
and finds each row's staged slot through the keyspace's slot map, so no
K-long plane is built on the host or copied either way.

Mesh mode (``mesh``, parallel/mesh.py): the keyspace lives as one state
per keys shard, a contiguous block of key rows on that shard's device
(the per-type actor keyspace of repo_manager.pony:92-93 becomes
per-device key blocks). The sparse drain is the same unrouted call: the
kernel finds each row's shard among the card's shards itself, so the
host routes nothing and pads nothing, and a drain makes one launch per
card. Dense drains run only without a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gcount, planes, pncount
from ..native.engine import G as ENG_G, PN as ENG_PN, resolve_engine
from ..parallel import Keyspace, drain_unrouted_g, drain_unrouted_pn, resolve_mesh
from ..utils.metrics import resolve_registry, timed_drain
from .base import ParseError, bucket, need, parse_u64, U64_MAX
from .counter_table import NativeTable, PyTable
from .help import RepoHelp

GCOUNT_HELP = RepoHelp("GCOUNT", {"GET": "key", "INC": "key value"})
PNCOUNT_HELP = RepoHelp(
    "PNCOUNT", {"GET": "key", "INC": "key value", "DEC": "key value"}
)


# The four drains of jylis_tpu/models/repo_counters.py:54-79. Each joins
# the batch into the state IN PLACE and returns the row sums as int64
# bits: the in-place update takes the place of JAX's donate_argnums.
# On a CUDA state each launches one hand-written kernel. The sparse two
# also take the ShardTable of one card's shards, and the staged ``out``.
def _drain_g(state, ki, d, out=None):
    return gcount.drain_sparse(state, ki, d, out)


def _drain_pn(state, ki, dp, dn, out=None):
    return pncount.drain_sparse(state, ki, dp, dn, out)


# dense drains: when a batch covers most of the keyspace (a full
# anti-entropy sweep), one walk streams the state once in row order
# instead of paying random-access gathers and scatters. The batch stays
# compact (the staged rows and delta rows); the walk finds each row's
# slot through the keyspace's slot map. Each takes the single device's
# DensePlan and the staged ``out``; returns (every row's sum, out).
def _drain_g_dense(plan, ki, d, out=None):
    return gcount.drain_dense(plan, ki, d, out)


def _drain_pn_dense(plan, ki, dp, dn, out=None):
    return pncount.drain_dense(plan, ki, dp, dn, out)


# a batch covering >= 1/DENSE_FRACTION of the keyspace drains dense: the
# sparse composite's random accesses cost far more per row than streaming
DENSE_FRACTION = 4


def _wrap_i64(v: int) -> int:
    """Wrap into signed-64 range (the reference's modular (p-n).i64())."""
    return ((v + (1 << 63)) & U64_MAX) - (1 << 63)


class _CounterRepo:
    """Shared machinery; subclasses bind the ops module and command set."""

    def __init__(
        self,
        identity: int,
        key_cap: int = 1024,
        rep_cap: int = 8,
        device="cuda",
        mesh="auto",
        engine="auto",
    ):
        self._identity = identity
        self._device = torch.device(device)
        self._rids: dict[int, int] = {}  # replica id -> column
        # mesh mode: "auto" shards over every visible card when there
        # are several (parallel/mesh.serving_mesh)
        self._ks = Keyspace(resolve_mesh(mesh, self._device), self._device)
        self._key_cap = self._ks.round_cap(key_cap)
        self._rep_cap = rep_cap
        self._ks.init(self._key_cap, lambda n, d: self._ops.init(n, rep_cap, d))
        self.engine = engine = resolve_engine(engine)  # shared when given
        self._tbl = (
            NativeTable(engine, self._which) if engine is not None else PyTable()
        )
        # foreign delta columns, joined a converge slice at a time into
        # dense u64 planes indexed (polarity, row, replica column):
        # _fpend, the window's pending join, which a drain gathers and
        # then zeroes at the rows it drained, and _fsync, the CUMULATIVE
        # join of every column ever converged, which never clears, so
        # the per-key canonical state (own joined with foreign) reads
        # host-side with no device pull. They grow by `bucket` as the
        # device state does, apart from it (_fit_planes)
        shape = (self._polarities, self._key_cap, rep_cap)
        self._fpend = np.zeros(shape, np.uint64)
        self._fsync = np.zeros(shape, np.uint64)
        self._frows = np.zeros(self._key_cap, bool)  # rows with _fpend pending
        self._fdirty = np.zeros(self._key_cap, bool)  # converged since the last digest

    def _get_raw(self, key: bytes) -> int:
        """Serving value bits for a key (drains first when foreign deltas
        make the cache stale; local writes keep it exact)."""
        row = self._tbl.find(key)
        if row < 0:
            return 0
        if self._tbl.is_foreign(row):
            self.drain()
        return self._tbl.value(row)

    def _col_for(self, rid: int) -> int:
        col = self._rids.get(rid)
        if col is None:
            col = len(self._rids)
            self._rids[rid] = col
        return col

    @property
    def _state(self):
        """The whole state: the single device's own (drains update it in
        place), or a mesh's shards gathered (a copy, for reading)."""
        return self._ks.whole()

    def _grow_to_fit(self) -> None:
        k = self._ks.round_cap(bucket(max(self._tbl.rows(), 1), self._key_cap))
        r = bucket(max(len(self._rids), 1), self._rep_cap)
        if k != self._key_cap or r != self._rep_cap:
            self._key_cap, self._rep_cap = k, r
            self._ks.grow(lambda st: self._ops.grow(st, k, r))

    def deltas_size(self) -> int:
        return self._tbl.dirty_count()

    def may_drain(self, args: list[bytes]) -> bool:
        """Will this command hit the device? Only a GET over a row holding
        un-drained FOREIGN deltas does (local writes keep the host value
        cache exact); the manager offloads such commands to a thread."""
        if len(args) < 2 or args[0] != b"GET":
            return False
        row = self._tbl.find(args[1])
        return row >= 0 and self._tbl.is_foreign(row)

    def _fit_planes(self, rows: int) -> None:
        """Grow the foreign planes to hold ``rows`` rows and a column for
        every replica id, by `bucket`, as `_grow_to_fit` grows the device
        state (so a drain's batch is as wide as the state)."""
        _, k, r = self._fpend.shape
        k2 = bucket(max(rows, 1), k)
        r2 = bucket(max(len(self._rids), 1), r)
        if (k2, r2) == (k, r):
            return
        for name in ("_fpend", "_fsync"):
            plane = np.zeros((self._polarities, k2, r2), np.uint64)
            plane[:, :k, :r] = getattr(self, name)
            setattr(self, name, plane)
        for name in ("_frows", "_fdirty"):
            mask = np.zeros(k2, bool)
            mask[:k] = getattr(self, name)
            setattr(self, name, mask)

    def converge(self, key: bytes, delta) -> None:
        self.converge_batch(((key, delta),))

    def converge_batch(self, batch) -> None:
        """Join a slice of deltas [(key, delta)]: one table call upserts
        the keys and marks their rows foreign, then an unsigned max per
        plane takes every (row, replica id, value) of the slice, a key
        repeated in it included. A delta decoded from the wire is read in
        place from the decoder's lists (its ``wire()``); any other
        mapping through its items, counted as ``<TYPE> converge_mapped``
        in SYSTEM METRICS."""
        keys, rids, vals, counts = [], [], [], []  # counts: per key, per polarity
        mapped = 0
        for key, delta in batch:
            keys.append(key)
            wire = getattr(delta, "wire", None)
            if wire is not None:
                r, v, lo, ns = wire()
                hi = lo + sum(ns)
                rids += r[lo:hi]
                vals += v[lo:hi]
                counts += ns
            else:
                mapped += 1
                for d in (delta,) if self._polarities == 1 else delta:
                    rids += d.keys()
                    vals += d.values()
                    counts.append(len(d))
        reg = resolve_registry(self)
        if reg.enabled:
            reg.note_converge_mapped(self.name, mapped)
        if not keys:
            return
        rows = self._tbl.upsert_foreign(keys)
        ids, first, inv = np.unique(np.array(rids, np.uint64), return_index=True,
                                    return_inverse=True)
        ids = ids.tolist()
        col = np.empty(len(ids), np.int64)
        for i in np.argsort(first).tolist():  # new ids take columns in arrival order
            col[i] = self._col_for(ids[i])
        self._fit_planes(int(rows.max()) + 1)
        self._frows[rows] = True
        self._fdirty[rows] = True
        p, k, r = self._fpend.shape
        pol = np.repeat(np.tile(np.arange(p), len(keys)), counts)
        at = (pol * k + np.repeat(np.repeat(rows, p), counts)) * r + col[inv]
        v = np.array(vals, np.uint64)
        np.maximum.at(self._fpend.reshape(-1), at, v)
        np.maximum.at(self._fsync.reshape(-1), at, v)

    def _collect_rows(self):
        """The drain batch: the rows with pending foreign deltas joined
        with the engine's pending-own rows -> (rows, sorted; each
        polarity's (n, R) u64 columns, gathered from the pending plane
        in one pass with the own column max-joined; the batch's key
        count). The count is every pending row, own or foreign: an own
        row with nothing to join (an INC of 0) counts though it joins
        nothing. Reads WITHOUT clearing: the window clears in
        `_finish_drain`, so a device failure mid-drain keeps every
        contribution for the retry."""
        own_rows, vp, vn = self._tbl.export_pending(clear=False)
        own_col = self._col_for(self._identity)
        self._fit_planes(self._tbl.rows())
        own = np.asarray(own_rows, np.int64)
        own_vals = np.array((vp, vn)[: self._polarities], np.uint64)  # (P, len(own))
        live = own_vals.any(axis=0)
        rows = np.union1d(own[live], np.flatnonzero(self._frows))
        idle = int(np.count_nonzero(~live & ~self._frows[own]))
        batch = np.take(self._fpend, rows, axis=1)
        at = np.searchsorted(rows, own[live])
        batch[:, at, own_col] = np.maximum(batch[:, at, own_col], own_vals[:, live])
        return rows, batch, len(rows) + idle

    def _drain(self) -> int:
        """Join every pending row into the device state in one staged
        call per card (the dense drain when the batch covers >=
        1/DENSE_FRACTION of a single device's keyspace, else the sparse
        one; both stage the same compact batch) and hand the rows' sums
        to the table as u64 values. Returns the batch's key count
        (timed_drain's ``keys``); its phases are the registry's
        ``drain.<TYPE>.{collect,fill,launch,wait,finish}`` spans."""
        reg = resolve_registry(self)
        with reg.span(f"drain.{self.name}.collect") as span:
            rows, batch, n = self._collect_rows()
            if not n:
                span.cancel()  # nothing pending: no drain to count
                return 0
            span.items = n
            if not len(rows):
                return n
            self._grow_to_fit()
            dense = self._ks.mesh is None and len(rows) * DENSE_FRACTION >= self._key_cap

        def fill(views, sel):  # the gathered columns, straight into staging
            for view, cols in zip(views, batch):
                view[...] = cols[sel]

        # the int64 bits viewed as u64, never cast: the engine takes u64
        sums = self._staged(rows, fill, dense, reg).view(np.uint64)
        with reg.span(f"drain.{self.name}.finish", len(rows)):
            self._finish_drain(rows, sums)
        return n

    def _finish_drain(self, rows, values_bits) -> None:
        self._tbl.apply_drain(rows, values_bits)
        self._tbl.export_pending(clear=True)  # drain succeeded: clear window
        self._fpend[:, rows] = 0
        self._frows[rows] = False

    # -- sync digest (models/database.py) ------------------------------------

    def sync_dirty_keys(self) -> list[bytes]:
        """Keys whose canonical state may have changed since the last
        digest pass (local INC/DEC and converges); clears."""
        rows = set(self._tbl.export_sync_dirty())
        fresh = np.flatnonzero(self._fdirty)
        self._fdirty[fresh] = False
        rows.update(fresh.tolist())
        return [self._tbl.key_of(r) for r in rows]

    def _sync_cols(self, row: int, polarity: int) -> list[tuple[int, int]]:
        """{rid: max} for one polarity: own contribution joined with the
        cumulative foreign plane -- exactly the column state the device
        converges to, with no device read."""
        d = {}
        if row < self._fsync.shape[1]:
            vals = self._fsync[polarity, row].tolist()
            d = {rid: vals[col] for rid, col in self._rids.items() if vals[col]}
        if self._tbl.own_set(row) & (1 << polarity):
            own = self._tbl.own(row, polarity)
            if own > d.get(self._identity, 0):
                d[self._identity] = own
        return sorted((rid, v) for rid, v in d.items() if v)

    def _sorted_keys(self):
        return sorted(
            (self._tbl.key_of(r), r) for r in range(self._tbl.rows())
        )

    def _dump_rows(self, counts: tuple[np.ndarray, ...], items=None):
        """(key, [{rid: value} per polarity]) for each (key, i) of
        ``items`` (default: every key, sorted, i its row), with each
        polarity's nonzero columns of ``counts[i]`` (u64 rows)."""
        cols = {col: rid for rid, col in self._rids.items()}
        for key, i in self._sorted_keys() if items is None else items:
            yield key, [
                {cols[c]: int(v) for c, v in enumerate(x[i, : len(cols)]) if v}
                for x in counts
            ]

    def _keyed_rows(self, keys):
        """([(key, i)] for those of ``keys`` the table holds, sorted, and
        each polarity's (n, R) u64 counts of their rows): only those rows
        leave the device."""
        found = sorted((k, r) for k in keys if (r := self._tbl.find(k)) >= 0)
        rows = np.fromiter((r for _, r in found), np.int64, len(found))
        counts = [np.zeros((len(rows), self._rep_cap), np.uint64)
                  for _ in range(self._polarities)]
        for part, sel, local in self._ks.split_rows(rows):
            for x, plane in zip(counts, part):
                x[sel] = planes.to_u64_np(plane[torch.from_numpy(local).to(plane.device)])
        return [(key, i) for i, (key, _) in enumerate(found)], counts


class RepoGCOUNT(_CounterRepo):
    name = "GCOUNT"
    help = GCOUNT_HELP
    _ops = gcount
    _polarities = 1
    _which = ENG_G

    # the JAX package times each type's drain under its own name
    drain = timed_drain("GCOUNT")(_CounterRepo._drain)

    def _staged(self, rows, fill, dense, reg):
        return drain_unrouted_g(self._ks, rows, fill,
                                _drain_g_dense if dense else _drain_g, dense, reg)

    def _get_value(self, key: bytes) -> int:
        return self._get_raw(key)

    def sync_canon(self, key: bytes) -> bytes | None:
        row = self._tbl.find(key)
        if row < 0:
            return None
        cols = self._sync_cols(row, 0)
        return repr(cols).encode() if cols else None

    # -- commands (repo_gcount.pony:25-60) ---------------------------------

    def apply(self, resp, args: list[bytes]) -> bool:
        op = need(args, 0)
        if op == b"GET":
            resp.u64(self._get_value(need(args, 1)))
            return False
        if op == b"INC":
            key = need(args, 1)
            amount = parse_u64(need(args, 2))
            self._tbl.inc(self._tbl.upsert(key), 0, amount)
            resp.ok()
            return True
        raise ParseError()

    # -- lattice plumbing ---------------------------------------------------

    def flush_deltas(self):
        rows, op, _on, _sb = self._tbl.export_dirty()
        return sorted(
            (self._tbl.key_of(r), {self._identity: int(v)})
            for r, v in zip(rows, op)
        )

    def dump_state(self):
        """Full state in the wire-delta shape, keys sorted."""
        self.drain()
        counts = gcount.to_counts(self._state)
        return [(key, d) for key, (d,) in self._dump_rows((counts,)) if d]

    def dump_keys(self, keys):
        """``dump_state()`` restricted to ``keys`` (the range sync's
        serve): the same entries in the same order, reading only those
        keys' rows from the device."""
        self.drain()
        items, counts = self._keyed_rows(keys)
        return [(key, d) for key, (d,) in self._dump_rows(counts, items) if d]

    def load_state(self, batch) -> None:
        """Converge a snapshot's or a journal's batch. This node's own
        column is its private monotonic state: it is joined into the
        table's own counter too, or the next INC would vanish under the
        pending max."""
        batch = list(batch)
        self.converge_batch(batch)
        for key, delta in batch:
            if self._identity in delta:
                self._tbl.own_max(
                    self._tbl.find(key), 0, delta[self._identity]
                )


class RepoPNCOUNT(_CounterRepo):
    name = "PNCOUNT"
    help = PNCOUNT_HELP
    _ops = pncount
    _polarities = 2
    _which = ENG_PN

    drain = timed_drain("PNCOUNT")(_CounterRepo._drain)

    def _staged(self, rows, fill, dense, reg):
        return drain_unrouted_pn(self._ks, rows, fill,
                                 _drain_pn_dense if dense else _drain_pn, dense, reg)

    def _get_value(self, key: bytes) -> int:
        return _wrap_i64(self._get_raw(key))

    def sync_canon(self, key: bytes) -> bytes | None:
        row = self._tbl.find(key)
        if row < 0:
            return None
        p = self._sync_cols(row, 0)
        n = self._sync_cols(row, 1)
        return repr((p, n)).encode() if p or n else None

    # -- commands (repo_pncount.pony:26-67) --------------------------------

    def apply(self, resp, args: list[bytes]) -> bool:
        op = need(args, 0)
        if op == b"GET":
            resp.i64(self._get_value(need(args, 1)))
            return False
        if op in (b"INC", b"DEC"):
            key = need(args, 1)
            amount = parse_u64(need(args, 2))
            self._tbl.inc(
                self._tbl.upsert(key), 0 if op == b"INC" else 1, amount
            )
            resp.ok()
            return True
        raise ParseError()

    def flush_deltas(self):
        rows, op, on, sb = self._tbl.export_dirty()
        out = []
        for r, p, n, bits in zip(rows, op, on, sb):
            dp = {self._identity: int(p)} if bits & 1 else {}
            dn = {self._identity: int(n)} if bits & 2 else {}
            out.append((self._tbl.key_of(r), (dp, dn)))
        out.sort()
        return out

    def dump_state(self):
        """Full state in the wire-delta shape, keys sorted."""
        self.drain()
        return [
            (key, (dp, dn))
            for key, (dp, dn) in self._dump_rows(pncount.to_counts(self._state))
            if dp or dn
        ]

    def dump_keys(self, keys):
        """``dump_state()`` restricted to ``keys``, reading only their rows."""
        self.drain()
        items, counts = self._keyed_rows(keys)
        return [(key, (dp, dn)) for key, (dp, dn) in self._dump_rows(counts, items)
                if dp or dn]

    def load_state(self, batch) -> None:
        """As RepoGCOUNT.load_state, for each polarity's own column."""
        batch = list(batch)
        self.converge_batch(batch)
        for key, (dp, dn) in batch:
            row = self._tbl.find(key)
            if self._identity in dp:
                self._tbl.own_max(row, 0, dp[self._identity])
            if self._identity in dn:
                self._tbl.own_max(row, 1, dn[self._identity])
