"""TREG: last-writer-wins timestamped register keyspace on torch tensors.

Semantics (docs/_docs/types/treg.md:56-63): a register keeps one
(value, timestamp) pair; pair A beats pair B iff ts_A > ts_B, or the
timestamps are equal and value_A > value_B bytewise. The port of
jylis_tpu/ops/treg.py. The keyspace is three (K,) planes:

    ts    int64 bit patterns of the u64 timestamp (0 when unset)
    rank  int64 bit patterns of the u64 value-prefix rank
          (ops/interner.prefix_rank; 0 when unset)
    vid   int32 interned value id, signed (-1 when unset)

The JAX package keeps ts and rank as hi/lo u32 planes; the port keeps
each u64 as one int64 plane (the ops/planes.py convention) and compares
it unsigned through ``^ (1 << 63)``. ``convert.treg_from_jax`` /
``treg_to_jax`` carry the bits between the two layouts.

The value tie-break runs on the device via the rank. Where ts and rank
are equal but the vids differ (two values sharing their 8-byte prefix)
the drain flags a tie, and the repo settles it on the host with the full
strings (models/repo_treg.py).

``drain_dense`` and ``drain_sparse`` are the serving path's steps, both
on a compact staged batch of unique rows (the dense one, on a single
device, also writes every key's tie flag; ops/staging.py ``DensePlan``):
on a CPU tensor
they run their plain versions below; on a CUDA tensor they launch the
hand-written kernels ``treg_drain_dense`` / ``treg_drain_sparse``
(csrc/treg_drain.cu) or raise. ``converge_dense`` and ``converge_batch``
keep the JAX signatures and go through them. All of them update the
state in place, where JAX returns new arrays into donated buffers.

Contract: one batch holds at most one delta per key (the repo coalesces
per key on the host). The sparse drain takes a state, or the
``ShardTable`` of a keyspace's shards on one card (ops/staging.py), and
global rows; a slot whose row is in none of its shards (the routed
callers' pads: rows >= K, or negative) writes nothing and, in outputs
the wrapper allocates, reports tie 0, ts 0 and vid 0; JAX clamps their
gathers instead, so its pad-slot outputs are row K-1's. The repo reads
live slots only.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, planes
from .staging import MAX_SHARDS, DensePlan, ShardTable

SIGN = planes.SIGN


class TRegState(NamedTuple):
    ts: torch.Tensor  # (K,) int64 bits of u64; 0 when unset
    rank: torch.Tensor  # (K,) int64 bits of u64; 0 when unset
    vid: torch.Tensor  # (K,) int32; -1 when unset


def init(num_keys: int, device="cuda") -> TRegState:
    return TRegState(
        torch.zeros(num_keys, dtype=torch.int64, device=device),
        torch.zeros(num_keys, dtype=torch.int64, device=device),
        torch.full((num_keys,), -1, dtype=torch.int32, device=device),
    )


def _ugt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a > b on int64 bit patterns."""
    return (a ^ SIGN) > (b ^ SIGN)


def _b_wins(a, b):
    """Where pair B strictly beats pair A, plus the on-host tie flag
    (jylis_tpu/ops/treg.py:62-79).

    a/b: tuples (ts, rank, vid). An unset register (vid -1, zeros) loses
    to any set pair: presence (vid >= 0) is the final tie-break."""
    a_ts, a_rank, a_v = a
    b_ts, b_rank, b_v = b
    ts_eq = a_ts == b_ts
    rank_eq = a_rank == b_rank
    wins = _ugt(b_ts, a_ts) | (
        ts_eq & (_ugt(b_rank, a_rank) | (rank_eq & (a_v < 0) & (b_v >= 0)))
    )
    tie = ts_eq & rank_eq & (a_v >= 0) & (b_v >= 0) & (a_v != b_v)
    return wins, tie


# ---- the drain steps: kernels and their plain versions ------------------------


def drain_dense_plain(plan, key_idx, d_ts, d_rank, d_vid, out=None):
    """The plain version of ``drain_dense``: the LWW join at the slots'
    rows, in place, every key's tie flag into the plan's full output (0
    where it has no slot), and (tie, out_ts, out_vid) at the slots."""
    plan = DensePlan.of(plan)
    if out is None:
        out = _zeros_out(key_idx.shape[0], d_vid.device)
    state = plan.state
    slots = planes.live_rows(key_idx, state.vid.shape[0]).nonzero().squeeze(1)
    rows = key_idx[slots].long()
    cur = tuple(p[rows] for p in state)
    d = tuple(x[slots] for x in (d_ts, d_rank, d_vid))
    wins, tie = _b_wins(cur, d)
    new = [torch.where(wins, dv, cv) for dv, cv in zip(d, cur)]
    for p, nv in zip(state, new):
        p[rows] = nv
    full = planes.dense_full(plan, torch.bool)
    full.zero_()
    full[rows] = tie
    tie_o, ts_o, vid_o = out
    tie_o[slots] = tie
    ts_o[slots] = new[0]
    vid_o[slots] = new[2]
    return full, out


def drain_sparse_plain(shards, key_idx, d_ts, d_rank, d_vid, out=None):
    """The plain version of ``drain_sparse``: per part of the table, the
    LWW join of its slots at their local rows, in place, and (tie,
    out_ts, out_vid) at those slots."""
    table = ShardTable.of(shards)
    if out is None:
        out = _zeros_out(key_idx.shape[0], d_vid.device)
    tie, out_ts, out_vid = out
    for part, sel, rows in table.split(key_idx):
        cur = tuple(plane[rows] for plane in part)
        d = tuple(x[sel] for x in (d_ts, d_rank, d_vid))
        wins, tie_sel = _b_wins(cur, d)
        new = [torch.where(wins, dv, cv) for dv, cv in zip(d, cur)]
        for plane, nv in zip(part, new):
            plane[rows] = nv
        tie[sel] = tie_sel
        out_ts[sel] = new[0]
        out_vid[sel] = new[2]
    return out


def _zeros_out(b: int, dev):
    return (torch.zeros(b, dtype=torch.bool, device=dev),
            torch.zeros(b, dtype=torch.int64, device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev))


_P = ctypes.c_void_p
_DENSE_ARGS = [_P] * 8 + [ctypes.c_longlong, _P]
_SPARSE_ARGS = [_P] * 8 + [ctypes.c_longlong, _P]


class _TregTable(ctypes.Structure):
    """csrc/treg_drain.cu's TregTable, field for field."""

    _fields_ = [("ts", _P * MAX_SHARDS), ("rank", _P * MAX_SHARDS),
                ("vid", _P * MAX_SHARDS), ("rows_per_shard", ctypes.c_longlong),
                ("first", ctypes.c_int), ("count", ctypes.c_int)]


class _TregDensePlan(ctypes.Structure):
    """csrc/treg_drain.cu's TregDensePlan, field for field."""

    _fields_ = [("ts", _P), ("rank", _P), ("vid", _P), ("tie", _P),
                ("k", ctypes.c_longlong), ("device", ctypes.c_int)]


_TYPES = (torch.int64, torch.int64, torch.int32)


def _check(what: str, dev, n: int, *planes_) -> None:
    """Every plane: a contiguous (n,) CUDA tensor on ``dev`` of the
    (ts, rank, vid) types, repeated per group of three."""
    for i, p in enumerate(planes_):
        want = _TYPES[i % 3]
        if p.device != dev or p.dtype != want or not p.is_contiguous():
            raise ValueError(
                f"{what}: expected contiguous {want} CUDA planes on {dev}, got "
                f"{p.dtype} on {p.device}"
            )
        if tuple(p.shape) != (n,):
            raise ValueError(f"{what}: shape {tuple(p.shape)} != ({n},)")


def dense_plan(plan: DensePlan):
    """The kernel's launch arguments for ``plan``, built and its planes
    checked once per plan: (ts, rank, vid) contiguous (K,) CUDA planes on
    one device, and the plan's (K,) tie flags, which the kernel clears 16
    bytes at a time. Returns (the C plan, its address, the entry, the
    device, the state's plane pointers)."""
    if plan.c is None:
        st = plan.state
        dev = st.vid.device
        k = st.vid.shape[0]
        _check("treg_drain_dense", dev, k, *st)
        tie = planes.dense_full(plan, torch.bool)
        if tie.data_ptr() % 16:
            raise ValueError("treg_drain_dense: the tie flags must be 16-byte aligned")
        c = _TregDensePlan(*(p.data_ptr() for p in st), tie.data_ptr(), k, dev.index)
        fn = _build.function("treg_drain", "jt_treg_drain_dense", _DENSE_ARGS)
        plan.c = (c, ctypes.addressof(c), fn, dev, frozenset(p.data_ptr() for p in st))
    return plan.c


def _launch_dense(plan: DensePlan, key_idx, d_ts, d_rank, d_vid, out) -> None:
    """O(1) checks per call: the plan's planes were checked when it was
    built; the staged views are checked here."""
    _c, addr, fn, dev, state_ptrs = dense_plan(plan)
    _check_dense_views(key_idx, d_ts, d_rank, d_vid, out, dev, state_ptrs)
    rc = fn(addr, *(p.data_ptr() for p in (key_idx, d_ts, d_rank, d_vid, *out)),
            key_idx.shape[0], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "treg_drain_dense")


def _check_dense_views(key_idx, d_ts, d_rank, d_vid, out, dev, state_ptrs) -> None:
    b = key_idx.shape[0] if key_idx.dim() == 1 else -1
    _check("treg_drain_dense", dev, b, d_ts, d_rank, d_vid)
    if key_idx.device != dev or key_idx.dtype != torch.int32 or not key_idx.is_contiguous():
        raise ValueError("treg_drain_dense: key_idx must be a contiguous (B,) int32 "
                         "tensor on the state's device")
    if any(x.data_ptr() in state_ptrs for x in (d_ts, d_rank, d_vid, *out)):
        raise ValueError("treg_drain_dense: delta aliases state")
    for o, want in zip(out, (torch.bool, torch.int64, torch.int32)):
        if (o.device != dev or o.dtype != want or o.shape != (b,)
                or not o.is_contiguous()):
            raise ValueError(f"treg_drain_dense: outputs must be contiguous ({b},) "
                             f"bool, int64 and int32 tensors on {dev}")


def treg_table(table: ShardTable) -> _TregTable:
    """The kernel's table for ``table``, built and its planes checked
    once per table: every part's (ts, rank, vid) contiguous
    (rows_per_shard,) CUDA planes on one device."""
    if table.c is None:
        dev = table.device
        for part in table.parts:
            _check("treg_drain_sparse", dev, table.rows_per_shard, *part)
        c = _TregTable(rows_per_shard=table.rows_per_shard, first=table.first,
                       count=len(table.parts))
        for i, part in enumerate(table.parts):
            c.ts[i], c.rank[i], c.vid[i] = (p.data_ptr() for p in part)
        table.c = c
    return table.c


def _launch_sparse(table: ShardTable, key_idx, d_ts, d_rank, d_vid, out):
    """O(1) checks per call: the table's planes were checked when it was
    built."""
    c = treg_table(table)
    dev = table.device
    b = key_idx.shape[0] if key_idx.dim() == 1 else -1
    _check("treg_drain_sparse", dev, b, d_ts, d_rank, d_vid)
    if key_idx.device != dev or key_idx.dtype != torch.int32 or not key_idx.is_contiguous():
        raise ValueError(
            "treg_drain_sparse: key_idx must be a contiguous (B,) int32 tensor "
            "on the state's device"
        )
    for o, want in zip(out, (torch.bool, torch.int64, torch.int32)):
        if (o.device != dev or o.dtype != want or tuple(o.shape) != (b,)
                or not o.is_contiguous()):
            raise ValueError(f"treg_drain_sparse: outputs must be contiguous ({b},) "
                             f"bool, int64 and int32 tensors on {dev}")
    fn = _build.function("treg_drain", "jt_treg_drain_sparse", _SPARSE_ARGS)
    with torch.cuda.device(dev):
        rc = fn(ctypes.addressof(c),
                *(p.data_ptr() for p in (key_idx, d_ts, d_rank, d_vid, *out)),
                b, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "treg_drain_sparse")
    return out


def drain_dense(plan, key_idx, d_ts, d_rank, d_vid, out=None):
    """Whole-keyspace drain of a compact batch on one device: join the
    staged (B,) deltas at the UNIQUE rows ``key_idx`` ((B,) int32, in
    [0, K)) into the state of ``plan`` (a ``DensePlan``, or a TRegState
    given one of its own), in place. Rows without a delta keep their
    register and tie 0, as under the JAX package's identity (0, 0, -1).
    Returns (the (K,) bool tie mask, the plan's full output, valid until
    its next drain; ``out``, (tie, out_ts, out_vid) at the slots,
    allocated zeroed when None). A duplicate row is the caller's fault:
    its slots race on one register."""
    plan = DensePlan.of(plan)
    if plan.device.type == "cpu":
        return drain_dense_plain(plan, key_idx, d_ts, d_rank, d_vid, out)
    if out is None:
        out = _zeros_out(key_idx.shape[0], plan.device)
    _launch_dense(plan, key_idx, d_ts, d_rank, d_vid, out)
    _build.count(drain_dense, plan.device)
    return plan.full, out


_build.counter(drain_dense)


def drain_sparse(shards, key_idx, d_ts, d_rank, d_vid, out=None):
    """Batched drain at UNIQUE global rows ``key_idx`` ((B,) int32) over
    ``shards``: a TRegState (one shard holding all of its rows) or the
    ``ShardTable`` of the shards on one card. Joins each slot into the
    shard holding its row, in place, and writes (tie, out_ts, out_vid)
    into ``out`` at each slot whose shard is in the table; with ``out``
    None they are allocated zeroed, so a slot off the table (the routed
    callers' pads: rows >= K) reads 0."""
    table = ShardTable.of(shards)
    if table.device.type == "cpu":
        return drain_sparse_plain(table, key_idx, d_ts, d_rank, d_vid, out)
    if out is None:
        out = _zeros_out(key_idx.shape[0], table.device)
    if key_idx.shape[0]:
        _launch_sparse(table, key_idx, d_ts, d_rank, d_vid, out)
        _build.count(drain_sparse, table.device)
    return out


_build.counter(drain_sparse)


# ---- the JAX package's entry points -------------------------------------------


def converge_batch(state: TRegState, key_idx, d_ts, d_rank, d_vid):
    """Join one delta batch (unique keys) in place: (state, tie (B,))."""
    tie, _ts, _vid = drain_sparse(state, key_idx, d_ts, d_rank, d_vid)
    return state, tie


def converge_dense(state: TRegState, d_ts, d_rank, d_vid):
    """Full-keyspace elementwise LWW join of (K,) delta planes in place:
    (state, tie (K,)), the dense drain with every row a slot."""
    rows = torch.arange(state.vid.shape[0], dtype=torch.int32, device=state.vid.device)
    tie, _out = drain_dense(state, rows, d_ts, d_rank, d_vid)
    return state, tie


def converge_many(state: TRegState, key_idx, d_ts, d_rank, d_vid):
    """Fold N batches ((N, B) inputs) one after another: (state, tie
    (N, B)). Not on the serving path (the repo coalesces per key on the
    host); it exists for offline folds of pre-formed batches."""
    ties = [
        converge_batch(state, key_idx[i], d_ts[i], d_rank[i], d_vid[i])[1]
        for i in range(key_idx.shape[0])
    ]
    return state, torch.stack(ties)


def set_batch(state: TRegState, key_idx, d_ts, d_rank, d_vid):
    """Local SET is lattice-identical to converging a delta (LWW join)."""
    return converge_batch(state, key_idx, d_ts, d_rank, d_vid)


def read(state: TRegState, key_idx: torch.Tensor):
    """GET for a batch of in-range keys -> (ts, vid); vid -1 = nil."""
    rows = key_idx.long()
    return state.ts[rows], state.vid[rows]


def grow(state: TRegState, num_keys: int) -> TRegState:
    k = state.vid.shape[0]
    if num_keys == k:
        return state
    out = init(num_keys, state.vid.device)
    for new, old in zip(out, state):
        new[:k] = old
    return out
