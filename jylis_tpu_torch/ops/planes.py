"""u64 counter planes stored as int64 bit patterns, and the drain launches.

The JAX package splits every u64 plane into hi/lo u32 planes because the
TPU has no 64-bit integer path. PyTorch has one, but its ``uint64`` lacks
compare, max and ``index_put`` on the CPU, so the port keeps each u64 as
the bit pattern of an ``int64`` element:

* unsigned order compares ``x ^ (1 << 63)`` (the sign bit flipped);
* wrapping add and row sums are plain int64 arithmetic, whose bits are
  the u64 result mod 2^64.

``split64_np`` / ``combine64_np`` convert to and from the JAX layout;
``coalesce`` max-combines duplicate rows of a host delta batch.
``launch_drain_dense`` / ``launch_drain_sparse`` run the two CUDA drain
kernels (``csrc/counter_drain_*.cu``); the GCOUNT and PNCOUNT modules wrap
them with their plain versions and launch counts. Both take a compact
staged batch of unique rows: the sparse kernel with the card's shards as
an ``ops.staging.ShardTable``, the dense one with a single device's
``ops.staging.DensePlan`` (its walk covers every row through the
keyspace's slot map).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .staging import MAX_SHARDS, DensePlan, ShardTable, SlotMap

SIGN = -(1 << 63)  # int64 with only the sign bit set


# ---- host-side helpers -----------------------------------------------------


def split64_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """u64 ndarray -> (hi, lo) u32 ndarrays (the JAX package's planes)."""
    x = np.asarray(x, dtype=np.uint64)
    return (x >> np.uint64(32)).astype(np.uint32), x.astype(np.uint32)


def combine64_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


def coalesce(key_idx: np.ndarray, deltas: np.ndarray):
    """Max-combine duplicate rows of a (B,) x (B, R) u64 delta batch on the
    host, returning unique rows + combined deltas (what converge requires)."""
    key_idx = np.asarray(key_idx)
    uniq, inv = np.unique(key_idx, return_inverse=True)
    out = np.zeros((len(uniq),) + deltas.shape[1:], np.uint64)
    np.maximum.at(out, inv, np.asarray(deltas, np.uint64))
    return uniq.astype(key_idx.dtype), out


def to_tensor(x: np.ndarray, device) -> torch.Tensor:
    """u64 ndarray -> int64 tensor of the same bits on ``device``; a
    copy, never a view of ``x`` (the ops join into their state in place)."""
    bits = np.ascontiguousarray(x, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(bits).to(device, copy=True)


def to_u64_np(t: torch.Tensor) -> np.ndarray:
    """int64 bit-pattern tensor -> u64 ndarray on the host."""
    return t.cpu().numpy().view(np.uint64)


# ---- plain tensor ops --------------------------------------------------------


def join_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned u64 max of two bit-pattern tensors."""
    return torch.where((b ^ SIGN) > (a ^ SIGN), b, a)


def live_rows(key_idx: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Mask of batch slots whose row is a real row (pad rows are >= K;
    JAX drops their scatters with mode="drop", torch would raise)."""
    return (key_idx >= 0) & (key_idx < num_rows)


def scatter_join(x: torch.Tensor, key_idx: torch.Tensor, d: torch.Tensor):
    """Join a (B, R) delta batch into (K, R) ``x`` at UNIQUE rows, in
    place; slots with a row >= K are skipped. Returns ``x``."""
    live = live_rows(key_idx, x.shape[0])
    rows = key_idx[live].long()
    x[rows] = join_max(x[rows], d[live])
    return x


def rowsum64(x: torch.Tensor) -> torch.Tensor:
    """Wrapping u64 sum along the last axis (int64 bits)."""
    return x.sum(dim=-1)


# ---- CUDA drain launches ------------------------------------------------------

_P = ctypes.c_void_p
_DENSE_ARGS = [ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_longlong, _P]
_SPARSE_ARGS = [ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_longlong,
                ctypes.c_int, _P]


class _CounterTable(ctypes.Structure):
    """csrc/counter_drain_sparse.cu's CounterTable, field for field."""

    _fields_ = [("p", _P * MAX_SHARDS), ("n", _P * MAX_SHARDS),
                ("rows_per_shard", ctypes.c_longlong), ("first", ctypes.c_int),
                ("count", ctypes.c_int)]


def _check_planes(planes, shape, what: str) -> None:
    """The kernels load rows as 16-byte vectors: every plane must be a
    contiguous int64 CUDA tensor of ``shape`` with an even row length and
    a 16-byte aligned start (the repos' planes always are: their replica
    capacity is a power of two >= 8, and each plane is its own
    allocation)."""
    if shape[-1] % 2:
        raise ValueError(f"{what}: row length {shape[-1]} is odd")
    for p in planes:
        if p.device.type != "cuda":
            raise ValueError(f"{what}: expected a CUDA tensor, got {p.device}")
        if p.dtype != torch.int64 or not p.is_contiguous():
            raise ValueError(f"{what}: expected contiguous int64 planes")
        if tuple(p.shape) != tuple(shape):
            raise ValueError(f"{what}: shape {tuple(p.shape)} != {tuple(shape)}")
        if p.device != planes[0].device:
            raise ValueError(f"{what}: planes on different devices")
        if p.data_ptr() % 16:
            raise ValueError(f"{what}: plane not 16-byte aligned")


def _two_ptrs(planes):
    """(s0, s1) pointers for 1 or 2 polarities (s1 unused for GCOUNT)."""
    return [p.data_ptr() for p in planes] + [None] * (2 - len(planes))


class _CounterDensePlan(ctypes.Structure):
    """csrc/counter_drain_dense.cu's CounterDensePlan, field for field."""

    _fields_ = [("s0", _P), ("s1", _P), ("map", _P), ("sums", _P),
                ("rows", ctypes.c_longlong), ("cols", ctypes.c_int),
                ("device", ctypes.c_int)]


def dense_full(plan: DensePlan, dtype) -> torch.Tensor:
    """The plan's (K,) output for every row, allocated on first use."""
    if plan.full is None:
        plan.full = torch.empty(plan.state[0].shape[0], dtype=dtype, device=plan.device)
    return plan.full


def mapped_plan(plan) -> DensePlan:
    """``plan`` (a ``DensePlan``, or a counter state given one of its
    own) as a plan the counters' walk can take: one without a slot map
    gets a fresh one."""
    plan = DensePlan.of(plan)
    if plan.slots is None:
        plan.slots = SlotMap(plan.state[0].shape[0], plan.device)
    return plan


def walk_slots(slot_map: torch.Tensor, key_idx: torch.Tensor):
    """The plain versions' scatter and walk of a ``SlotMap``'s map:
    ``map[key_idx[s]] = s`` for each slot whose row lies in [0, K), then
    (the rows holding a slot, in row order, and their slots). The caller
    joins, then resets those rows to -1, as the kernels' walk does."""
    live = live_rows(key_idx, slot_map.shape[0])
    slots = torch.arange(key_idx.shape[0], dtype=torch.int32, device=slot_map.device)
    slot_map[key_idx[live].long()] = slots[live]
    rows = (slot_map >= 0).nonzero().squeeze(1)
    return rows, slot_map[rows].long()


def counter_plan(plan: DensePlan):
    """The kernel's launch arguments for ``plan``, built and its planes
    checked once per plan: the state's planes (one per polarity)
    contiguous int64 (K, R) CUDA tensors on one device, 16-byte aligned,
    R even. Returns (the C plan's address, the entry, the device, the
    state's plane pointers, R)."""
    if plan.c is None:
        st = plan.state
        k, r = st[0].shape
        _check_planes(st, (k, r), "counter_drain_dense")
        dev = st[0].device
        sums = dense_full(plan, torch.int64)
        c = _CounterDensePlan(map=plan.slots.map.data_ptr(), sums=sums.data_ptr(),
                              rows=k, cols=r, device=dev.index)
        c.s0, c.s1 = _two_ptrs(st)
        fn = _build.function("counter_drain_dense", "jt_counter_drain_dense",
                             _DENSE_ARGS)
        plan.c = (c, ctypes.addressof(c), fn, dev,
                  frozenset(p.data_ptr() for p in st), r)
    return plan.c


def launch_drain_dense(plan: DensePlan, key_idx, deltas, out) -> None:
    """Run ``counter_drain_dense<NP>`` (NP = the state's polarities) with
    ``plan``: join the (B, R) ``deltas`` at the UNIQUE rows ``key_idx``
    ((B,) int32, in [0, K)) into the state through the plan's slot map,
    in place, write every row's sum (sum P - sum N for two polarities)
    into ``plan.full`` and the joined rows' sums into ``out`` (B,) at
    their slots, as int64 bits. Checks are O(1) per call: the plan's
    planes were checked when it was built; the staged views are checked
    here."""
    _c, addr, fn, dev, state_ptrs, r = counter_plan(plan)
    np_ = len(plan.state)
    b = key_idx.shape[0]
    _check_dense_views(key_idx, deltas, out, np_, dev, state_ptrs, r)
    rc = fn(np_, addr, key_idx.data_ptr(), *_two_ptrs(deltas), out.data_ptr(), b,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "counter_drain_dense")


def _check_dense_views(key_idx, deltas, out, np_, dev, state_ptrs, r) -> None:
    """The staged views of one dense launch: what the kernel reads and
    writes besides the plan's own planes."""
    b = key_idx.shape[0] if key_idx.dim() == 1 else -1
    if len(deltas) != np_:
        raise ValueError(f"counter_drain_dense: {len(deltas)} delta planes for "
                         f"{np_} polarities")
    if (key_idx.device != dev or key_idx.dtype != torch.int32
            or not key_idx.is_contiguous() or b < 0):
        raise ValueError("counter_drain_dense: key_idx must be a contiguous (B,) "
                         "int32 tensor on the state's device")
    for d in deltas:
        if (d.device != dev or d.dtype != torch.int64 or not d.is_contiguous()
                or d.shape != (b, r) or d.data_ptr() % 16):
            raise ValueError(f"counter_drain_dense: deltas must be contiguous 16-byte "
                             f"aligned ({b}, {r}) int64 tensors on {dev}")
        if d.data_ptr() in state_ptrs:
            raise ValueError("counter_drain_dense: delta aliases state")
    if (out.device != dev or out.dtype != torch.int64 or not out.is_contiguous()
            or out.shape != (b,)):
        raise ValueError(f"counter_drain_dense: out must be a contiguous ({b},) "
                         f"int64 tensor on {dev}")


def counter_table(table: ShardTable) -> _CounterTable:
    """The kernel's table for ``table``, built and its planes checked
    once per table: every part's planes (one per polarity) contiguous
    int64 (rows_per_shard, R) CUDA tensors on one device, 16-byte
    aligned, R even."""
    if table.c is None:
        part = table.parts[0]
        r = part[0].shape[-1]
        for st in table.parts:
            if len(st) != len(part):
                raise ValueError("counter_drain_sparse: parts of different types")
            _check_planes(st, (table.rows_per_shard, r), "counter_drain_sparse")
            if st[0].device != part[0].device:
                raise ValueError("counter_drain_sparse: shards on different devices")
        c = _CounterTable(rows_per_shard=table.rows_per_shard, first=table.first,
                          count=len(table.parts))
        for i, st in enumerate(table.parts):
            c.p[i], c.n[i] = _two_ptrs(st)
        table.c = c
    return table.c


def launch_drain_sparse(table: ShardTable, key_idx, deltas, sums) -> torch.Tensor:
    """Run ``counter_drain_sparse<NP>`` (NP = len(deltas)) over the card's
    shards in ``table``: join the (B, R) ``deltas`` at the UNIQUE global
    rows ``key_idx`` ((B,) int32) into the shard holding each, in place,
    and write the joined rows' sums (sum P - sum N for two polarities) as
    int64 bits into ``sums`` (B,) at each slot of the table. A slot whose
    shard is not in the table writes nothing. Checks are O(1) per call:
    the table's planes were checked when it was built."""
    c = counter_table(table)
    part = table.parts[0]
    dev = part[0].device
    r = part[0].shape[1]
    b = key_idx.shape[0] if key_idx.dim() == 1 else -1
    if len(deltas) != len(part):
        raise ValueError(f"counter_drain_sparse: {len(deltas)} delta planes for "
                         f"{len(part)} polarities")
    if (key_idx.device != dev or key_idx.dtype != torch.int32
            or not key_idx.is_contiguous() or key_idx.dim() != 1):
        raise ValueError(
            "counter_drain_sparse: key_idx must be a contiguous (B,) int32 "
            "tensor on the state's device"
        )
    for d in deltas:
        if (d.device != dev or d.dtype != torch.int64 or not d.is_contiguous()
                or tuple(d.shape) != (b, r) or d.data_ptr() % 16):
            raise ValueError(
                f"counter_drain_sparse: deltas must be contiguous 16-byte aligned "
                f"({b}, {r}) int64 tensors on {dev}")
    if (sums.device != dev or sums.dtype != torch.int64 or not sums.is_contiguous()
            or tuple(sums.shape) != (b,)):
        raise ValueError(f"counter_drain_sparse: sums must be a contiguous ({b},) "
                         f"int64 tensor on {dev}")
    fn = _build.function("counter_drain_sparse", "jt_counter_drain_sparse",
                         _SPARSE_ARGS)
    with torch.cuda.device(dev):
        rc = fn(len(part), ctypes.addressof(c), key_idx.data_ptr(),
                *_two_ptrs(deltas), sums.data_ptr(), b, r,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "counter_drain_sparse")
    return sums
