"""TENSOR: per-coordinate tensor joins on (rows x dims) planes.

The port of jylis_tpu/ops/tensor.py: the state layout, the dense
full-keyspace join, the gathered batch join the repo drains through,
reads and growth. The keyspace is four (N, D) planes of u32 bit
patterns, held in ``int32`` tensors:

    val    raw f32 bit patterns (okey-comparable, see below)
    ts_hi  } u64 per-coordinate timestamp as hi/lo planes
    ts_lo  }
    rid    writer replica-id tiebreak

The join is a per-coordinate lexicographic select: B's cell replaces A's
iff ``(ts_hi, ts_lo, rid, okey(val))`` of B is strictly greater, every
component compared as an unsigned integer. ``okey`` is the
order-preserving u32 transform of f32 bits, so NaN bits are never
compared as floats. The plain versions compare int32 bit patterns as
unsigned through the ``^ 0x80000000`` bias; the CUDA kernel reads them as
``uint32``.

``join_dense`` launches ``tensor_join_dense`` (csrc/tensor_join_dense.cu,
the port of the Pallas kernel bench.py ``_pallas_tensor_join``) on CUDA
tensors and runs ``_join_row`` on CPU ones; either way it updates the
state planes in place, as the Pallas kernel aliases them.
``converge_batch`` does the same for B unique rows: it launches
``tensor_converge_batch`` (csrc/tensor_converge_batch.cu, the same
per-cell select, csrc/tensor_cell.cuh) on CUDA tensors and runs the
gather / ``_join_row`` / scatter on CPU ones. Pad rows (>= N) are
dropped, as JAX's mode="drop" scatter drops them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, planes

I32_MIN = -(1 << 31)  # 0x80000000 as an int32
# per-coordinate identity bits: okey == 0, below every canonical float
BOTTOM_BITS = 0xFFFFFFFF


class TensorState(NamedTuple):
    val: torch.Tensor  # (N, D) int32 holding u32 f32 bit patterns
    ts_hi: torch.Tensor  # (N, D) int32 holding u32
    ts_lo: torch.Tensor  # (N, D) int32 holding u32
    rid: torch.Tensor  # (N, D) int32 holding u32


def init(num_rows: int, dim: int, device="cuda") -> TensorState:
    def z():
        return torch.zeros((num_rows, dim), dtype=torch.int32, device=device)

    # BOTTOM_BITS as an int32 is -1
    return TensorState(torch.full((num_rows, dim), -1, dtype=torch.int32,
                                  device=device), z(), z(), z())


def _ugt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a > b on int32 bit patterns."""
    return (a ^ I32_MIN) > (b ^ I32_MIN)


def _okey(u: torch.Tensor) -> torch.Tensor:
    """Order-preserving u32 transform of f32 bits (tensor_host.okey_u32)."""
    return torch.where(u < 0, ~u, u | I32_MIN)


def _b_wins(a: tuple, b: tuple) -> torch.Tensor:
    """Per-coordinate strict (ts, rid, okey(val)) dominance of B over A —
    a total order on cells, so the select is commutative, associative
    and idempotent."""
    a_v, a_th, a_tl, a_r = a
    b_v, b_th, b_tl, b_r = b
    ts_gt = _ugt(b_th, a_th) | ((b_th == a_th) & _ugt(b_tl, a_tl))
    ts_eq = (b_th == a_th) & (b_tl == a_tl)
    return ts_gt | (
        ts_eq & (_ugt(b_r, a_r) | ((b_r == a_r) & _ugt(_okey(b_v), _okey(a_v))))
    )


def _join_row(a_v, a_th, a_tl, a_r, b_v, b_th, b_tl, b_r):
    """Join cell planes of any matching shape (one row, or all rows)."""
    wins = _b_wins((a_v, a_th, a_tl, a_r), (b_v, b_th, b_tl, b_r))
    return (
        torch.where(wins, b_v, a_v),
        torch.where(wins, b_th, a_th),
        torch.where(wins, b_tl, a_tl),
        torch.where(wins, b_r, a_r),
    )


def join_dense_plain(state: TensorState, deltas: TensorState) -> TensorState:
    """``_join_row`` over the whole keyspace, written into ``state``."""
    for plane, new in zip(state, _join_row(*state, *deltas)):
        plane.copy_(new)
    return state


_JOIN_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [
    ctypes.c_longlong, ctypes.c_void_p]


def _launch_join_dense(state: TensorState, deltas: TensorState) -> None:
    shape = state.val.shape
    dev = state.val.device
    for p in (*state, *deltas):
        if p.device != dev or p.dtype != torch.int32 or not p.is_contiguous():
            raise ValueError(
                "tensor_join_dense: expected contiguous int32 CUDA planes "
                "on one device"
            )
        if p.shape != shape:
            raise ValueError(f"tensor_join_dense: shape {tuple(p.shape)} != {tuple(shape)}")
    if any(s.data_ptr() == d.data_ptr() for s in state for d in deltas):
        raise ValueError("tensor_join_dense: delta aliases state")
    ptrs = [p.data_ptr() for p in (*state, *deltas)]
    vec = int(all(x % 16 == 0 for x in ptrs))
    fn = _build.function("tensor_join_dense", "jt_tensor_join_dense", _JOIN_ARGS)
    with torch.cuda.device(dev):
        rc = fn(vec, *ptrs, state.val.numel(),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "tensor_join_dense")


def join_dense(state: TensorState, deltas: TensorState) -> TensorState:
    """Full-keyspace elementwise join, in place; returns ``state``. Rows
    with no delta carry the identity (BOTTOM_BITS, 0, 0, 0), which never
    wins."""
    if state.val.device.type == "cpu":
        return join_dense_plain(state, deltas)
    if state.val.device.type != "cuda":
        raise ValueError(f"tensor_join_dense: unsupported device {state.val.device}")
    _launch_join_dense(state, deltas)
    _build.count(join_dense, state.val.device)
    return state


_build.counter(join_dense)


def converge_batch_plain(state: TensorState, key_idx, d_val, d_ts_hi,
                         d_ts_lo, d_rid) -> TensorState:
    """Gather the rows ``key_idx`` (pads dropped), ``_join_row`` them with
    the (B, D) delta rows, scatter back in place."""
    live = planes.live_rows(key_idx, state.val.shape[0])
    rows = key_idx[live].long()
    cur = tuple(plane[rows] for plane in state)
    d = tuple(x[live] for x in (d_val, d_ts_hi, d_ts_lo, d_rid))
    for plane, new in zip(state, _join_row(*cur, *d)):
        plane[rows] = new
    return state


_BATCH_ARGS = [ctypes.c_void_p] * 9 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _launch_converge_batch(state: TensorState, key_idx, deltas) -> None:
    what = "tensor_converge_batch"
    n, d = state.val.shape
    b = key_idx.shape[0]
    dev = state.val.device
    if d % 4:
        raise ValueError(
            f"{what}: row length {d} is not a multiple of 4 (rows load as "
            "16-byte vectors)"
        )
    for planes_, shape in ((state, (n, d)), (deltas, (b, d))):
        for p in planes_:
            if p.device != dev or p.dtype != torch.int32 or not p.is_contiguous():
                raise ValueError(
                    f"{what}: expected contiguous int32 CUDA planes on one device"
                )
            if tuple(p.shape) != shape:
                raise ValueError(f"{what}: shape {tuple(p.shape)} != {shape}")
            if p.data_ptr() % 16:
                raise ValueError(f"{what}: plane not 16-byte aligned")
    if (key_idx.device != dev or key_idx.dtype != torch.int32
            or not key_idx.is_contiguous() or key_idx.dim() != 1):
        raise ValueError(
            f"{what}: key_idx must be a contiguous (B,) int32 tensor on the "
            "state's device"
        )
    if any(s.data_ptr() == x.data_ptr() for s in state for x in deltas):
        raise ValueError(f"{what}: delta aliases state")
    fn = _build.function(what, "jt_tensor_converge_batch", _BATCH_ARGS)
    with torch.cuda.device(dev):
        rc = fn(*(p.data_ptr() for p in state), key_idx.data_ptr(),
                *(p.data_ptr() for p in deltas), b, n, d,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, what)


def converge_batch(state: TensorState, key_idx, d_val, d_ts_hi, d_ts_lo,
                   d_rid) -> TensorState:
    """Join one (B, D) delta batch at UNIQUE rows ``key_idx`` ((B,) int32;
    rows >= N are pads and dropped), in place; returns ``state``."""
    if state.val.device.type == "cpu":
        return converge_batch_plain(state, key_idx, d_val, d_ts_hi, d_ts_lo,
                                    d_rid)
    if state.val.device.type != "cuda":
        raise ValueError(
            f"tensor_converge_batch: unsupported device {state.val.device}"
        )
    _launch_converge_batch(state, key_idx, (d_val, d_ts_hi, d_ts_lo, d_rid))
    _build.count(converge_batch, state.val.device)
    return state


_build.counter(converge_batch)


def converge_many(state: TensorState, key_idx, d_val, d_ts_hi, d_ts_lo,
                  d_rid) -> TensorState:
    """Fold N batches ((N, B) and (N, B, D) inputs) one after another.
    Not on the serving path (the repo coalesces per key on the host)."""
    for i in range(key_idx.shape[0]):
        converge_batch(state, key_idx[i], d_val[i], d_ts_hi[i], d_ts_lo[i],
                       d_rid[i])
    return state


def read(state: TensorState, key_idx: torch.Tensor) -> torch.Tensor:
    """Raw f32 bit-pattern rows (int32) for a batch of in-range rows."""
    return state.val[key_idx.long()]


def grow(state: TensorState, num_rows: int, dim: int) -> TensorState:
    """Capacity growth: new cells start at the identity
    (BOTTOM_BITS, 0, 0, 0)."""
    n, d = state.val.shape
    if (num_rows, dim) == (n, d):
        return state
    out = init(num_rows, dim, state.val.device)
    for new, old in zip(out, state):
        new[:n, :d] = old
    return out
