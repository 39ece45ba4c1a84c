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
them with their plain versions and launch counts.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

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
_DENSE_ARGS = [ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_longlong,
               ctypes.c_int, _P]
_SPARSE_ARGS = [ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, _P]


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


def launch_drain_dense(state, deltas) -> torch.Tensor:
    """Run ``counter_drain_dense<NP>`` (NP = len(state)): join ``deltas``
    into ``state`` in place and return the (K,) wrapping row sums
    (sum P - sum N for two polarities) as int64 bits."""
    k, r = state[0].shape
    _check_planes([*state, *deltas], (k, r), "counter_drain_dense")
    if any(s.data_ptr() == d.data_ptr() for s in state for d in deltas):
        raise ValueError("counter_drain_dense: delta aliases state")
    dev = state[0].device
    sums = torch.empty(k, dtype=torch.int64, device=dev)
    fn = _build.function("counter_drain_dense", "jt_counter_drain_dense",
                         _DENSE_ARGS)
    with torch.cuda.device(dev):
        rc = fn(len(state), *_two_ptrs(state),
                *_two_ptrs(deltas), sums.data_ptr(), k, r,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "counter_drain_dense")
    return sums


def launch_drain_sparse(state, key_idx, deltas) -> torch.Tensor:
    """Run ``counter_drain_sparse<NP>``: join the (B, R) ``deltas`` into
    ``state`` at the UNIQUE rows ``key_idx`` (int32; slots >= K are pads),
    in place, and return the (B,) row sums of the joined rows (0 at pad
    slots) as int64 bits."""
    k, r = state[0].shape
    b = key_idx.shape[0]
    _check_planes(state, (k, r), "counter_drain_sparse")
    _check_planes(deltas, (b, r), "counter_drain_sparse")
    if (key_idx.device != state[0].device or key_idx.dtype != torch.int32
            or not key_idx.is_contiguous() or key_idx.dim() != 1):
        raise ValueError(
            "counter_drain_sparse: key_idx must be a contiguous (B,) int32 "
            "tensor on the state's device"
        )
    dev = state[0].device
    sums = torch.empty(b, dtype=torch.int64, device=dev)
    fn = _build.function("counter_drain_sparse", "jt_counter_drain_sparse",
                         _SPARSE_ARGS)
    with torch.cuda.device(dev):
        rc = fn(len(state), *_two_ptrs(state),
                *_two_ptrs(deltas), key_idx.data_ptr(), sums.data_ptr(), b, k,
                r, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "counter_drain_sparse")
    return sums
