"""Carry lattice state between the JAX package's layout and the port's.

The JAX package keeps each u64 counter plane, and TREG's ts and rank, as
hi/lo u32 planes and the TENSOR and TLOG planes as u32; the port keeps
one int64 bit-pattern plane per counter polarity and for TREG's ts and
rank, and int32 bit patterns for TENSOR and the TLOG planes (the TLOG
cutoff as int64 bits); a UJSON DocBatch keeps its int32 narrow dots,
its u64 wide dots as int64 bits and its u32 vv as int32 bits. These
functions take the JAX package's host (numpy) planes and return the
port's state on a given device, and back; the bits are unchanged both
ways, and the result never shares memory with its input.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import gcount, planes, pncount, tensor, tlog, treg, ujson_device


def gcount_from_jax(hi, lo, device="cuda") -> gcount.GCountState:
    return gcount.from_counts(planes.combine64_np(hi, lo), device)


def gcount_to_jax(state: gcount.GCountState) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) u32 planes."""
    return planes.split64_np(gcount.to_counts(state))


def pncount_from_jax(p_hi, p_lo, n_hi, n_lo, device="cuda") -> pncount.PNCountState:
    return pncount.from_counts(
        planes.combine64_np(p_hi, p_lo), planes.combine64_np(n_hi, n_lo), device
    )


def pncount_to_jax(state: pncount.PNCountState):
    """(p_hi, p_lo, n_hi, n_lo) u32 planes."""
    p, n = pncount.to_counts(state)
    return (*planes.split64_np(p), *planes.split64_np(n))


def tensor_from_jax(val, ts_hi, ts_lo, rid, device="cuda") -> tensor.TensorState:
    def plane(x):
        bits = np.ascontiguousarray(x, dtype=np.uint32).view(np.int32)
        return torch.from_numpy(bits).to(device, copy=True)

    return tensor.TensorState(plane(val), plane(ts_hi), plane(ts_lo), plane(rid))


def tensor_to_jax(state: tensor.TensorState):
    """(val, ts_hi, ts_lo, rid) u32 planes."""
    return tuple(p.cpu().numpy().view(np.uint32) for p in state)


def treg_from_jax(ts_hi, ts_lo, rank_hi, rank_lo, vid, device="cuda") -> treg.TRegState:
    def u64(hi, lo):
        return planes.to_tensor(planes.combine64_np(hi, lo), device)

    vid = np.ascontiguousarray(vid, dtype=np.int32)
    return treg.TRegState(
        u64(ts_hi, ts_lo), u64(rank_hi, rank_lo),
        torch.from_numpy(vid).to(device, copy=True),
    )


def treg_to_jax(state: treg.TRegState):
    """(ts_hi, ts_lo, rank_hi, rank_lo, vid): u32 planes and the int32 vid."""
    return (
        *planes.split64_np(planes.to_u64_np(state.ts)),
        *planes.split64_np(planes.to_u64_np(state.rank)),
        state.vid.cpu().numpy().copy(),
    )


def tlog_from_jax(nth, ntl, nv, length, cutoff, device="cuda") -> tlog.TLogState:
    """The JAX ``TLogState`` as host arrays (``nth`` None when narrow)."""
    def plane(x):
        return torch.from_numpy(np.array(x, dtype=np.uint32).view(np.int32)).to(device)

    return tlog.TLogState(
        None if nth is None else plane(nth), plane(ntl), plane(nv),
        torch.from_numpy(np.array(length, dtype=np.int32)).to(device),
        planes.to_tensor(np.asarray(cutoff, np.uint64), device),
    )


def tlog_to_jax(state: tlog.TLogState):
    """(nth or None, ntl, nv, length, cutoff): u32 planes, the int32
    length and the u64 cutoff."""
    def plane(p):
        return None if p is None else p.cpu().numpy().view(np.uint32).copy()

    return (plane(state.nth), plane(state.ntl), plane(state.nv),
            state.length.cpu().numpy().copy(), planes.to_u64_np(state.cutoff).copy())


def docbatch_from_jax(dots, pay, vv, cloud, device="cuda") -> ujson_device.DocBatch:
    """A JAX ``DocBatch``'s host planes (int32 or uint64 dots and cloud,
    int32 pay, uint32 vv) -> the port's planes on ``device``."""
    return ujson_device.to_torch((dots, pay, vv, cloud), device)


def docbatch_to_jax(batch: ujson_device.DocBatch):
    """(dots, pay, vv, cloud) host planes in the JAX dtypes."""
    return tuple(ujson_device.to_numpy(batch))


def resident_state(store) -> dict:
    """What a ResidentStore holds, in the JAX package's terms: its planes
    (JAX dtypes; None before the first admission), dot layout, replica
    budget, rows, free list, width bounds, max seq and interners. Takes
    either package's store (a JAX store's planes read through
    ``np.asarray``), so the tests can compare the two."""
    b = store._batch
    if b is None:
        planes = None
    elif isinstance(b.dots, torch.Tensor):
        planes = docbatch_to_jax(b)
    else:
        planes = tuple(np.asarray(p) for p in b)
    return dict(
        planes=planes, shift=store._shift, nrep=store._nrep, rows=dict(store._rows),
        free=list(store._free), base=(store._base_w, store._base_c),
        floor=(store._floor_w, store._floor_c), inflight=len(store._inflight),
        max_seq=store._max_seq, rid_cols=dict(store._rid_cols),
        pay_rev=list(store._pay_rev), pending_broadcast=len(store._bcast_pend),
    )
