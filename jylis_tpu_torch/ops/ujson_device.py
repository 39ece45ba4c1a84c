"""UJSON ORSWOT join as batched device kernels, on torch tensors.

The port of jylis_tpu/ops/ujson_device.py. The host lattice
(``ops/ujson_host.py``) is authoritative for serving; what runs on the
device is the anti-entropy fan-in: joining many deltas into many
documents. A batch of documents is a ``DocBatch`` of padded per-row
planes:

* ``dots (B, L)`` — each entry's causal dot packed as
  ``(replica_col << shift) | seq``, sorted ascending per row,
  pad-filled. The narrow layout (``shift < 32``) is int32, pad
  ``PAD32 = 0x7FFFFFFF``; the wide one (``shift = 32``) keeps the JAX
  package's u64 as int64 bits, pad ``-1`` (all ones). Wide order is
  unsigned: the plain versions sort and search ``x ^ (1 << 63)``, and a
  column is decoded with a logical shift, so a pad never indexes ``vv``
  at -1.
* ``pay (B, L) int32`` — interned (path, value-token) payload id; -1 pad.
* ``vv (B, R)`` — per-replica-column contiguous causal max: the JAX
  package's u32 as int32 bits, compared and added unsigned.
* ``cloud (B, C)`` — context dots beyond the vv, sorted, pad-filled,
  the dots' dtype.

Join of rows a, b (the documented add-wins rule): keep an a-entry iff b
holds it or b's context never observed it; add a b-entry iff a does not
hold it and a's context never observed it; merge the survivors sorted,
payload ids riding along; vv max; cloud union, sorted and deduplicated.

``join_rows`` is that join: on a CPU tensor it runs ``join_rows_plain``
below, on a CUDA tensor it launches the hand-written kernel
``ujson_join`` (csrc/ujson_join.cu) or raises. The JAX entry points
(``join_batch``, ``fold_deltas``, ``fold_segments``, ``broadcast_join``,
``fold_and_broadcast``) go through it; the fold levels launch it once
per pairwise level. The same kernel carries the resident store's
epilogue (context compaction and the fit to the store's widths,
ops/ujson_resident.py). The host encoder and decoder are the JAX
package's, numpy only, in its dtypes (uint64 wide dots, uint32 vv);
``to_torch`` / ``to_numpy`` move planes between the two, bits unchanged.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils.batching import bucket
from . import _build, row_plan
from .planes import SIGN

PAD64 = np.uint64(0xFFFFFFFFFFFFFFFF)  # the host (JAX dtype) wide pad
PAD32 = np.int32(0x7FFFFFFF)
M32 = 0xFFFFFFFF


def _pad_of(dtype) -> np.generic:
    """The pad of a host (numpy, JAX dtype) dot plane."""
    return PAD32 if np.dtype(dtype) == np.int32 else PAD64


def pad_of(plane: torch.Tensor) -> int:
    """The pad of a torch dot plane: PAD32 narrow, -1 (u64 all ones) wide."""
    return int(PAD32) if plane.dtype == torch.int32 else -1


class DocBatch(NamedTuple):
    """B documents as padded tensors (see module docstring)."""

    dots: torch.Tensor  # (B, L) int32 or int64 bits, sorted per row, pad-filled
    pay: torch.Tensor  # (B, L) int32, -1 pad
    vv: torch.Tensor  # (B, R) int32 bits of u32
    cloud: torch.Tensor  # (B, C) the dots' dtype, sorted, pad-filled


# ---- host <-> torch ----------------------------------------------------------


def plane_to_torch(p: np.ndarray, device) -> torch.Tensor:
    """One host plane in a JAX dtype -> the port's dtype on ``device``
    (uint64 as int64 bits, uint32 as int32 bits); a copy, never a view."""
    p = np.ascontiguousarray(p)
    if not p.flags.writeable:  # torch refuses to wrap read-only memory
        p = p.copy()
    if p.dtype == np.uint64:
        p = p.view(np.int64)
    elif p.dtype == np.uint32:
        p = p.view(np.int32)
    return torch.from_numpy(p).to(device, copy=True)


def to_torch(batch, device) -> DocBatch:
    """Host planes in the JAX dtypes (int32 or uint64 dots, uint32 vv) ->
    the port's planes on ``device``; bits unchanged."""
    return DocBatch(*(plane_to_torch(p, device) for p in batch))


def to_numpy(batch: DocBatch) -> DocBatch:
    """The port's planes -> host planes in the JAX dtypes (one transfer
    per plane), bits unchanged."""
    dots = batch.dots.cpu().numpy()
    cloud = batch.cloud.cpu().numpy()
    if dots.dtype == np.int64:
        dots, cloud = dots.view(np.uint64), cloud.view(np.uint64)
    return DocBatch(dots.copy(), batch.pay.cpu().numpy().copy(),
                    batch.vv.cpu().numpy().view(np.uint32).copy(), cloud.copy())


# ---- plane arithmetic for the plain versions ----------------------------------


def _key(x: torch.Tensor) -> torch.Tensor:
    """Order key (int64) whose signed order is the layout's dot order."""
    return x.to(torch.int64) if x.dtype == torch.int32 else x ^ SIGN


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> u32 values in int64."""
    return x.to(torch.int64) & M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 ``x`` as int32 bits."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _mask_col_seq(x: torch.Tensor, shift: int, r: int):
    """(column, seq as u32) of each dot as JAX's join and context
    compaction decode them (jylis_tpu/ops/ujson_device.py `_covered`,
    ops/ujson_resident.py `_compact_ctx_row`): the column's low 32 bits
    as int32, then min(., r - 1); those look vv up through a per-column
    mask, so a negative column (a wide column >= 2^31, which no encoder
    mints) matches no column: its vv entry reads 0 and nothing absorbs
    into it (``_vv_at``). The wide pad decodes to -1, the narrow one to
    r - 1; callers mask pads out."""
    bits = x.to(torch.int64)
    col = (((bits >> shift) & M32) ^ 0x80000000) - 0x80000000
    return torch.clamp(col, max=r - 1), bits & ((1 << shift) - 1) & M32


def _vv_at(vv: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """vv[col] as u32 values, 0 where the column is negative (matches no
    column, as JAX's column mask)."""
    got = torch.gather(_u32(vv), -1, torch.clamp(col, min=0))
    return torch.where(col < 0, torch.zeros_like(got), got)


def _sort_rows(x: torch.Tensor, *ride):
    """Stable ascending sort of each row in the layout's order; the
    ``ride`` planes follow the same permutation."""
    order = torch.sort(_key(x), dim=-1, stable=True).indices
    return (torch.gather(x, -1, order), *(torch.gather(p, -1, order) for p in ride))


def _member(rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """For each query, is it in its (sorted, pad-filled) row?"""
    keys = _key(rows).contiguous()
    q = _key(queries).contiguous()
    idx = torch.clamp(torch.searchsorted(keys, q), max=rows.shape[-1] - 1)
    return torch.gather(keys, -1, idx) == q


def _covered(vv, cloud, dots, shift: int) -> torch.Tensor:
    """ctx.contains per dot: seq <= vv[col] or the dot is in the cloud."""
    col, seq = _mask_col_seq(dots, shift, vv.shape[-1])
    return (seq <= _vv_at(vv, col)) | _member(cloud, dots)


def _dedup_sorted(cl: torch.Tensor) -> torch.Tensor:
    """Sorted rows -> repeats blanked to pad and resorted (JAX's cloud
    union: sort, blank repeats, resort)."""
    dup = torch.zeros_like(cl, dtype=torch.bool)
    dup[..., 1:] = cl[..., 1:] == cl[..., :-1]
    return _sort_rows(torch.where(dup, pad_of(cl), cl))[0]


def fit(plane: torch.Tensor, width: int, fill) -> torch.Tensor:
    """Slice or pad a (K, W) plane to ``width`` (jylis_tpu/ops/
    ujson_resident.py `_fit`); lossless while width covers the live row
    sizes (pads at the tails)."""
    w = plane.shape[-1]
    if width == w:
        return plane
    if width < w:
        return plane[:, :width].contiguous()
    return torch.cat([plane, torch.full((plane.shape[0], width - w), fill,
                                        dtype=plane.dtype, device=plane.device)], -1)


def compact_ctx_rows(vv, cloud, shift: int):
    """jylis_tpu/ops/ujson_resident.py `_compact_ctx_row` on every row:
    drop cloud dots covered by vv, absorb each column's contiguous run
    above vv[col] into vv (u32 arithmetic). Cloud rows are sorted and
    duplicate-free. Returns (vv, cloud)."""
    pad = pad_of(cloud)
    r = vv.shape[-1]
    valid = cloud != pad
    col, seq = _mask_col_seq(cloud, shift, r)
    vvu = _u32(vv)
    vvc = _vv_at(vv, col)
    drop = valid & (seq <= vvc)
    keep = valid & ~drop
    prev_col = torch.full_like(col, -1)
    prev_col[..., 1:] = col[..., :-1]
    is_new = valid & (col != prev_col)
    kept = keep.to(torch.int64)
    kept_before = torch.cumsum(kept, -1) - kept
    marked = torch.where(is_new, kept_before, torch.full_like(kept_before, -1))
    seg_base = torch.clamp(torch.cummax(marked, -1).values, min=0)
    rank = kept_before - seg_base
    absorb = keep & (seq == ((vvc + rank + 1) & M32))
    add = torch.zeros_like(vvu).scatter_add_(
        -1, torch.clamp(col, min=0), (absorb & (col >= 0)).to(torch.int64))
    new_cloud = _sort_rows(torch.where(absorb | drop, pad, cloud))[0]
    return _i32(vvu + add), new_cloud


# ---- the join: kernel and plain version ---------------------------------------


def _check_finish(finish, sort_output, occupied, a_idx, out) -> None:
    if finish is None:
        if a_idx is not None or occupied is not None or out is not None:
            raise ValueError("ujson_join: a_idx, occupied and out need finish")
        return
    if not sort_output:
        raise ValueError("ujson_join: the epilogue follows a sorted join")
    if out is None:
        raise ValueError("ujson_join: finish writes into out")
    if occupied is not None and a_idx is not None:
        raise ValueError("ujson_join: occupied is for the full-batch join")


def join_rows_plain(a: DocBatch, b: DocBatch, shift: int, a_idx=None,
                    sort_output: bool = True, finish=None, occupied=None,
                    out: DocBatch | None = None) -> DocBatch:
    """The join of ``join_rows`` in plain tensor ops (see there)."""
    _check_finish(finish, sort_output, occupied, a_idx, out)
    if a_idx is not None:
        a = DocBatch(*(p[a_idx.long()] for p in a))
    n = a.dots.shape[0]
    if b.dots.shape[0] == 1 and n != 1:
        b = DocBatch(*(p.expand(n, -1) for p in b))
    pad = pad_of(a.dots)
    keep_a = (a.dots != pad) & (
        _member(b.dots, a.dots) | ~_covered(b.vv, b.cloud, a.dots, shift))
    add_b = ((b.dots != pad) & ~_member(a.dots, b.dots)
             & ~_covered(a.vv, a.cloud, b.dots, shift))
    dots = torch.cat([torch.where(keep_a, a.dots, pad),
                      torch.where(add_b, b.dots, pad)], -1)
    pay = torch.cat([torch.where(keep_a, a.pay, -1), torch.where(add_b, b.pay, -1)], -1)
    if sort_output:
        dots, pay = _sort_rows(dots, pay)
    vv = _i32(torch.maximum(_u32(a.vv), _u32(b.vv)))
    cloud = _dedup_sorted(_sort_rows(torch.cat([a.cloud, b.cloud], -1))[0])
    joined = DocBatch(dots, pay, vv, cloud)
    if finish is None:
        return joined
    out_w, out_c = finish
    vv, cloud = compact_ctx_rows(vv, cloud, shift)
    joined = DocBatch(fit(dots, out_w, pad), fit(pay, out_w, -1), vv,
                      fit(cloud, out_c, pad))
    rows = (a_idx.long() if a_idx is not None
            else torch.arange(n, device=dots.device))
    if occupied is not None:
        joined = clear_rows(joined, ~occupied[rows])
    for o, j in zip(out, joined):
        o[rows] = j
    return out


def clear_rows(batch: DocBatch, mask) -> DocBatch:
    """Reset masked rows to the identity document (new planes)."""
    pad = pad_of(batch.dots)
    m = mask[:, None]
    return DocBatch(
        torch.where(m, pad, batch.dots), torch.where(m, -1, batch.pay),
        torch.where(m, 0, batch.vv), torch.where(m, pad, batch.cloud))


# the launch plan (csrc/ujson_join.cu): a warp per row while a row's work
# buffer fits WARP_ROW_BYTES and the launch has WARP_MIN_ROWS rows or
# more, else a CTA per row, its buffer in shared memory, up to
# CTA_ROW_BYTES; past that a thread-block cluster per row, the buffer
# split across its CTAs' shared memory (crossovers measured on an H100:
# PERF.md §6)
WARP_ROW_BYTES = 16 * 1024
WARP_MIN_ROWS = 512
SMEM_LIMIT = row_plan.SMEM_LIMIT
CTA_ROW_BYTES = SMEM_LIMIT

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_JOIN_ARGS = ([ctypes.c_int] + [_P] * 5 + [_LL] * 2 + [_P] * 4 + [_LL] * 5
              + [_P] * 4 + [_LL] * 4 + [_P] + [_LL] * 2 + [_P] + [_LL] * 7 + [_P])


def join_work_bytes(tsize: int, la: int, lb: int, ca: int, cb: int, r: int) -> int:
    """Bytes of one row's work buffer in csrc/ujson_join.cu."""
    cm = ca + cb
    return row_plan.align(tsize * (la + lb + 2 * cm) + 4 * (la + lb + cm + 4 * r)
                          + la + lb, 16)


def join_share(tsize: int, la: int, lb: int, ca: int, cb: int, r: int,
               n: int) -> tuple[int, int, int]:
    """(dot slots, cloud slots, bytes) of one CTA's share of a row's work
    buffer in a cluster of n (csrc/ujson_join.cu `ujson_join_cluster`):
    its window of the merged dots (dot and payload id) and of the merged
    cloud (entry, kept count and a flag bit), and the row's four vv
    columns."""
    pd, pc = -(-(la + lb) // n), -(-(ca + cb) // n)
    return pd, pc, row_plan.align((tsize + 4) * (pd + pc) + 4 * -(-pc // 32) + 16 * r, 16)


def join_plan(nrows: int, wb: int, share=None) -> row_plan.RowPlan:
    """How ``ujson_join`` runs ``nrows`` rows of ``wb`` work bytes each
    (``share(n)``: a CTA's bytes in a cluster of n, `join_share`): the
    class, rows a CTA, shared memory, grid and scratch."""
    return row_plan.plan_rows(nrows, wb, wb, WARP_ROW_BYTES, WARP_MIN_ROWS, share,
                              CTA_ROW_BYTES)


def plan_join(nrows: int, tsize: int, la: int, lb: int, ca: int, cb: int,
              r: int) -> row_plan.RowPlan:
    """`join_plan` for rows of these widths (tsize: bytes a dot)."""
    return join_plan(nrows, join_work_bytes(tsize, la, lb, ca, cb, r),
                     lambda n: join_share(tsize, la, lb, ca, cb, r, n)[2])


def _check_planes(what, batch: DocBatch, dev, dtype, r=None) -> None:
    for t, want in zip(batch, (dtype, torch.int32, torch.int32, dtype)):
        if t.device != dev or t.dtype != want or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(
                f"{what}: expected contiguous 2-d {want} planes on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if batch.pay.shape != batch.dots.shape or batch.vv.shape[0] != batch.dots.shape[0] \
            or batch.cloud.shape[0] != batch.dots.shape[0]:
        raise ValueError(f"{what}: planes disagree on rows or widths")
    if r is not None and batch.vv.shape[1] != r:
        raise ValueError(f"{what}: vv has {batch.vv.shape[1]} columns, not {r}")


_KINDS = {"warp": 0, "cta": 1, "cluster": 2}


def join_rows(a: DocBatch, b: DocBatch, shift: int, a_idx=None,
              sort_output: bool = True, finish=None, occupied=None,
              out: DocBatch | None = None) -> DocBatch:
    """Row-wise ORSWOT join: slot s joins a row ``a_idx[s]`` (or s) with
    b row s, or b's one row when b has a single row (the broadcast).

    ``finish=None``: returns new planes of widths La + Lb and Ca + Cb
    (``sort_output=False``: the masked a row, then the masked b row).
    ``finish=(out_w, out_c)``: the resident store's epilogue — context
    compaction, then the fit to (out_w, out_c) — written into ``out`` at
    row ``a_idx[s]`` (or s), which is returned; ``out`` may be ``a``
    itself (in place). ``occupied`` ((rows,) bool, full-batch joins
    only): rows not occupied get the identity document.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/ujson_join.cu (one CUDA kernel a call, a warp, a CTA or a
    thread-block cluster per row as ``join_plan`` picks) or raises."""
    if a.dots.device.type == "cpu":
        return join_rows_plain(a, b, shift, a_idx, sort_output, finish, occupied, out)
    _check_finish(finish, sort_output, occupied, a_idx, out)
    dev = a.dots.device
    dtype = a.dots.dtype
    wide = dtype == torch.int64
    if dtype not in (torch.int32, torch.int64) or wide != (shift == 32):
        raise ValueError(f"ujson_join: dots {dtype} do not match shift {shift}")
    r = a.vv.shape[1]
    _check_planes("ujson_join a", a, dev, dtype, r)
    _check_planes("ujson_join b", b, dev, dtype, r)
    na, la = a.dots.shape
    ca = a.cloud.shape[1]
    nb, lb = b.dots.shape
    cb = b.cloud.shape[1]
    if a_idx is not None:
        if a_idx.device != dev or a_idx.dtype != torch.int32 or a_idx.dim() != 1 \
                or not a_idx.is_contiguous():
            raise ValueError("ujson_join: a_idx must be a contiguous int32 vector")
        n = a_idx.shape[0]
    else:
        n = na
    if nb not in (n, 1):
        raise ValueError(f"ujson_join: b has {nb} rows for {n} slots")
    if finish is None:
        lo, co = la + lb, ca + cb
        out = DocBatch(torch.empty((n, lo), dtype=dtype, device=dev),
                       torch.empty((n, lo), dtype=torch.int32, device=dev),
                       torch.empty((n, r), dtype=torch.int32, device=dev),
                       torch.empty((n, co), dtype=dtype, device=dev))
    else:
        lo, co = finish
        _check_planes("ujson_join out", out, dev, dtype, r)
        if out.dots.shape[1] != lo or out.cloud.shape[1] != co:
            raise ValueError("ujson_join: out planes are not the finish widths")
        rows_out = out.dots.shape[0]
        if rows_out != (na if a_idx is not None else n):
            raise ValueError("ujson_join: out rows must match a's rows (or the slots)")
        if occupied is not None and (occupied.dtype != torch.bool or occupied.device != dev
                                     or tuple(occupied.shape) != (rows_out,)):
            raise ValueError("ujson_join: occupied must be a (rows,) bool on the device")
    if r < 1:
        raise ValueError("ujson_join: vv needs at least one column")
    ts = 8 if wide else 4
    plan = plan_join(n, ts, la, lb, ca, cb, r)
    pd, pc, _ = join_share(ts, la, lb, ca, cb, r, plan.cluster)
    scratch = (torch.empty(plan.scratch, dtype=torch.uint8, device=dev)
               if plan.scratch else None)
    ptrs = [None if t is None else t.data_ptr() for t in (
        *a[:4], a_idx)]
    fn = _build.function("ujson_join", "jt_ujson_join", _JOIN_ARGS)
    with torch.cuda.device(dev):
        rc = fn(int(wide), *ptrs, la, ca, *(t.data_ptr() for t in b),
                0 if nb == 1 else 1, lb, cb, r, shift,
                *(t.data_ptr() for t in out), lo, co, int(sort_output),
                int(finish is not None),
                None if occupied is None else occupied.data_ptr(),
                _KINDS[plan.kind], plan.rows_per_cta,
                None if scratch is None else scratch.data_ptr(), plan.stride, n,
                plan.grid, plan.smem, plan.cluster, pd, pc,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ujson_join")
    _build.count(join_rows, dev, plan.kind)
    return out


_build.counter(join_rows, classes=True)  # .classes: by join_plan class


# ---- the JAX package's entry points -------------------------------------------


def join_batch(a: DocBatch, b: DocBatch, shift: int = 32,
               sort_output: bool = True) -> DocBatch:
    """Row-wise ORSWOT join of two document batches (row i joins row i);
    output widths are the sums of the input widths."""
    return join_rows(a, b, shift, sort_output=sort_output)


FOLD_ARITY = 8  # rows folded per unrolled fold level


def _empty_rows(batch: DocBatch, lead: tuple, n: int) -> DocBatch:
    """Identity rows (no entries, empty context) at batch's widths,
    shaped lead + (n, width)."""
    pad = pad_of(batch.dots)

    def full(p, fill):
        return torch.full(lead + (n, p.shape[-1]), fill, dtype=p.dtype, device=p.device)

    return DocBatch(full(batch.dots, pad), full(batch.pay, -1), full(batch.vv, 0),
                    full(batch.cloud, pad))


def _fold_body(batch: DocBatch, shift: int, join=None) -> DocBatch:
    """jylis_tpu/ops/ujson_device.py `_fold_body` over a (K, n, W) batch:
    pad n to a multiple of k = min(FOLD_ARITY, next power of two), split
    into k contiguous slices, join them pairwise (one launch per pairwise
    level, every key and slice at once) until one slice is left; repeat
    while more than one row per key remains. Returns (K, 1, W').
    ``join`` defaults to `join_rows` (`join_rows_plain` runs the levels
    in plain torch on any device)."""
    join = join_rows if join is None else join
    kk = batch.dots.shape[0]
    while batch.dots.shape[1] > 1:
        n = batch.dots.shape[1]
        k = min(FOLD_ARITY, 1 << (n - 1).bit_length())
        if n % k:
            extra = _empty_rows(batch, (kk,), k - n % k)
            batch = DocBatch(*(torch.cat([p, q], 1) for p, q in zip(batch, extra)))
            n = batch.dots.shape[1]
        step = n // k
        items = DocBatch(*(p.reshape(kk, k, step, p.shape[-1]) for p in batch))
        while k > 1:
            a = DocBatch(*(p[:, 0::2].reshape(-1, p.shape[-1]).contiguous() for p in items))
            b = DocBatch(*(p[:, 1::2].reshape(-1, p.shape[-1]).contiguous() for p in items))
            k //= 2
            items = DocBatch(*(p.reshape(kk, k, step, p.shape[-1])
                               for p in join(a, b, shift)))
        batch = DocBatch(*(p[:, 0] for p in items))
    return batch


def fold_deltas(batch: DocBatch, shift: int = 32) -> DocBatch:
    """Fold all B rows into ONE document (the join is associative and
    commutative, so any fold shape converges identically); (1, W')."""
    return DocBatch(*(p[0] for p in _fold_body(DocBatch(*(p[None] for p in batch)), shift)))


def fold_segments(batch: DocBatch, shift: int = 32) -> DocBatch:
    """Segmented fan-in: planes shaped (K, D, W); every key's D delta
    rows fold to ONE document, all keys in the same launches."""
    return DocBatch(*(p[:, 0] for p in _fold_body(batch, shift)))


def broadcast_join(replicas: DocBatch, delta_row: DocBatch, shift: int = 32,
                   sort_output: bool = True) -> DocBatch:
    """Join ONE folded delta into every replica row in one launch."""
    return join_rows(replicas, delta_row, shift, sort_output=sort_output)


def fold_and_broadcast(replicas: DocBatch, deltas: DocBatch, shift: int = 32,
                       sort_output: bool = False) -> DocBatch:
    """Fold all delta rows, then join the result into every replica row."""
    return join_rows(replicas, fold_deltas(deltas, shift), shift,
                     sort_output=sort_output)


# ---- host-side encode / decode / compaction --------------------------------


def plan_shift(docs, n_rep: int) -> int:
    """Pick the dot layout for a batch: int32 with the smallest workable
    shift when every seq fits, else the u64/32 layout. The all-ones seq
    is reserved in the narrow layout: the top replica column with an
    all-ones seq would pack to exactly PAD32 and vanish as padding."""
    seq_bits = narrow_shift(n_rep)
    wide = (1 << seq_bits) - 1
    for doc in docs:
        if doc.entries and max(s for _, s in doc.entries) >= wide:
            return 32
        vv = doc.ctx.vv
        if vv and max(vv.values()) >= wide:
            return 32
        cl = doc.ctx.cloud
        if cl and max(s for _, s in cl) >= wide:
            return 32
    return seq_bits


def _slot_cols(lens: np.ndarray) -> np.ndarray:
    """Per-row slot columns for variable-length rows, vectorised:
    [0..lens[0]) ++ [0..lens[1]) ++ ... with no Python per-row loop."""
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lens)


def narrow_shift(n_rep: int) -> int:
    """The int32 layout's shift for this replica-column budget."""
    return 31 - max(int(n_rep - 1).bit_length(), 1)


def _auto_shift_encode(encode_one, n_rep: int, prefer: int | None):
    """Narrow-first / wide-fallback layout policy: encode at the narrow
    int32 layout, falling back to u64/32 when any seq (or pad collision)
    overflows mid-pass; ``prefer=32`` skips the narrow attempt."""
    shift = 32 if prefer == 32 else narrow_shift(n_rep)
    try:
        return encode_one(shift), shift
    except OverflowError:
        if shift == 32:
            raise  # genuinely un-encodable (caller falls back to host)
        return encode_one(32), 32


def encode_docs_auto(docs, rid_cols, pay_ids, n_rep, prefer=None, device="cuda"):
    """`encode_docs` under the narrow-first layout policy; (batch, shift)."""
    return _auto_shift_encode(
        lambda sh: encode_docs(docs, rid_cols, pay_ids, n_rep, shift=sh, device=device),
        n_rep, prefer)


def encode_doc_lists_auto(lists, rid_cols, pay_ids, n_rep, prefer=None, device="cuda"):
    """Several doc lists encoded under ONE shared layout (joins require
    identical shifts); (batches, shift)."""
    return _auto_shift_encode(
        lambda sh: [encode_docs(docs, rid_cols, pay_ids, n_rep, shift=sh, device=device)
                    for docs in lists],
        n_rep, prefer)


def encode_doc_groups_auto(groups, rid_cols, pay_ids, n_rep, prefer=None, device="cuda"):
    """`encode_doc_groups` under the narrow-first layout policy;
    (batch, shift)."""
    return _auto_shift_encode(
        lambda sh: encode_doc_groups(groups, rid_cols, pay_ids, n_rep, shift=sh,
                                     device=device),
        n_rep, prefer)


def _encode_docs_np(
    docs, rid_cols: dict[int, int], pay_ids, n_rep: int, shift: int = 32
) -> DocBatch:
    """`encode_docs` core, returning host numpy planes in the JAX dtypes
    (int32 or uint64 dots, uint32 vv). The loop accumulates flat lists
    only and every plane fills with one fancy-index scatter."""
    seq_cap = 1 << shift
    setd = rid_cols.setdefault
    b = len(docs)
    d_lens = np.zeros(b, np.int64)
    c_lens = np.zeros(b, np.int64)
    dv: list[int] = []
    pv: list[int] = []
    cv: list[int] = []
    vv_ri: list[int] = []
    vv_ci: list[int] = []
    vv_sv: list[int] = []
    for i, doc in enumerate(docs):
        n0 = len(dv)
        for (rid, seq), pt in doc.entries.items():
            col = setd(rid, len(rid_cols))
            if seq >= seq_cap:
                raise OverflowError(f"seq {seq} needs a wider layout than {shift}")
            dv.append((col << shift) | seq)
            pv.append(pay_ids(*pt))
        k = len(dv) - n0
        if k > 1:  # rows must be dot-sorted; singletons already are
            seg = sorted(zip(dv[n0:], pv[n0:]))
            dv[n0:] = [d for d, _ in seg]
            pv[n0:] = [p for _, p in seg]
        d_lens[i] = k
        for rid, s in doc.ctx.vv.items():
            col = setd(rid, len(rid_cols))
            if s >= seq_cap or s > 0xFFFFFFFF:
                # clamping would SHRINK coverage and resurrect removed
                # entries — refuse; callers fall back to the host lattice
                raise OverflowError(f"vv seq {s} needs a wider layout")
            vv_ri.append(i)
            vv_ci.append(col)
            vv_sv.append(s)
        n0c = len(cv)
        for rid, seq in doc.ctx.cloud:
            col = setd(rid, len(rid_cols))
            if seq >= seq_cap:
                raise OverflowError(f"seq {seq} needs a wider layout than {shift}")
            cv.append((col << shift) | seq)
        kc = len(cv) - n0c
        if kc > 1:
            cv[n0c:] = sorted(cv[n0c:])
        c_lens[i] = kc
    dtype = np.int32 if shift < 32 else np.uint64
    pad = _pad_of(dtype)
    if len(rid_cols) > n_rep:
        raise ValueError(f"n_rep {n_rep} too small for {len(rid_cols)} replicas")
    wl = bucket(max(int(d_lens.max()) if b else 0, 1), 4)
    wc = bucket(max(int(c_lens.max()) if b else 0, 1), 4)
    dots = np.full((b, wl), pad, dtype)
    pay = np.full((b, wl), -1, np.int32)
    vv = np.zeros((b, n_rep), np.uint32)
    cloud = np.full((b, wc), pad, dtype)
    if dv:
        dvals = np.asarray(dv, dtype)
        if bool((dvals == pad).any()):
            raise OverflowError("dot collides with the pad sentinel")
        rows_i = np.repeat(np.arange(b), d_lens)
        cols_i = _slot_cols(d_lens)
        dots[rows_i, cols_i] = dvals
        pay[rows_i, cols_i] = np.asarray(pv, np.int32)
    if vv_ri:
        vv[np.asarray(vv_ri, np.int64), np.asarray(vv_ci, np.int64)] = np.asarray(
            vv_sv, np.uint32
        )
    if cv:
        cvals = np.asarray(cv, dtype)
        if bool((cvals == pad).any()):
            raise OverflowError("dot collides with the pad sentinel")
        cloud[np.repeat(np.arange(b), c_lens), _slot_cols(c_lens)] = cvals
    return DocBatch(dots, pay, vv, cloud)


def encode_docs(docs, rid_cols: dict[int, int], pay_ids, n_rep: int,
                shift: int = 32, device="cuda") -> DocBatch:
    """Pack host `UJSON` documents into one DocBatch on ``device`` at the
    given layout (see `plan_shift`). rid_cols: replica-id -> column
    (shared, grows on host); pay_ids: callable (path, token) -> int32 id."""
    return to_torch(_encode_docs_np(docs, rid_cols, pay_ids, n_rep, shift), device)


def encode_doc_groups_np(groups, rid_cols: dict[int, int], pay_ids, n_rep: int,
                         shift: int = 32) -> DocBatch:
    """K keys' delta lists as the (K, D, W) host grid `fold_segments`
    takes; short groups pad with identity docs (the join's neutral
    element), so each key's fold is exactly the fold of its deltas."""
    from .ujson_host import UJSON

    d = bucket(max((len(g) for g in groups), default=1), 1)
    empty = UJSON()
    flat = []
    for g in groups:
        flat.extend(g)
        flat.extend([empty] * (d - len(g)))
    b = _encode_docs_np(flat, rid_cols, pay_ids, n_rep, shift=shift)
    return DocBatch(*(p.reshape((len(groups), d) + p.shape[1:]) for p in b))


def encode_doc_groups(groups, rid_cols: dict[int, int], pay_ids, n_rep: int,
                      shift: int = 32, device="cuda") -> DocBatch:
    """`encode_doc_groups_np`, shipped to ``device``."""
    return to_torch(encode_doc_groups_np(groups, rid_cols, pay_ids, n_rep, shift), device)


def decode_batch(batch: DocBatch, cols_rid, pay_lookup, shift: int = 32) -> list:
    """Unpack every row back into host `UJSON` docs. Takes the port's
    planes (each transfers to the host once) or host planes."""
    from .ujson_host import UJSON

    if isinstance(batch.dots, torch.Tensor):
        batch = to_numpy(batch)
    all_dots, all_pays, all_vv, all_cloud = batch
    pad = _pad_of(all_dots.dtype)
    mask = (1 << shift) - 1
    docs = []
    for row in range(all_dots.shape[0]):
        doc = UJSON()
        for d, p in zip(all_dots[row], all_pays[row]):
            if d == pad:
                continue
            d = int(d)
            doc.entries[(cols_rid[d >> shift], d & mask)] = pay_lookup(int(p))
        for col, s in enumerate(all_vv[row]):
            if s:
                doc.ctx.vv[cols_rid[col]] = int(s)
        for c in all_cloud[row]:
            if c != pad:
                c = int(c)
                doc.ctx.cloud.add((cols_rid[c >> shift], c & mask))
        doc.ctx.compact()
        docs.append(doc)
    return docs


def decode_doc(batch: DocBatch, row: int, cols_rid, pay_lookup, shift: int = 32):
    """Single-row convenience wrapper over `decode_batch`."""
    one = DocBatch(*(p[row : row + 1] for p in batch))
    return decode_batch(one, cols_rid, pay_lookup, shift=shift)[0]


def compact(batch: DocBatch) -> DocBatch:
    """Re-bucket: drop all-pad columns the joins accumulated (the live
    widths are read on the host)."""
    pad = pad_of(batch.dots)
    live_l = int((batch.dots != pad).sum(1).max()) if batch.dots.numel() else 1
    live_c = int((batch.cloud != pad).sum(1).max()) if batch.cloud.numel() else 1
    wl, wc = bucket(max(live_l, 1), 4), bucket(max(live_c, 1), 4)
    return DocBatch(batch.dots[:, :wl].contiguous(), batch.pay[:, :wl].contiguous(),
                    batch.vv, batch.cloud[:, :wc].contiguous())
