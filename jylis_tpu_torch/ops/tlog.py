"""TLOG: timestamped log with a grow-only cutoff, on torch tensors.

Semantics (docs/_docs/types/tlog.md:116-133): a log is a list of
(value, ts) entries sorted ts-desc (value-desc on ties); merging unions
the lists, drops duplicates (equal ts AND equal value), takes the max
cutoff, and discards entries with ts < cutoff. The port of
jylis_tpu/ops/tlog.py.

The keyspace is the JAX package's sort planes, one u32 per entry and
plane, kept here as int32 bit patterns (torch has no unsigned 32-bit
compare or sort on the CPU):

  ``nth[key, slot]`` : ~ts >> 32     (wide layout only)
  ``ntl[key, slot]`` : ~ts & 0xFFFFFFFF
  ``nv [key, slot]`` : ~(vid + 1)    (an empty slot, vid -1, is PAD: all ones)

plus ``length[key]`` (int32) and ``cutoff[key]`` (int64 bits of the
u64). Ascending unsigned (nth, ntl, nv) order is the canonical order:
valid entries first, then ts descending, then vid descending. Unsigned
order of a plane compares its values masked to 32 bits in int64 (or
flips the sign bit). The layout is adaptive: while every ts fits u32
``nth`` is not stored (``state.nth is None``); ``widen`` materialises it
as the constant PAD plane, losslessly.

``drain_sparse`` and ``drain_dense`` are the serving path's step: merge
one delta batch (cutoff, sort, dedup, overflow) and apply a per-row
TRIM/CLR count in the same pass. On a CPU tensor they run their plain
versions below; on a CUDA tensor they launch the hand-written kernels
``tlog_drain_sparse`` / ``tlog_drain_dense`` (csrc/tlog_drain.cu: one
CUDA kernel a call, a warp, a CTA or a thread-block cluster per row as
``drain_plan`` picks) or
raise. The JAX package's entry points (``converge_batch``,
``converge_then_trim``, ``trim_batch`` ...) keep their signatures and go
through them. All of them update the state in place, where JAX returns
new arrays; a row the drain flags as overflow is left untouched (JAX
returns it merged and truncated, and its caller discards it). The
caller grows the state and drains the same delta again: join, cutoff
and trim are idempotent and the canonical form is unique, so the rows
merged by the flagged attempt come out the same.

Contract: rows are canonical (the first ``length`` slots valid, PAD
after); one batch holds at most one delta per key; interner ids stay
below 2**31; a narrow state only sees ts and cutoffs <= TS32_MAX (the
repo widens first). Pad slots (rows >= K or negative) write nothing and
report overflow 0, length 0 and cutoff 0; JAX clamps their gathers
instead, and the repo reads live slots only.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.batching import bucket
from . import _build, planes, row_plan

SIGN = planes.SIGN
PAD = -1  # the all-ones u32 as int32 bits
M32 = 0xFFFFFFFF

# largest ts representable in the narrow (2-plane) layout; CLR needs
# latest+1 to fit too, hence the -1
TS32_MAX = 0xFFFFFFFF - 1

# trim counts at or above this sentinel are no-ops; the host uses it to
# pad trim batches and to mix no-trim rows into fused drain+trim launches
TRIM_NOOP = 1 << 62


class TLogState(NamedTuple):
    nth: Optional[torch.Tensor]  # (K, L) int32 bits of ~ts_hi, None if narrow
    ntl: torch.Tensor  # (K, L) int32 bits of ~ts_lo
    nv: torch.Tensor  # (K, L) int32 bits of ~(vid+1); PAD in empty slots
    length: torch.Tensor  # (K,) int32 valid-entry count
    cutoff: torch.Tensor  # (K,) int64 bits of the u64 cutoff

    @property
    def wide(self) -> bool:
        return self.nth is not None

    @property
    def shape(self):
        return tuple(self.ntl.shape)


def _planes(state: TLogState):
    return (state.nth, state.ntl, state.nv) if state.wide else (state.ntl, state.nv)


def init(num_keys: int, max_len: int, wide: bool = False, device="cuda") -> TLogState:
    def pad():
        return torch.full((num_keys, max_len), PAD, dtype=torch.int32, device=device)

    return TLogState(
        pad() if wide else None, pad(), pad(),
        torch.zeros(num_keys, dtype=torch.int32, device=device),
        torch.zeros(num_keys, dtype=torch.int64, device=device),
    )


def widen(state: TLogState) -> TLogState:
    """Narrow -> wide, losslessly: every stored ts fits u32, so the
    missing ~ts_hi plane is the constant all-ones, which is PAD too."""
    if state.wide:
        return state
    return state._replace(nth=torch.full_like(state.ntl, PAD))


def grow(state: TLogState, num_keys: int, max_len: int) -> TLogState:
    k, l = state.shape
    if (num_keys, max_len) == (k, l):
        return state
    out = init(num_keys, max_len, state.wide, state.ntl.device)
    for new, old in zip(_planes(out), _planes(state)):
        new[:k, :l] = old
    out.length[:k] = state.length
    out.cutoff[:k] = state.cutoff
    return out


# ---- plane arithmetic (int64 working values) ----------------------------------


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their u32 values in int64."""
    return x.to(torch.int64) & M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 ``x`` as int32 bit patterns."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _uge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a >= b on int64 bit patterns."""
    return (a ^ SIGN) >= (b ^ SIGN)


def _umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(_uge(a, b), a, b)


def _ts_ge(pl, cut: torch.Tensor, wide: bool) -> torch.Tensor:
    """ts >= cut per slot, in negated-plane space exactly as
    jylis_tpu/ops/tlog.py `_ts_ge`: lex (nth, ntl) <= (~cut_hi, ~cut_lo);
    the narrow layout compares the low plane only. ``pl``: u32 values
    in int64; ``cut``: (n,) int64 bits."""
    nc = ~cut
    nch, ncl = ((nc >> 32) & M32)[:, None], (nc & M32)[:, None]
    if wide:
        return (pl[0] < nch) | ((pl[0] == nch) & (pl[1] <= ncl))
    return pl[0] <= ncl


def _ts_of(pl, wide: bool) -> torch.Tensor:
    """u32 plane values (int64) -> the entries' ts as int64 bits."""
    lo = ~pl[-2] & M32
    if wide:
        return ((~pl[0] & M32) << 32) | lo
    return lo


def _sort_rows(pl, wide: bool):
    """Stable ascending lexicographic sort of each row by the unsigned
    planes: (ntl, nv) packed into one u64 key, then (wide) a second
    stable pass on nth."""
    key = ((pl[-2] << 32) | pl[-1]) ^ SIGN
    order = torch.sort(key, dim=1, stable=True).indices
    if wide:
        hi = torch.gather(pl[0], 1, order)
        order = torch.gather(order, 1, torch.sort(hi, dim=1, stable=True).indices)
    return tuple(torch.gather(p, 1, order) for p in pl)


def _merge_rows(rows, length, a_cut, d_ts, d_vid, d_cut, counts, wide: bool,
                tail: bool):
    """The drain on gathered rows, in plain tensor ops.

    rows: (n, L) int32 planes; length (n,) int32; a_cut, d_cut (n,) and
    d_ts (n, Ld) int64 bits; d_vid (n, Ld) int64; counts (n,) int64.
    ``tail``: the dense overflow rule (a row's entries reach into the
    last Ld columns) instead of the sparse one (merged length > L).
    Returns (planes, length, cutoff, overflow); flagged rows come back
    as they went in."""
    n, L = rows[0].shape
    ld = d_ts.shape[1]
    dev = d_ts.device
    cut = _umax(a_cut, d_cut)
    # the state's entries under the raised cutoff (canonical rows: a prefix)
    a = tuple(_u32(p) for p in rows)
    slot = torch.arange(L, device=dev)[None, :]
    a_ok = (slot < length[:, None].long()) & _ts_ge(a, cut, wide)
    a = tuple(torch.where(a_ok, p, M32) for p in a)
    # the delta's valid entries as planes; the rest PAD
    d_ok = (d_vid >= 0) & _uge(d_ts, cut[:, None])
    nt = ~d_ts
    d = ((nt >> 32) & M32, nt & M32, ~(d_vid + 1) & M32)
    d = tuple(torch.where(d_ok, p, M32) for p in (d if wide else d[1:]))
    pl = _sort_rows(tuple(torch.cat([x, y], 1) for x, y in zip(a, d)), wide)
    # duplicates are neighbours now: keep the first of each run
    real = pl[-1] != M32
    dup = torch.zeros_like(real)
    eq = real[:, 1:]
    for p in pl:
        eq = eq & (p[:, 1:] == p[:, :-1])
    dup[:, 1:] = eq
    keep = real & ~dup
    m = keep.sum(1)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    pl = tuple(torch.gather(torch.where(keep, p, M32), 1, order) for p in pl)
    # the fused TRIM/CLR, from the merged rows (tlog.py trim_batch)
    width = pl[0].shape[1]
    mlen = torch.clamp(m, max=L)
    ts = _ts_of(pl, wide)
    at = torch.clamp(counts - 1, 0, width - 1)[:, None]
    ts_at = torch.gather(ts, 1, at)[:, 0]
    latest1 = torch.where(mlen > 0, ts[:, 0] + 1, 0)  # wraps to 0 at 2^64-1
    target = torch.where(
        counts == 0, latest1,
        torch.where((counts > 0) & (counts <= mlen), ts_at, 0))
    new_cut = _umax(cut, target)
    pl = tuple(p[:, :L] for p in pl)
    nk = (_ts_ge(pl, new_cut, wide) & (pl[-1] != M32)).sum(1)
    pl = tuple(torch.where(slot < nk[:, None], p, M32) for p in pl)
    ovf = length > L - ld if tail else m > L
    out = tuple(torch.where(ovf[:, None], r, _i32(p)) for r, p in zip(rows, pl))
    return (out, torch.where(ovf, length, nk.to(torch.int32)),
            torch.where(ovf, a_cut, new_cut), ovf)


# ---- the drain steps: kernels and their plain versions ------------------------


def _row_counts(k: int, trim_ki, counts) -> torch.Tensor:
    """(K,) per-row counts, TRIM_NOOP except at the live rows of
    ``trim_ki`` (pads dropped, as JAX's mode="drop" scatter drops them)."""
    out = torch.full((k,), TRIM_NOOP, dtype=torch.int64, device=counts.device)
    live = planes.live_rows(trim_ki, k)
    out[trim_ki[live].long()] = counts[live]
    return out


def drain_dense_plain(state: TLogState, d_ts, d_vid, d_cut, trim_ki, counts):
    """Merge (K, Ld) delta rows aligned 1:1 with the keyspace into
    ``state`` in place and apply the trims of ``trim_ki`` / ``counts``;
    returns the (K,) overflow mask (length > L - Ld, on every row)."""
    sp = _planes(state)
    cnt = _row_counts(state.length.shape[0], trim_ki, counts)
    out, length, cutoff, ovf = _merge_rows(
        sp, state.length, state.cutoff, d_ts, d_vid, d_cut, cnt, state.wide,
        tail=True)
    for p, o in zip(sp, out):
        p.copy_(o)
    state.length.copy_(length)
    state.cutoff.copy_(cutoff)
    return ovf


def drain_sparse_plain(state: TLogState, key_idx, d_ts, d_vid, d_cut, counts):
    """Merge a (B, Ld) delta batch at UNIQUE rows ``key_idx`` into
    ``state`` in place, with per-slot trim counts. Returns (overflow,
    length, cutoff), each (B,): merged length > L, and the row's length
    and cutoff after the drain; 0 at pad slots."""
    sp = _planes(state)
    live = planes.live_rows(key_idx, state.length.shape[0])
    rows = key_idx[live].long()
    out, length, cutoff, ovf_live = _merge_rows(
        tuple(p[rows] for p in sp), state.length[rows], state.cutoff[rows],
        d_ts[live], d_vid[live], d_cut[live], counts[live], state.wide,
        tail=False)
    for p, o in zip(sp, out):
        p[rows] = o
    state.length[rows] = length
    state.cutoff[rows] = cutoff
    b = key_idx.shape[0]
    dev = key_idx.device
    ovf = torch.zeros(b, dtype=torch.bool, device=dev)
    out_len = torch.zeros(b, dtype=torch.int32, device=dev)
    out_cut = torch.zeros(b, dtype=torch.int64, device=dev)
    ovf[live], out_len[live], out_cut[live] = ovf_live, length, cutoff
    return ovf, out_len, out_cut


# the launch plan (csrc/tlog_drain.cu): a warp per row while a row's work
# buffer (its L state slots and the delta's slots, each plane) fits
# WARP_ROW_BYTES and Ld <= WARP_MAX_LD (the delta sorts in a warp's
# registers, WARP_MAX_LD / 32 entries a lane); else a CTA per row, its
# buffer in shared memory, up to CTA_ROW_BYTES; past that a thread-block
# cluster per row, the buffer split across its CTAs' shared memory (the
# crossovers measured on an H100: PERF.md §6)
WARP_ROW_BYTES = 36 * 1024
WARP_MAX_LD = 256
CTA_ROW_BYTES = row_plan.SMEM_LIMIT

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGS = [ctypes.c_int] + [_P] * 14 + [_LL] * 14 + [_P]


class DrainPlan(NamedTuple):
    rows: row_plan.RowPlan
    log_e: int  # log2 of the delta entries a lane holds (warp class)
    ldp: int  # delta slots of a row's work buffer (cluster: of a CTA's share)
    slice: int  # u32 a plane of a row's work buffer (cluster: state slots a share holds)


def _row_bytes(nplanes: int, L: int, ldp: int) -> int:
    """Bytes of one row's work buffer: per plane the L state slots and
    ldp delta slots, then ldp ints (csrc/tlog_drain.cu `buffer_u32`)."""
    return 4 * (nplanes * row_plan.align(L + ldp, 4) + row_plan.align(ldp, 4))


def _share(nplanes: int, L: int, ldp: int, n: int) -> tuple[int, int, int]:
    """(delta slots, state slots, bytes) of one CTA's share of a row's work
    buffer in a cluster of n (csrc/tlog_drain.cu `tlog_drain_cluster`):
    two delta buffers (the merge's two sides) and two ints a delta slot,
    then the state slots, each plane."""
    p = max(ldp, n) // n
    pa = row_plan.align(-(-L // n), 4)
    return p, pa, 4 * (2 * nplanes * p + 2 * p + nplanes * pa)


def drain_plan(b: int, L: int, ld: int, nplanes: int) -> DrainPlan:
    """How ``tlog_drain`` runs ``b`` slots of width L with Ld delta
    columns: the class, rows a CTA, shared memory, grid and scratch."""
    ldp = bucket(ld, 1)
    wl = max(32, ldp)
    warp = _row_bytes(nplanes, L, wl) if ldp <= WARP_MAX_LD else None
    rows = row_plan.plan_rows(b, warp, _row_bytes(nplanes, L, ldp), WARP_ROW_BYTES,
                              share=lambda n: _share(nplanes, L, ldp, n)[2],
                              cta_limit=CTA_ROW_BYTES)
    if rows.kind == "warp":
        return DrainPlan(rows, (wl // 32).bit_length() - 1, wl, row_plan.align(L + wl, 4))
    if rows.kind == "cluster":
        p, pa, _ = _share(nplanes, L, ldp, rows.cluster)
        return DrainPlan(rows, 0, p, pa)
    return DrainPlan(rows, 0, ldp, row_plan.align(L + ldp, 4))


def _check(what, state, key_idx, d_ts, d_vid, d_cut, counts, b) -> None:
    dev = state.ntl.device
    k, L = state.shape
    ld = d_ts.shape[1] if d_ts.dim() == 2 else -1
    want = [(p, torch.int32, (k, L)) for p in _planes(state)]
    want += [(state.length, torch.int32, (k,)), (state.cutoff, torch.int64, (k,)),
             (d_ts, torch.int64, (b, ld)), (d_vid, torch.int64, (b, ld)),
             (d_cut, torch.int64, (b,)), (counts, torch.int64, (b,))]
    if key_idx is not None:
        want.append((key_idx, torch.int32, (b,)))
    for t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{what}: expected contiguous {dtype} CUDA tensors on {dev}, "
                f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: shape {tuple(t.shape)} != {shape}")
    if ld < 1:
        raise ValueError(f"{what}: the delta needs at least one column")


_KINDS = {"warp": 0, "cta": 1, "cluster": 2}


def _launch(what, state, key_idx, d_ts, d_vid, d_cut, counts, outs):
    dev = state.ntl.device
    k, L = state.shape
    b, ld = d_ts.shape
    nplanes = 3 if state.wide else 2
    plan = drain_plan(b, L, ld, nplanes)
    rows = plan.rows
    scratch = (torch.empty(rows.scratch, dtype=torch.uint8, device=dev)
               if rows.scratch else None)
    vec = L % 4 == 0 and all(p.data_ptr() % 16 == 0 for p in _planes(state))
    ptrs = [None if t is None else t.data_ptr() for t in (
        state.nth, state.ntl, state.nv, state.length, state.cutoff, key_idx,
        d_ts, d_vid, d_cut, counts, *outs, scratch)]
    fn = _build.function("tlog_drain", "jt_tlog_drain", _ARGS)
    with torch.cuda.device(dev):
        rc = fn(nplanes, *ptrs, b, k, L, ld, _KINDS[rows.kind],
                plan.log_e, plan.ldp, rows.rows_per_cta, plan.slice, rows.grid,
                rows.smem, int(vec), rows.cluster, rows.stride,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, what)
    return rows.kind


def drain_dense(state: TLogState, d_ts, d_vid, d_cut, trim_ki, counts):
    """Whole-keyspace drain with fused trims (``trim_ki`` rows, pads
    >= K): in place; returns the (K,) overflow mask."""
    if state.ntl.device.type == "cpu":
        return drain_dense_plain(state, d_ts, d_vid, d_cut, trim_ki, counts)
    k = state.length.shape[0]
    cnt = _row_counts(k, trim_ki, counts)
    _check("tlog_drain_dense", state, None, d_ts, d_vid, d_cut, cnt, k)
    ovf = torch.empty(k, dtype=torch.bool, device=state.ntl.device)
    kind = _launch("tlog_drain_dense", state, None, d_ts, d_vid, d_cut, cnt,
                   (ovf, None, None))
    _build.count(drain_dense, state.ntl.device, kind)
    return ovf


_build.counter(drain_dense, classes=True)  # .classes: by drain_plan class


def drain_sparse(state: TLogState, key_idx, d_ts, d_vid, d_cut, counts):
    """Batched drain at UNIQUE rows ``key_idx`` ((B,) int32, pads >= K or
    negative) with per-slot trim counts: in place; returns (overflow,
    length, cutoff) per slot."""
    if state.ntl.device.type == "cpu":
        return drain_sparse_plain(state, key_idx, d_ts, d_vid, d_cut, counts)
    b = key_idx.shape[0]
    _check("tlog_drain_sparse", state, key_idx, d_ts, d_vid, d_cut, counts, b)
    dev = state.ntl.device
    outs = (torch.empty(b, dtype=torch.bool, device=dev),
            torch.empty(b, dtype=torch.int32, device=dev),
            torch.empty(b, dtype=torch.int64, device=dev))
    kind = _launch("tlog_drain_sparse", state, key_idx, d_ts, d_vid, d_cut, counts,
                   outs)
    _build.count(drain_sparse, dev, kind)
    return outs


_build.counter(drain_sparse, classes=True)  # .classes: by drain_plan class


# ---- the JAX package's entry points -------------------------------------------


def _noop_counts(n: int, device) -> torch.Tensor:
    return torch.full((n,), TRIM_NOOP, dtype=torch.int64, device=device)


def _no_delta(n: int, device):
    """A one-column delta with no entry (vid -1) per slot."""
    return (torch.zeros((n, 1), dtype=torch.int64, device=device),
            torch.full((n, 1), -1, dtype=torch.int64, device=device))


def converge_batch(state: TLogState, key_idx, d_ts, d_vid, d_cutoff):
    """Join delta logs into the keyspace in place: (state, overflow).
    key_idx (B,) int32 rows, or None for the dense path (delta rows
    aligned 1:1 with the keyspace)."""
    if key_idx is None:
        none = torch.full((1,), -1, dtype=torch.int32, device=d_ts.device)
        return state, drain_dense(state, d_ts, d_vid, d_cutoff, none,
                                  _noop_counts(1, d_ts.device))
    counts = _noop_counts(key_idx.shape[0], d_ts.device)
    return state, drain_sparse(state, key_idx, d_ts, d_vid, d_cutoff, counts)[0]


def insert_batch(state: TLogState, key_idx, ts, vid):
    """Local INS of one entry per key (unique keys): a 1-entry log join."""
    return converge_batch(state, key_idx, ts[:, None], vid[:, None],
                          torch.zeros_like(ts))


def trimat_batch(state: TLogState, key_idx, t) -> TLogState:
    """TRIMAT: raise each key's cutoff to max(cutoff, t) and drop older
    entries: a join of an empty log with cutoff t."""
    d_ts, d_vid = _no_delta(key_idx.shape[0], t.device)
    drain_sparse(state, key_idx, d_ts, d_vid, t,
                 _noop_counts(key_idx.shape[0], t.device))
    return state


def trim_batch(state: TLogState, key_idx, count) -> TLogState:
    """TRIM: cutoff := ts of the entry at index count-1; count 0 is CLR;
    a count above the length, or negative, changes nothing."""
    d_ts, d_vid = _no_delta(key_idx.shape[0], count.device)
    drain_sparse(state, key_idx, d_ts, d_vid, torch.zeros_like(d_ts[:, 0]),
                 count.to(torch.int64))
    return state


def clear_batch(state: TLogState, key_idx) -> TLogState:
    """CLR: cutoff := latest ts + 1; no-op on empty logs."""
    return trim_batch(state, key_idx, torch.zeros(
        key_idx.shape[0], dtype=torch.int64, device=key_idx.device))


def converge_then_trim(state: TLogState, key_idx, d_ts, d_vid, d_cutoff,
                       trim_idx, counts):
    """Fused drain + TRIM/CLR: one launch when the trims sit at the
    drain's own rows (the sparse repo path) or on the dense path; other
    trim rows take a second launch after the merge."""
    if key_idx is None:
        return state, drain_dense(state, d_ts, d_vid, d_cutoff, trim_idx, counts)
    if trim_idx is key_idx or torch.equal(trim_idx, key_idx):
        return state, drain_sparse(state, key_idx, d_ts, d_vid, d_cutoff,
                                   counts)[0]
    state, ovf = converge_batch(state, key_idx, d_ts, d_vid, d_cutoff)
    return trim_batch(state, trim_idx, counts), ovf


def read_row(state: TLogState, key: int):
    """GET: one key's padded row decoded to (ts int64 bits, vid int64,
    length)."""
    row = tuple(_u32(p[key][None]) for p in _planes(state))
    vid = _i32(~row[-1]).to(torch.int64) - 1
    return _ts_of(row, state.wide)[0], vid[0], state.length[key]


def _np_u32(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 else x.astype(np.uint32)


def decode_ts_np(nth, ntl):
    """Host-side plane decode to u64 ts; nth is None for narrow states.
    Takes u32 planes or their int32 bit patterns."""
    low = (~_np_u32(ntl)).astype(np.uint64)
    if nth is None:
        return low
    hi = (~_np_u32(nth)).astype(np.uint64)
    return (hi << np.uint64(32)) | low


def decode_vid_np(nv):
    """Host-side nv plane -> int64 vids (-1 for empty slots); exact for
    vids < 2**31 (interner-enforced)."""
    return (~_np_u32(nv)).astype(np.int64) - 1


def encode_vid_np(vid):
    """Host-side int64 vids -> nv plane as u32 (-1 maps to PAD)."""
    return ~(np.asarray(vid, np.int64).astype(np.uint32) + np.uint32(1))
