"""Device-resident UJSON keyspace: hot documents live on the device.

The port of jylis_tpu/ops/ujson_resident.py. The hot keys' packed rows
(ops/ujson_device.DocBatch) stay RESIDENT between drains. A drain
encodes ONLY the new deltas into a (K, D, W) grid, folds each key's D
deltas and joins the result into that key's resident row on the device,
and decodes nothing: reads decode lazily.

Sharding: with a mesh, the row axis splits into one contiguous block of
rows per keys shard, each on its shard's device, and the drain uses the
row-ALIGNED fold (`fold_join_aligned`: grid row i joins resident row i,
no gather or scatter) on every shard; single-device serving uses the
subset fold (`fold_join_subset`: gather rows, join, scatter back), so a
drain touching few of many resident keys does not pay a full-batch
join.

The device steps:

* the fold of each key's stack: D <= 64 takes the closed-form flat rule
  (`fold_flat`, the hand-written kernel ``ujson_fold_flat``,
  csrc/ujson_fold_flat.cu), deeper stacks the pairwise tree of
  ops/ujson_device (``ujson_join`` once per level);
* the join of the folded rows into the resident rows, with the
  context-compaction epilogue and the fit to the store's bucketed widths
  fused into the same ``ujson_join`` launch, written back in place at
  each key's row (or, when the widths change, into the refitted planes);
* everything else (live widths, eviction, admission, capacity and
  replica-column growth, the narrow repack and the widen, the payload
  remap) is plain torch on the device.

On CPU tensors the kernels' plain versions run instead. Every function
here that the JAX package jits returns the new planes; the ones that
fold may update the resident planes in place (the port's saving: the
JAX package returns new arrays), so a caller keeps only what they
return.

Host bookkeeping is the JAX store's: the key -> row map, free rows, the
replica-id and payload interners, the dot layout (shift), and the width
upper bounds the fold slices to, kept as a bounded pipeline of in-flight
folds whose live widths copy to pinned host memory behind a CUDA event
(never read before the event completes). Row 0 is a permanent identity
scratch row: padded subset slots point at it and write identical bytes.
When every delta of a grid is a ``WireUJSON`` (the native codec's
receive path) the grid fills straight from the wire bytes
(``_grid_from_wire``, ops/ujson_wire.grid_from_wire, with the JAX
store's widen and rep-budget retries); any plain ``UJSON`` in the grid
takes the object encoder, as in the JAX store.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..parallel.sharded import Keyspace
from ..utils.batching import bucket
from . import _build, row_plan
from . import ujson_device as dev
from .ujson_device import (  # noqa: F401 (clear_rows: the JAX module's name)
    PAD32, DocBatch, _i32, _member, _pad_of, _sort_rows, _u32,
    clear_rows, fit, pad_of,
)

FLAT_MAX = 64  # deepest stack the flat rule folds (the JAX crossover)


# ---- the flat fold: kernel and plain version -------------------------------------


def _flat_col_seq(x: torch.Tensor, shift: int, r: int):
    """(vv column, seq as u32) of each dot as JAX's `_fold_flat_one`
    decodes them (jylis_tpu/ops/ujson_resident.py:107-108): the column
    wrapped to int32, then min(., r - 1), then indexed as JAX indexes,
    a negative index counting from the end and clamped to 0. The join's
    decode (ujson_device._mask_col_seq) differs only for a negative
    column (a wide column >= 2^31, which no encoder mints): there it
    matches no column."""
    col, seq = dev._mask_col_seq(x, shift, r)
    return torch.clamp(torch.where(col < 0, col + r, col), min=0), seq


def fold_flat_plain(grid: DocBatch, shift: int) -> DocBatch:
    """jylis_tpu/ops/ujson_resident.py `_fold_flat_one` on every key of a
    (K, D, W) grid: an entry survives iff every delta contains it or does
    not cover it; survivors sorted, the last copy (flat order) of a
    duplicated dot keeps its payload id; vv max; clouds sorted and
    deduplicated. Returns (K, D*W) / (K, R) / (K, D*C) planes. Keys go
    in blocks so the (keys, D, E) probe matrices stay bounded."""
    k, d, w = grid.dots.shape
    e = d * w
    block = max(1, (1 << 24) // max(d * e, 1))
    parts = [_fold_flat_block(DocBatch(*(p[i : i + block] for p in grid)), shift)
             for i in range(0, k, block)]
    return DocBatch(*(torch.cat(ps, 0) for ps in zip(*parts)))


def _fold_flat_block(g: DocBatch, shift: int) -> DocBatch:
    k, d, w = g.dots.shape
    pad = pad_of(g.dots)
    r = g.vv.shape[-1]
    dots = g.dots.reshape(k, d * w)
    pay = g.pay.reshape(k, d * w)
    valid = dots != pad
    col, seq = _flat_col_seq(dots, shift, r)
    # (k, D, E): does delta j cover entry e? does it contain it?
    vvj = torch.gather(_u32(g.vv), 2, col[:, None, :].expand(k, d, d * w))
    q = dots[:, None, :].expand(k, d, d * w).reshape(k * d, d * w)
    in_cloud = _member(g.cloud.reshape(k * d, -1), q).reshape(k, d, d * w)
    present = _member(g.dots.reshape(k * d, w), q).reshape(k, d, d * w)
    cover = (seq[:, None, :] <= vvj) | in_cloud
    survive = valid & torch.all(present | ~cover, dim=1)
    out_dots, out_pay = _sort_rows(torch.where(survive, dots, pad),
                                   torch.where(survive, pay, -1))
    dup = torch.zeros_like(survive)
    dup[:, :-1] = out_dots[:, :-1] == out_dots[:, 1:]
    d2, p2 = _sort_rows(torch.where(dup, pad, out_dots), torch.where(dup, -1, out_pay))
    vv = _i32(_u32(g.vv).max(dim=1).values)
    cl = _sort_rows(g.cloud.reshape(k, -1))[0]
    cdup = torch.zeros_like(cl, dtype=torch.bool)
    cdup[:, 1:] = cl[:, 1:] == cl[:, :-1]
    return DocBatch(d2, p2, vv, _sort_rows(torch.where(cdup, pad, cl))[0])


# the launch plan (csrc/ujson_fold_flat.cu): a warp per key, the deltas in
# registers, while D <= 64 and W, C <= 8 (the kernel's limit; at every key
# count measured, 64 to 4,096, the warp beat a CTA); else a CTA per key
# while its rows fit row_plan.SMEM_LIMIT of shared memory and either the
# launch fills the card or the key is under FLAT_SPREAD_BYTES; else a
# thread-block cluster per key (crossovers measured on an H100: PERF.md
# §6). FLAT_CLASS, when set, sends a launch to that class wherever the
# class can take it (the tests and the sweep force each class so).
FLAT_SPREAD_BYTES = 16 * 1024
FLAT_CLASS = None
_FLAT_KINDS = {"warp": 0, "cta": 1, "cluster": 2}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_FLAT_ARGS = [ctypes.c_int] + [_P] * 4 + [_LL] * 5 + [_P] * 4 + [_LL] * 4 + [_P] \
    + [_LL] * 4 + [_P]


def flat_work_bytes(tsize: int, d: int, w: int, c: int, r: int) -> int:
    """Bytes of a CTA's work buffer in csrc/ujson_fold_flat.cu: the key's
    dots, clouds and vv, their kept bits and per-word prefix counts, four
    counts per delta and the live-prefix scans."""
    words = -(-w // 32) + -(-c // 32)
    return row_plan.align(tsize * d * (w + c) + 4 * d * r + 8 * d * words + 16 * d
                          + 8 * (d + 1), 16)


def flat_plan(nkeys: int, tsize: int, d: int, w: int, c: int, r: int) -> row_plan.RowPlan:
    """How ``ujson_fold_flat`` runs ``nkeys`` keys of (d, w, c, r) planes:
    the class, keys a CTA, shared memory, grid, CTAs a key (cluster) and
    deltas a CTA takes, and device scratch."""
    force = FLAT_CLASS
    if d <= 64 and max(w, c) <= 8 and force in (None, "warp"):
        cap = d * (4 if max(w, c) <= 4 else 8)  # a list's items
        slice_ = row_plan.align(2 * tsize * cap + 16 * cap + 4 * d * (r | 1), 16)
        plan = row_plan.plan_rows(nkeys, slice_, slice_, row_plan.SMEM_LIMIT, 1)
        if plan.kind == "warp":
            return plan._replace(held=d)
    whole = flat_work_bytes(tsize, d, w, c, r)
    spread = nkeys >= row_plan.SMS or whole <= FLAT_SPREAD_BYTES or force == "cta"
    if whole <= row_plan.SMEM_LIMIT and spread and force != "cluster":
        return row_plan.RowPlan("cta", 1, row_plan.CTA_THREADS, whole, nkeys, 0, whole,
                                1, d)
    words = -(-w // 32) + -(-c // 32)
    return row_plan.plan_cluster(nkeys, d, lambda held: row_plan.align(8 * (held + 1), 16),
                                 8 * d * words + 16 * d)


def fold_flat(grid: DocBatch, shift: int) -> DocBatch:
    """The flat fold of a (K, D, W) grid (D <= FLAT_MAX on the store's
    path): a CPU tensor runs `fold_flat_plain`; a CUDA tensor launches
    csrc/ujson_fold_flat.cu (one CUDA kernel a call, in the class
    ``flat_plan`` picks) or raises."""
    if grid.dots.device.type == "cpu":
        return fold_flat_plain(grid, shift)
    device = grid.dots.device
    dtype = grid.dots.dtype
    wide = dtype == torch.int64
    if dtype not in (torch.int32, torch.int64) or wide != (shift == 32):
        raise ValueError(f"ujson_fold_flat: dots {dtype} do not match shift {shift}")
    k, d, w = grid.dots.shape
    r = grid.vv.shape[-1]
    c = grid.cloud.shape[-1]
    for t, want, shape in ((grid.dots, dtype, (k, d, w)), (grid.pay, torch.int32, (k, d, w)),
                           (grid.vv, torch.int32, (k, d, r)), (grid.cloud, dtype, (k, d, c))):
        if t.device != device or t.dtype != want or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"ujson_fold_flat: expected contiguous {want} {shape} on {device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if r < 1:
        raise ValueError("ujson_fold_flat: vv needs at least one column")
    out = DocBatch(torch.empty((k, d * w), dtype=dtype, device=device),
                   torch.empty((k, d * w), dtype=torch.int32, device=device),
                   torch.empty((k, r), dtype=torch.int32, device=device),
                   torch.empty((k, d * c), dtype=dtype, device=device))
    plan = flat_plan(k, 8 if wide else 4, d, w, c, r)
    scratch = (torch.empty(plan.scratch, dtype=torch.uint8, device=device)
               if plan.scratch else None)
    fn = _build.function("ujson_fold_flat", "jt_ujson_fold_flat", _FLAT_ARGS)
    with torch.cuda.device(device):
        rc = fn(int(wide), *(t.data_ptr() for t in grid), d, w, c, r, shift,
                *(t.data_ptr() for t in out), _FLAT_KINDS[plan.kind], plan.rows_per_cta,
                plan.cluster, plan.held, None if scratch is None else scratch.data_ptr(),
                plan.stride, k, plan.grid, plan.smem,
                torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, "ujson_fold_flat")
    _build.count(fold_flat, device, plan.kind)
    return out


_build.counter(fold_flat, classes=True)  # .classes: by flat_plan class


# ---- the fused drains ------------------------------------------------------------


def _fold_grid(grid: DocBatch, shift: int) -> DocBatch:
    """(K, D, W) grid -> one folded row per key: the flat rule for
    D <= FLAT_MAX, the pairwise tree above it (the JAX crossover)."""
    if grid.dots.shape[1] <= FLAT_MAX:
        return fold_flat(grid, shift)
    return dev.fold_segments(grid, shift=shift)


def fold_join_subset(resident: DocBatch, grid: DocBatch, idx, shift: int,
                     out_w: int, out_c: int):
    """Fold each grid segment and join it into resident rows ``idx``
    ((n,) int32; rows unique except padded slots at identity row 0), the
    planes fit to (out_w, out_c). Returns (planes, live widths): the
    resident planes updated in place when the widths match. The live
    widths cover the FULL batch (the store's bound must cover every
    row)."""
    folded = _fold_grid(grid, shift)
    # the resident planes themselves when the widths hold (an in-place
    # join), else a refitted copy
    out = dev.join_rows(resident, folded, shift, a_idx=idx, finish=(out_w, out_c),
                        out=slice_widths(resident, out_w, out_c))
    return out, live_widths(out)


def fold_join_aligned(resident: DocBatch, grid: DocBatch, shift: int,
                      out_w: int, out_c: int):
    """Row-aligned variant: grid row i folds into resident row i, one
    `ujson_join` launch with no row index (b step 1) after the fold, the
    epilogue in place when the widths match. With the resident rows
    sharded, each shard runs it on its own rows: no gather, no scatter,
    no communication. Returns (planes, live widths)."""
    folded = _fold_grid(grid, shift)
    out = dev.join_rows(resident, folded, shift, finish=(out_w, out_c),
                        out=slice_widths(resident, out_w, out_c))
    return out, live_widths(out)


def fold_broadcast_rows(resident: DocBatch, deltas: DocBatch, occupied,
                        shift: int, out_w: int, out_c: int):
    """Fold a (D, W) delta batch to ONE doc and join it into every
    OCCUPIED resident row; free rows (and scratch row 0) re-clear in the
    same launch, so the live widths measure occupied rows only.
    Returns (planes, live widths), in place when the widths match."""
    g = DocBatch(*(p[None] for p in deltas))
    if deltas.dots.shape[0] <= FLAT_MAX:
        folded = fold_flat(g, shift)
    else:
        folded = DocBatch(*(p[:, 0] for p in dev._fold_body(g, shift)))
    out = dev.join_rows(resident, folded, shift, finish=(out_w, out_c),
                        occupied=occupied, out=slice_widths(resident, out_w, out_c))
    return out, live_widths(out)


# ---- layout helpers (plain torch on the device) ------------------------------------


def slice_widths(batch: DocBatch, w: int, c: int) -> DocBatch:
    """Re-bucket plane widths to (w, c) — safe whenever w/c cover the
    live widths, because joined rows keep pads sorted to the tail."""
    pad = pad_of(batch.dots)
    return DocBatch(fit(batch.dots, w, pad), fit(batch.pay, w, -1), batch.vv,
                    fit(batch.cloud, c, pad))


def live_widths(batch: DocBatch) -> torch.Tensor:
    """(2,) int32 on the device: max live dot / cloud width over rows."""
    pad = pad_of(batch.dots)
    ld = (batch.dots != pad).sum(-1).max()
    lc = (batch.cloud != pad).sum(-1).max()
    return torch.stack([ld, lc]).to(torch.int32)


def remap_pay(batch: DocBatch, table) -> DocBatch:
    """Rewrite payload ids through a compaction table (-1 stays -1)."""
    pay = torch.where(batch.pay >= 0, table[torch.clamp(batch.pay, min=0).long()], -1)
    return DocBatch(batch.dots, pay.to(torch.int32), batch.vv, batch.cloud)


def widen_rows(batch: DocBatch, old_shift: int) -> DocBatch:
    """Narrow int32 rows -> the u64/32 layout (int64 bits). The map
    (col << old_shift | seq) -> (col << 32 | seq) is monotone, so rows
    stay sorted; narrow pads map to the wide pad."""
    mask = (1 << old_shift) - 1

    def w(plane):
        p = plane.to(torch.int64)
        return torch.where(plane == int(PAD32), -1, ((p >> old_shift) << 32) | (p & mask))

    return DocBatch(w(batch.dots), batch.pay, batch.vv, w(batch.cloud))


def repack_narrow(batch: DocBatch, old_shift: int, new_shift: int) -> DocBatch:
    """Re-pack int32 rows at a smaller shift (the caller verified every
    seq ever encoded is < 2**new_shift - 1); monotone, rows stay sorted."""
    mask = (1 << old_shift) - 1

    def w(plane):
        p = plane.to(torch.int64)
        repacked = (((p >> old_shift) << new_shift) | (p & mask)).to(torch.int32)
        return torch.where(plane == int(PAD32), plane, repacked)

    return DocBatch(w(batch.dots), batch.pay, batch.vv, w(batch.cloud))


def place_rows(batch: DocBatch, rows: DocBatch, idx) -> DocBatch:
    """Write freshly-encoded rows into free slots, in place (widths
    already harmonised by the caller)."""
    idx = idx.long()
    for p, q in zip(batch, rows):
        p[idx] = q
    return batch


def grow_capacity(batch: DocBatch, rows: int) -> DocBatch:
    """Append identity rows (capacity growth, bucketed by the caller)."""
    pad = pad_of(batch.dots)
    k = batch.dots.shape[0]

    def app(plane, fill):
        more = torch.full((rows - k,) + tuple(plane.shape[1:]), fill,
                          dtype=plane.dtype, device=plane.device)
        return torch.cat([plane, more], 0)

    return DocBatch(app(batch.dots, pad), app(batch.pay, -1), app(batch.vv, 0),
                    app(batch.cloud, pad))


def grow_reps(batch: DocBatch, n_rep: int) -> DocBatch:
    """Widen the vv plane for replica-column growth."""
    k, r = batch.vv.shape
    vv = torch.cat([batch.vv, torch.zeros((k, n_rep - r), dtype=torch.int32,
                                          device=batch.vv.device)], -1)
    return DocBatch(batch.dots, batch.pay, vv, batch.cloud)


class _Live:
    """One fold's live widths on their way to the host: per part (a
    tensor, or a list of one per part), a non-blocking copy into pinned
    memory behind a recorded CUDA event (CPU tensors: copied at once);
    ``get`` takes the max over parts."""

    __slots__ = ("host", "events")

    def __init__(self, lives):
        self.host, self.events = [], []
        for live in [lives] if isinstance(lives, torch.Tensor) else lives:
            if live.device.type == "cuda":
                host = torch.empty(2, dtype=torch.int32, pin_memory=True)
                host.copy_(live, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(live.device))
                self.events.append(event)
            else:
                host = live.clone()
            self.host.append(host)

    def ready(self) -> bool:
        return all(e.query() for e in self.events)

    def get(self) -> tuple[int, int]:
        for e in self.events:
            e.synchronize()
        return (max(int(h[0]) for h in self.host), max(int(h[1]) for h in self.host))


# ---- the store ---------------------------------------------------------------


class ResidentStore:
    """Hot UJSON keys as device-resident DocBatch rows (see the module
    docstring). Without a mesh, ``device`` holds the planes as one part;
    with one, the rows split into one part per keys shard, each on its
    shard's device (a parallel.sharded.Keyspace)."""

    ROW_BUCKET = 8  # capacity granularity (rows)
    # soft device-memory budget for the resident planes: admission stops
    # (keys fall back to the host lattice) once the plane bytes cross it
    BYTE_BUDGET = 256 << 20

    def __init__(self, n_rep: int = 8, device="cuda", mesh=None):
        self._ks = Keyspace(mesh, device)  # no parts before the first admission
        self._device = self._ks.devices[0]
        self._nrep = bucket(n_rep, 4)
        self._shift = dev.narrow_shift(self._nrep)
        self._rid_cols: dict[int, int] = {}
        self._pay_ids: dict[tuple, int] = {}
        self._pay_rev: list[tuple] = []
        # canonical-wire-bytes -> pay id (the wire grid encoder interns
        # payloads by their wire spans; identical (path, token) pairs have
        # identical canonical encodings)
        self._pay_wire: dict[bytes, int] = {}
        self._rows: dict[bytes, int] = {}
        self._free: list[int] = []
        # the width bound as a bounded pipeline: base (the newest consumed
        # fold's live widths, or admission widths) + the growth of every
        # fold still in flight
        self._base_w = 1
        self._base_c = 1
        self._floor_w = 1  # admission widths until the next exact read
        self._floor_c = 1
        self._inflight: list = []  # [(_Live, grow_w, grow_c), ...]
        # buffered broadcast deltas (fold_in_broadcast): joins commute, so
        # rounds coalesce into ONE fold at the next read/drain/threshold
        self._bcast_pend: list = []
        # the largest seq ever encoded: a context covers its dot store, so
        # this bounds every seq on the device (the narrow repack's proof)
        self._max_seq = 0

    # -- interners ----------------------------------------------------------

    def pay(self, path, token) -> int:
        k = (path, token)
        pid = self._pay_ids.get(k)
        if pid is None:
            pid = self._pay_ids[k] = len(self._pay_rev)
            self._pay_rev.append(k)
        return pid

    def pay_lookup(self, pid: int):
        pt = self._pay_rev[pid]
        if type(pt) is bytes:
            # a wire-interned payload: parse its canonical span on first
            # read (drains never need the parsed form, only decodes do)
            from ..utils.wire import Reader

            r = Reader(pt)
            path = tuple(r.str_() for _ in range(r.varint()))
            pt = (path, r.str_())
            self._pay_rev[pid] = pt
            self._pay_ids.setdefault(pt, pid)
        return pt

    # -- introspection ------------------------------------------------------

    def __contains__(self, key: bytes) -> bool:
        return key in self._rows

    def __len__(self) -> int:
        return len(self._rows)

    def keys(self):
        return self._rows.keys()

    @property
    def _batch(self) -> DocBatch | None:
        """The resident planes as one DocBatch: the single part itself,
        or, with a mesh, the parts gathered on the first device (a copy,
        for reading)."""
        return None if self._ks.parts is None else self._ks.whole()

    def block(self) -> None:
        """Wait for every queued device mutation (timing/shutdown)."""
        self._flush_broadcast()
        for part in self._ks.parts or ():
            if part.dots.device.type == "cuda":
                torch.cuda.synchronize(part.dots.device)

    def approx_bytes(self) -> int:
        """Resident plane footprint (current shapes)."""
        return sum(p.numel() * p.element_size() for part in self._ks.parts or ()
                   for p in part)

    def full(self) -> bool:
        """True when admission should stop (BYTE_BUDGET crossed)."""
        return self.approx_bytes() >= self.BYTE_BUDGET

    # -- layout plumbing ----------------------------------------------------

    def _row_axis(self) -> int:
        return self._ks.key_cap

    def _capacity_for(self, rows: int) -> int:
        return self._ks.round_cap(bucket(max(rows, 2), self.ROW_BUCKET))

    PIPE_DEPTH = 2  # folds allowed in flight before blocking on the oldest

    def _consume(self, block: bool) -> bool:
        """Consume the oldest in-flight fold's live widths into the base."""
        if not self._inflight:
            return False
        live, _gw, _gc = self._inflight[0]
        if not block and not live.ready():
            return False
        self._inflight.pop(0)
        lw, lc = live.get()
        # the floor covers rows admitted after the consumed fold launched
        self._base_w = max(lw, self._floor_w, 1)
        self._base_c = max(lc, self._floor_c, 1)
        return True

    def _budget_widths(self, grow_w: int, grow_c: int) -> tuple[int, int]:
        """Width targets for the next fold: the newest consumed fold's
        live widths plus the growth of everything still in flight; past
        PIPE_DEPTH the consume blocks (bounded pipelining)."""
        while self._consume(block=False):
            pass
        while len(self._inflight) >= self.PIPE_DEPTH:
            self._consume(block=True)
        ub_w = self._base_w + grow_w + sum(g for _, g, _c in self._inflight)
        ub_c = self._base_c + grow_c + sum(c for _, _g, c in self._inflight)
        if self._ks.parts is None:
            return bucket(ub_w, 4), bucket(ub_c, 4)
        bw = self._ks.parts[0].dots.shape[-1]
        bc = self._ks.parts[0].cloud.shape[-1]
        out_w = bucket(ub_w, 4)
        out_c = bucket(ub_c, 4)
        # shape hysteresis: keep the current width unless it must grow or
        # can shrink 4x
        if out_w < bw and out_w * 4 > bw:
            out_w = bw
        if out_c < bc and out_c * 4 > bc:
            out_c = bc
        return out_w, out_c

    def _grid_to_device(self, grid: DocBatch, device=None) -> DocBatch:
        """Ship host grid planes (JAX dtypes) to ``device`` (default: the
        store's), making all-identity planes there instead of copying
        them."""
        device = self._device if device is None else device
        pad = _pad_of(grid.dots.dtype)

        def put(p, fill):
            uniform = (not p.any()) if fill == 0 else bool((p == fill).all())
            if not uniform:
                return dev.plane_to_torch(p, device)
            bits = dev.plane_to_torch(np.asarray([fill], p.dtype), "cpu")
            return torch.full(p.shape, int(bits[0]), dtype=bits.dtype, device=device)

        return DocBatch(put(grid.dots, pad), put(grid.pay, -1), put(grid.vv, 0),
                        put(grid.cloud, pad))

    def _note_fold(self, lives: list, gw: int, gc: int) -> None:
        """Enqueue a fold in the bounded pipeline: its live widths (one
        per part) start their copy to the host now; its growth counts
        join the bound."""
        self._inflight.append((_Live(lives), gw, gc))

    def _note_seqs(self, docs) -> None:
        """Track the max seq across delta contexts (a context covers its
        store, so vv + cloud bound the entries too). Wire deltas carry
        their measured max_seq: reading .ctx would materialise them."""
        m = self._max_seq
        for d in docs:
            ms = getattr(d, "max_seq", None)
            if ms is not None:
                if ms > m:
                    m = ms
                continue
            for s in d.ctx.vv.values():
                if s > m:
                    m = s
            for _, s in d.ctx.cloud:
                if s > m:
                    m = s
        self._max_seq = m

    def _widen(self) -> None:
        if self._shift == 32:
            return
        if self._ks.parts is not None:
            old = self._shift
            self._ks.map(lambda p: widen_rows(p, old))
        self._shift = 32

    def _ensure_reps(self) -> None:
        self._grow_reps_to(len(self._rid_cols))

    def _grow_reps_to(self, n: int) -> None:
        """Replica-column growth to at least n: widen vv columns, and
        re-pack the dot layout if the narrow budget no longer fits — to
        a smaller narrow shift when every seq ever encoded still fits it,
        else to u64/32."""
        if self._shift != 32 and n > (1 << (31 - self._shift)):
            s2 = dev.narrow_shift(bucket(n, 4))
            if self._max_seq < (1 << s2) - 1:
                if self._ks.parts is not None:
                    old = self._shift
                    self._ks.map(lambda p: repack_narrow(p, old, s2))
                self._shift = s2
            else:
                self._widen()
        if n > self._nrep:
            self._nrep = bucket(n, 4)
            if self._ks.parts is not None:
                self._ks.map(lambda p: grow_reps(p, self._nrep))

    def _encode_rows(self, docs) -> DocBatch:
        """Encode host docs (host planes) at the store's current layout,
        migrating the store when the narrow layout can't hold them.
        OverflowError escapes only when even u64/32 can't."""
        while True:
            try:
                b = dev._encode_docs_np(
                    docs, self._rid_cols, self.pay, self._nrep, shift=self._shift
                )
            except OverflowError:
                if self._shift == 32:
                    raise
                self._widen()
                continue
            except ValueError:  # rid interner outgrew the vv budget
                self._ensure_reps()
                continue
            self._ensure_reps()
            return b

    def _encode_grid(self, groups) -> DocBatch:
        """The (K, D, W) host grid of the groups: from the wire bytes when
        every delta is a WireUJSON, else the object encoder."""
        wire = self._grid_from_wire(groups)
        if wire is not None:
            return wire
        while True:
            try:
                g = dev.encode_doc_groups_np(
                    groups, self._rid_cols, self.pay, self._nrep, shift=self._shift
                )
            except OverflowError:
                if self._shift == 32:
                    raise
                self._widen()
                continue
            except ValueError:
                self._ensure_reps()
                continue
            self._ensure_reps()
            return g

    def _grid_from_wire(self, groups) -> DocBatch | None:
        """The native wire->planes grid encoder (jylis_tpu/ops/
        ujson_resident.py:718-806): the (K, D, W) host grid fills straight
        from the deltas' raw payload bytes. Returns None (the caller takes
        the object encoder) when any delta is a plain document."""
        from .ujson_wire import GridOverflow, GridRepBudget, WireUJSON, grid_from_wire

        flat = []
        for g in groups:
            for d in g:
                if type(d) is not WireUJSON:
                    return None
                flat.append(d)
        if not flat:
            return None
        d_dim = bucket(max(len(g) for g in groups), 1)
        w = bucket(max(max(d.n_entries for d in flat), 1), 4)
        c = bucket(max(max(d.n_cloud for d in flat), 1), 4)
        rows = len(groups) * d_dim
        dest = np.fromiter(
            (k * d_dim + j for k, g in enumerate(groups) for j in range(len(g))),
            np.int64, count=len(flat),
        )
        while True:
            known = [0] * len(self._rid_cols)
            for rid, col in self._rid_cols.items():
                known[col] = rid
            try:
                dots, pay, vv, cloud, new_rids, spans = grid_from_wire(
                    flat, dest, rows, w, c, self._shift, self._nrep, known
                )
            except GridOverflow:
                if self._shift == 32:
                    raise OverflowError("seq beyond the u64/32 layout") from None
                self._widen()
                continue
            except GridRepBudget as e:
                self._grow_reps_to(e.needed)
                continue
            break
        for rid in new_rids:
            self._rid_cols[rid] = len(self._rid_cols)
        self._ensure_reps()
        if self._nrep > vv.shape[-1]:
            # new columns crossed a vv bucket after a successful fill:
            # widen the grid's vv plane to the store's
            vv = np.concatenate(
                [vv, np.zeros((rows, self._nrep - vv.shape[-1]), np.uint32)], axis=-1
            )
        if spans:
            # new payloads intern by their canonical span; parsing to
            # (path, token) waits for pay_lookup (reads). A payload that
            # also arrives through the object path gets a second id:
            # harmless, ids only name payloads and joins dedup dots
            lut = np.empty(len(spans), np.int32)
            pw, rev = self._pay_wire, self._pay_rev
            for i, span in enumerate(spans):
                gid = pw.get(span)
                if gid is None:
                    gid = pw[span] = len(rev)
                    rev.append(span)
                lut[i] = gid
            pay = np.where(pay >= 0, lut[np.maximum(pay, 0)], -1).astype(np.int32)
        k = len(groups)
        return DocBatch(
            dots.reshape(k, d_dim, w),
            pay.reshape(k, d_dim, w),
            vv.reshape(k, d_dim, self._nrep),
            cloud.reshape(k, d_dim, c),
        )

    # -- admission / eviction ------------------------------------------------

    def admit(self, items: list[tuple[bytes, object]]) -> None:
        """Make keys resident with their current host docs (encoded ONCE;
        after this only reads ever decode them again)."""
        self._flush_broadcast()
        items = [(k, d) for k, d in items if k not in self._rows]
        if not items:
            return
        self._note_seqs([d for _, d in items])
        rows_np = self._encode_rows([d for _, d in items])
        self._base_w = max(self._base_w, rows_np.dots.shape[-1])
        self._base_c = max(self._base_c, rows_np.cloud.shape[-1])
        self._floor_w = max(self._floor_w, rows_np.dots.shape[-1])
        self._floor_c = max(self._floor_c, rows_np.cloud.shape[-1])
        if self._ks.parts is None:
            cap = self._capacity_for(len(items) + 1)
            dtype = torch.int32 if self._shift < 32 else torch.int64
            pad = int(PAD32) if self._shift < 32 else -1
            w = rows_np.dots.shape[-1]
            c = rows_np.cloud.shape[-1]
            nrep = self._nrep
            self._ks.init(cap, lambda n, d: DocBatch(
                torch.full((n, w), pad, dtype=dtype, device=d),
                torch.full((n, w), -1, dtype=torch.int32, device=d),
                torch.zeros((n, nrep), dtype=torch.int32, device=d),
                torch.full((n, c), pad, dtype=dtype, device=d),
            ))
            self._free = list(range(cap - 1, 0, -1))  # row 0 is scratch
        need = len(items)
        if len(self._free) < need:
            old = self._row_axis()
            cap = self._capacity_for(old + need - len(self._free))
            # a mesh re-splits: the rows per shard change with capacity
            self._ks.grow(lambda b: grow_capacity(b, cap))
            self._free = list(range(cap - 1, old - 1, -1)) + self._free
        # harmonise widths between the resident planes and the new rows
        bw, bc = self._ks.parts[0].dots.shape[-1], self._ks.parts[0].cloud.shape[-1]
        rw, rc = rows_np.dots.shape[-1], rows_np.cloud.shape[-1]
        if rw > bw or rc > bc:
            w, c = max(rw, bw), max(rc, bc)
            self._ks.map(lambda p: slice_widths(p, w, c))
            bw, bc = w, c
        if rw < bw or rc < bc:
            rows_np = _pad_planes_np(rows_np, bw, bc)
        idx = np.empty(need, np.int64)
        for j, (key, _) in enumerate(items):
            row = self._free.pop()
            self._rows[key] = row
            idx[j] = row
        for part, sel, local in self._ks.split_rows(idx):
            d = part.dots.device
            place_rows(part, dev.to_torch(DocBatch(*(p[sel] for p in rows_np)), d),
                       torch.from_numpy(local).to(d))

    def evict(self, key: bytes):
        """Decode a key's current doc and drop its row (demotion)."""
        doc = self.read(key)
        self.discard(key)
        return doc

    def discard(self, key: bytes) -> None:
        """Drop a key's row WITHOUT decoding."""
        self._flush_broadcast()  # the departing row must absorb its share
        row = self._rows.pop(key)
        # the identity row, written in place (the JAX store rebuilds every
        # plane through clear_rows)
        batch, local = self._ks.locate(row)
        pad = pad_of(batch.dots)
        for plane, fill in zip(batch, (pad, -1, 0, pad)):
            plane[local] = fill
        self._free.append(row)

    # -- the drain ----------------------------------------------------------

    def fold_in(self, pending: dict[bytes, list]) -> None:
        """Fold each key's pending deltas into its resident row — one
        fused drain for every key, no host read-backs. Raises
        OverflowError (rows unchanged) when a delta exceeds the u64/32
        layout; the caller demotes those keys to the host lattice."""
        self._flush_broadcast()
        pending = {k: v for k, v in pending.items() if v and k in self._rows}
        if not pending:
            return
        self._note_seqs([d for lst in pending.values() for d in lst])
        # width bound: each row grows by at most its group's entry/cloud
        # counts (the join can only drop)
        grow_w = grow_c = 0
        for lst in pending.values():
            grow_w = max(grow_w, sum(_n_entries(d) for d in lst))
            grow_c = max(grow_c, sum(_n_cloud(d) for d in lst))
        if self._ks.mesh is None:
            # single device: the subset fold's grid covers exactly the
            # drained keys (the aligned grid spans every capacity row —
            # only worth it when sharding forbids gathers/scatters)
            self._fold_subset(pending, grow_w, grow_c)
        else:
            self._fold_aligned(pending, grow_w, grow_c)

    # buffered broadcast deltas past this count force a flush (a memory
    # and width bound on the single fold's delta axis)
    BCAST_FLUSH_DELTAS = 16384

    def fold_in_broadcast(self, deltas: list) -> None:
        """Fold one delta list into EVERY resident row (the all-replicas
        anti-entropy shape), lazily: rounds buffer and coalesce into one
        fold at the next read, per-key drain, admission/eviction, or
        threshold."""
        if not deltas or not self._rows:
            return
        self._note_seqs(deltas)
        self._bcast_pend.extend(deltas)
        if len(self._bcast_pend) >= self.BCAST_FLUSH_DELTAS:
            self._flush_broadcast()

    def _flush_broadcast(self) -> None:
        if not self._bcast_pend:
            return
        deltas, self._bcast_pend = self._bcast_pend, []
        if not self._rows:
            return
        from .ujson_host import UJSON

        # wire path: the whole list as ONE (1, D, W) grid segment
        grid = self._grid_from_wire([list(deltas)])
        if grid is not None:
            rows_np = DocBatch(*(p[0] for p in grid))
        else:
            d = bucket(len(deltas), 4)  # identity-pad: bound the shapes
            rows_np = self._encode_rows(list(deltas) + [UJSON()] * (d - len(deltas)))
        grow_w = sum(_n_entries(x) for x in deltas)
        grow_c = sum(_n_cloud(x) for x in deltas)
        out_w, out_c = self._budget_widths(grow_w, grow_c)
        occ = np.zeros(self._row_axis(), bool)
        occ[list(self._rows.values())] = True
        rps = self._ks.rows_per_shard
        # the delta batch's leading axis is deltas, not resident rows: it
        # goes whole to every part's device
        ins = [(dev.to_torch(rows_np, p.dots.device),
                torch.from_numpy(occ[i * rps:(i + 1) * rps]).to(p.dots.device))
               for i, p in enumerate(self._ks.parts)]
        outs = [fold_broadcast_rows(p, batch, o, shift=self._shift, out_w=out_w,
                                    out_c=out_c)
                for p, (batch, o) in zip(self._ks.parts, ins)]
        self._ks.parts = [o for o, _ in outs]
        self._note_fold([live for _, live in outs], grow_w, grow_c)

    def _fold_subset(self, pending, grow_w: int, grow_c: int) -> None:
        ks = sorted(pending)
        n = bucket(len(ks), 4)
        groups = [pending[k] for k in ks] + [[] for _ in range(n - len(ks))]
        grid = self._encode_grid(groups)
        out_w, out_c = self._budget_widths(grow_w, grow_c)
        idx = np.zeros(n, np.int32)  # pad slots -> scratch row 0
        for j, k in enumerate(ks):
            idx[j] = self._rows[k]
        grid = self._grid_to_device(grid)
        out, live = fold_join_subset(
            self._ks.parts[0], grid, torch.from_numpy(idx).to(self._device),
            shift=self._shift, out_w=out_w, out_c=out_c,
        )
        self._ks.parts = [out]
        self._note_fold([live], grow_w, grow_c)

    def _fold_aligned(self, pending, grow_w: int, grow_c: int) -> None:
        """The mesh's drain: a grid over every capacity row (identity
        groups where nothing is pending), each part's slice of it moved
        to the part's device first, then `fold_join_aligned` launched on
        every part."""
        cap = self._row_axis()
        groups: list[list] = [[] for _ in range(cap)]
        for k, lst in pending.items():
            groups[self._rows[k]] = lst
        grid = self._encode_grid(groups)
        out_w, out_c = self._budget_widths(grow_w, grow_c)
        rps = self._ks.rows_per_shard
        grids = [self._grid_to_device(DocBatch(*(g[i * rps:(i + 1) * rps] for g in grid)),
                                      p.dots.device)
                 for i, p in enumerate(self._ks.parts)]
        outs = [fold_join_aligned(p, g, shift=self._shift, out_w=out_w, out_c=out_c)
                for p, g in zip(self._ks.parts, grids)]
        self._ks.parts = [o for o, _ in outs]
        self._note_fold([live for _, live in outs], grow_w, grow_c)

    # -- reads ---------------------------------------------------------------

    def read(self, key: bytes):
        """Decode ONE key's doc (a device->host pull of its row)."""
        return self.read_many([key])[0]

    def _take(self, rows: np.ndarray) -> DocBatch:
        """Host planes (JAX dtypes) of the global ``rows``, in order."""
        pos, subs = [], []
        for part, sel, local in self._ks.split_rows(rows):
            idx = torch.from_numpy(local).to(part.dots.device)
            subs.append(dev.to_numpy(DocBatch(*(p[idx] for p in part))))
            pos.append(sel)
        order = np.argsort(np.concatenate(pos), kind="stable")
        return DocBatch(*(np.concatenate(ps)[order] for ps in zip(*subs)))

    def read_many(self, keys: list[bytes]) -> list:
        self._flush_broadcast()
        np_sub = self._take(np.array([self._rows[k] for k in keys], np.int64))
        # a full read (no duplicate keys) pulled every row anyway:
        # re-tighten the width bounds and re-bucket the planes for free
        full = len(keys) == len(self._rows) and len(set(keys)) == len(keys)
        if full:
            pad = _pad_of(np_sub.dots.dtype)
            self._base_w = max(int((np_sub.dots != pad).sum(axis=1).max()), 1)
            self._base_c = max(int((np_sub.cloud != pad).sum(axis=1).max()), 1)
            self._inflight.clear()  # the pull reflects every queued fold
            self._floor_w = self._floor_c = 1
            w = bucket(self._base_w, 4)
            c = bucket(self._base_c, 4)
            if w < self._ks.parts[0].dots.shape[-1] or c < self._ks.parts[0].cloud.shape[-1]:
                self._ks.map(lambda p: slice_widths(p, w, c))
        cols_rid = {c: r for r, c in self._rid_cols.items()}
        docs = dev.decode_batch(np_sub, cols_rid, self.pay_lookup, shift=self._shift)
        if full:
            self._compact_pay(np_sub)
        return docs

    def _compact_pay(self, np_sub: DocBatch) -> None:
        """Payload-interner epoch compaction on full reads (the pulled pay
        planes ARE the live-id census) when dead ids dominate: rebuild
        the interner from the live ids and remap the device plane."""
        live = np.unique(np_sub.pay)
        live = live[live >= 0]
        if len(self._pay_rev) <= 2 * max(len(live), 16):
            return
        table = np.full(len(self._pay_rev), -1, np.int32)
        new_rev = []
        for pid in live:
            table[pid] = len(new_rev)
            new_rev.append(self._pay_rev[pid])
        self._pay_rev = new_rev
        self._pay_ids = {k: i for i, k in enumerate(new_rev)}
        self._pay_wire = {
            span: int(table[pid]) for span, pid in self._pay_wire.items() if table[pid] >= 0
        }
        table = torch.from_numpy(table)
        self._ks.map(lambda p: remap_pay(p, table.to(p.dots.device)))

    def dump(self) -> list[tuple[bytes, object]]:
        """Decode every resident key (snapshots / bootstrap sync)."""
        if not self._rows:
            return []
        keys = sorted(self._rows)
        return list(zip(keys, self.read_many(keys)))


def _n_entries(d) -> int:
    """A delta's entry count; a wire delta's measured one (reading
    .entries would materialise it)."""
    n = getattr(d, "n_entries", None)
    return len(d.entries) if n is None else n


def _n_cloud(d) -> int:
    n = getattr(d, "n_cloud", None)
    return len(d.ctx.cloud) if n is None else n


def _pad_planes_np(batch: DocBatch, w: int, c: int) -> DocBatch:
    pad = _pad_of(batch.dots.dtype)
    k = batch.dots.shape[0]

    def padto(plane, width, fill):
        extra = width - plane.shape[-1]
        if extra <= 0:
            return plane
        return np.concatenate([plane, np.full((k, extra), fill, plane.dtype)], axis=-1)

    return DocBatch(padto(batch.dots, w, pad), padto(batch.pay, w, -1), batch.vv,
                    padto(batch.cloud, c, pad))
