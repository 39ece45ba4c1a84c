#!/usr/bin/env python3
"""Per-launch device times of the port's row kernels on an NVIDIA GPU.

    python3 scripts/row_kernel_profile.py [--root DIR] [--flat] [--long] [--smoke-phases]
                                          [--sweep [flat|tlog|join ...]]

Measures the ``jylis_tpu_torch`` package found under ``--root`` (default:
this checkout), so one call can hold two trees side by side, e.g. a
``git archive`` of a parent commit unpacked into a gitignored directory
and the working tree. The kernels build from that tree's sources into
its own ``build/``. The inputs come from this checkout's
``chip_smoke.py`` (the same generators and seeds as its kernel phases),
which only calls the package's public functions.

Prints one JSON line per measurement:

* ``tree``: the fold tree of BASELINE config 5b (K = 64 keys x D = 512
  deltas) and of config 5 (D = 16,384), narrow and wide: every
  ``ujson_join`` launch of the fold, in order, with its row count and
  widths, its device time (torch.profiler, CUPTI; the mean of 3 traced
  folds) and, where the tree has ``ujson_device.join_plan``, the class
  the launch took;
* with ``--long``: the rows past shared memory on any tree (a parent's
  too): config 5's broadcast join (64 resident rows, one folded row
  65,536 wide), narrow and wide, and ``tlog_drain_sparse`` at K = 4,
  L = Ld = 65,536, wide (``chip_smoke.py``'s shape and generators), each
  launch's device time (torch.profiler), and the TLOG row's plain
  twin's time on the card (CUDA events, median of 5);
* with ``--smoke-phases``: the wall seconds of that tree's own
  ``chip_smoke.py`` TLOG and UJSON kernel phases (``tlog_phases``,
  ``ujson_phases``), each run once as its main() runs it; beside the
  seconds of the tree's first build of every kernel (``build_s``), what
  the row kernels add to the script's time;
* with ``--flat``: ``ujson_fold_flat`` at ``chip_smoke.py``'s
  class-boundary shapes on the planes it draws there: each class forced
  in turn as ``--sweep flat`` does, or, on a tree without classes (a
  parent), a launch's device time;
* with ``--sweep`` (trees that have ``ops/row_plan.py``): the warp and
  CTA classes of ``tlog_drain`` and ``ujson_join`` forced in turn at
  widths around their crossovers, each launch's device time, and the two
  classes' outputs compared bit for bit; then, on trees whose plans have
  the cluster class (``row_plan.plan_split``), rows around and past a
  CTA's shared memory in the CTA class (where it fits) and in clusters of
  2, 4, 8 and 16 CTAs (each size whose share fits), every output held
  against the first; ``--sweep flat`` (or ``tlog``,
  ``join``) sweeps only that kernel. The flat fold's sweep (trees that
  have ``ujson_resident.flat_plan``) forces each of its three classes (a
  warp per key, its deltas in registers; a CTA, its rows in shared
  memory; a cluster of CTAs reading device memory) at key counts and
  widths around its crossovers.

The card's name and power limit come first, as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
SEED = 20261017


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_gen", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_times(torch, fn, name: str, runs: int = 3) -> list[float]:
    """Device microseconds of each launch of kernels whose name holds
    ``name`` during one call of ``fn``, in launch order, averaged over
    ``runs`` traced calls (torch.profiler's chrome trace)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_run = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        for _ in range(runs):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            ks = sorted((e["ts"], e["dur"]) for e in events
                        if e.get("cat") == "kernel" and name in e.get("name", ""))
            per_run.append([d for _, d in ks])
    n = min(len(r) for r in per_run)
    return [statistics.mean(r[i] for r in per_run) for i in range(n)]


def tree_profile(torch, cs, udev) -> None:
    has_plan = hasattr(udev, "join_plan")
    for config in ("5b", "5"):
        for wide in (False, True):
            if config == "5b":
                store, _, _, grid = cs.uj_5b_setup(wide)
            else:
                store, _, grid = cs.uj_5_setup(wide)
            shift = store._shift
            levels = []

            def record(a, b, s):
                n, la = a.dots.shape
                lb, ca, cb, r = b.dots.shape[1], a.cloud.shape[1], b.cloud.shape[1], a.vv.shape[1]
                lv = dict(rows=n, la=la, lb=lb, ca=ca, cb=cb, r=r)
                if hasattr(udev, "plan_join"):
                    plan = udev.plan_join(n, a.dots.element_size(), la, lb, ca, cb, r)
                    lv["class"] = plan.kind + (f" of {plan.cluster}"
                                               if plan.kind == "cluster" else "")
                elif has_plan:
                    wb = udev.join_work_bytes(a.dots.element_size(), la, lb, ca, cb, r)
                    lv["class"] = udev.join_plan(n, wb).kind
                levels.append(lv)
                return udev.join_rows(a, b, s)

            udev._fold_body(grid, shift, record)
            us = kernel_times(torch, lambda: udev._fold_body(grid, shift), "ujson_join")
            for lv, t in zip(levels, us):
                lv["device_us"] = t
            emit({"tree": config, "layout": "wide" if wide else "narrow",
                  "launches": len(us), "device_us_total": sum(us), "levels": levels})
            del store, grid
            torch.cuda.empty_cache()


def _clone(st):
    return type(st)(*(None if x is None else x.clone() for x in st))


def _same(x, y) -> bool:
    import torch

    return all(torch.equal(a, b) for a, b in zip(x, y))


def _forced(mod, warp: bool) -> dict:
    """Make ``mod``'s plan take the warp class wherever the kernel has
    one, or never; returns the crossovers to put back."""
    old = {k: getattr(mod, k) for k in ("WARP_ROW_BYTES", "WARP_MIN_ROWS")
           if hasattr(mod, k)}
    mod.WARP_ROW_BYTES = (1 << 40) if warp else 0
    if "WARP_MIN_ROWS" in old:
        mod.WARP_MIN_ROWS = 1
    return old


def tlog_sweep(torch, cs, tlog, planes) -> None:
    """tlog_drain_sparse, every slot live, rows filled to half of L."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 90)
    shapes = [(4096, L, 128) for L in (256, 512, 1024, 2048, 4096, 8192)]
    shapes += [(4096, 1024, ld) for ld in (1, 32, 256)]
    shapes += [(k, 1024, 128) for k in (128, 512, 2048)] + [(16, 1024, 1), (16, 1024, 128)]
    for k, length, ld in shapes:
        for wide in (False, True):
            lens = rng.integers(0, length // 2 + 1, k)
            pl, lens32, cut, ts, vid = cs.tlog_rows_np(rng, k, length, lens, wide)
            rows = rng.permutation(k).astype(np.int32)
            d_ts, d_vid, d_cut = cs.tlog_delta_np(rng, ts, vid, lens, rows.astype(np.int64), ld)
            counts = cs.tlog_counts_np(rng, k)
            st0 = tlog.TLogState(
                *([] if wide else [None]),
                *(torch.from_numpy(p.view(np.int32)).to(dev) for p in pl),
                torch.from_numpy(lens32).to(dev), planes.to_tensor(cut, dev))
            args = (torch.from_numpy(rows).to(dev), planes.to_tensor(d_ts, dev),
                    torch.from_numpy(d_vid).to(dev), planes.to_tensor(d_cut, dev),
                    torch.from_numpy(counts).to(dev))
            out, res = {}, {}
            for warp in (True, False):
                old = _forced(tlog, warp)
                try:
                    plan = tlog.drain_plan(k, length, ld, 3 if wide else 2)
                    st = _clone(st0)
                    o = tlog.drain_sparse(st, *args)
                    torch.cuda.synchronize()
                    res[plan.rows.kind] = [*o, *cs._tensors(st)]
                    sk = _clone(st0)
                    reset = cs.restorer(cs._tensors(sk), cs._tensors(st0))
                    t = kernel_times(torch, lambda: (reset(), tlog.drain_sparse(sk, *args)),
                                     "tlog_drain")
                    out[plan.rows.kind] = dict(device_us=t[0] if t else None,
                                               rows_per_cta=plan.rows.rows_per_cta,
                                               smem=plan.rows.smem)
                finally:
                    for name, v in old.items():
                        setattr(tlog, name, v)
            same = (len(res) == 2 and all(torch.equal(a, b) for a, b in zip(*res.values())))
            emit({"sweep": "tlog_drain_sparse", "K": k, "L": length, "Ld": ld,
                  "layout": "wide" if wide else "narrow", "classes": out,
                  "classes_equal": same if len(res) == 2 else None})
            del st0, args, res
            torch.cuda.empty_cache()


def ujson_sweep(torch, cs, udev) -> None:
    """ujson_join of random rows (sorted output), a rows and b rows of
    the same widths."""
    rng = np.random.default_rng(SEED + 91)
    for n, width in ((16384, 4), (8192, 16), (4096, 64), (2048, 256), (1024, 512),
                     (512, 1024), (256, 2048), (128, 64), (256, 64), (512, 64),
                     (1024, 64), (128, 128), (256, 128), (512, 128), (1024, 128)):
        for wide in (False, True):
            shift = 32 if wide else 28
            a = cs.uj_random_planes(torch, rng, (n,), width, width, 8, shift)
            b = cs.uj_random_planes(torch, rng, (n,), width, width, 8, shift)
            out, res = {}, {}
            wb = udev.join_work_bytes(a.dots.element_size(), width, width, width, width, 8)
            for warp in (True, False):
                old = _forced(udev, warp)
                try:
                    plan = udev.join_plan(n, wb)
                    res[plan.kind] = udev.join_rows(a, b, shift)
                    torch.cuda.synchronize()
                    t = kernel_times(torch, lambda: udev.join_rows(a, b, shift), "ujson_join")
                    out[plan.kind] = dict(device_us=t[0] if t else None,
                                          rows_per_cta=plan.rows_per_cta, smem=plan.smem)
                finally:
                    for name, v in old.items():
                        setattr(udev, name, v)
            same = (len(res) == 2 and all(torch.equal(x, y) for x, y in zip(*res.values())))
            emit({"sweep": "ujson_join", "rows": n, "width": width, "work_bytes": wb,
                  "layout": "wide" if wide else "narrow", "classes": out,
                  "classes_equal": same if len(res) == 2 else None})
            del a, b, res
            torch.cuda.empty_cache()


def long_rows(torch, cs, udev, tlog, planes) -> None:
    """The rows past shared memory, on any tree: config 5's broadcast
    join and the K = 4, L = Ld = 65,536 TLOG drain, device time a launch;
    the TLOG row's plain twin on the card."""
    from jylis_tpu_torch.ops import ujson_resident as ures

    for wide in (False, True):
        st5, deltas, g5 = cs.uj_5_setup(wide)
        shift = st5._shift
        folded = udev.DocBatch(*(p[:, 0] for p in udev._fold_body(g5, shift)))
        out_w, out_c = st5._budget_widths(sum(len(x.entries) for x in deltas),
                                          sum(len(x.ctx.cloud) for x in deltas))
        occ = torch.zeros(st5._row_axis(), dtype=torch.bool, device="cuda")
        occ[list(st5._rows.values())] = True
        r0 = cs.uj_clone(st5._batch)
        rk = cs.uj_clone(r0)
        reset = cs.restorer(rk, r0)

        def run():
            reset()
            udev.join_rows(rk, folded, shift, finish=(out_w, out_c), occupied=occ,
                           out=ures.slice_widths(rk, out_w, out_c))

        t = kernel_times(torch, run, "ujson_join", runs=5)
        emit({"long": "config 5 broadcast", "layout": "wide" if wide else "narrow",
              "rows": r0.dots.shape[0], "lb": folded.dots.shape[-1],
              "device_us": t[-1] if t else None})
        del st5, g5, folded, r0, rk
        torch.cuda.empty_cache()
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 20)
    k, length, ld = 4, 1 << 16, 1 << 16
    lens = np.zeros(k, np.int64)
    lens[:3] = rng.integers(0, 901, 3)
    pl, lens32, cut, ts, vid = cs.tlog_rows_np(rng, k, length, lens, True)
    st0 = tlog.TLogState(*(torch.from_numpy(p.view(np.int32)).to(dev) for p in pl),
                         torch.from_numpy(lens32).to(dev), planes.to_tensor(cut, dev))
    rows = np.arange(3)
    d_ts, d_vid, d_cut = cs.tlog_delta_np(rng, ts, vid, lens, rows, ld)
    ki = torch.tensor([0, 1, 2, 2**31 - 1], dtype=torch.int32, device=dev)
    z = np.zeros((1, ld), np.uint64)
    args = (ki, planes.to_tensor(np.concatenate([d_ts, z]), dev),
            torch.from_numpy(np.concatenate([d_vid, np.full((1, ld), -1)])).to(dev),
            planes.to_tensor(np.concatenate([d_cut, z[:, 0]]), dev),
            torch.from_numpy(np.r_[cs.tlog_counts_np(rng, 3), tlog.TRIM_NOOP]).to(dev))
    sk = _clone(st0)
    reset = cs.restorer(cs._tensors(sk), cs._tensors(st0))
    t = kernel_times(torch, lambda: (reset(), tlog.drain_sparse(sk, *args)), "tlog_drain",
                     runs=5)
    sp = _clone(st0)
    reset_p = cs.restorer(cs._tensors(sp), cs._tensors(st0))
    plain = []
    for _ in range(5):
        reset_p()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        tlog.drain_sparse_plain(sp, *args)
        e1.record()
        torch.cuda.synchronize()
        plain.append(e0.elapsed_time(e1))
    same = all(torch.equal(x, y) for x, y in zip(cs._tensors(sk), cs._tensors(sp)))
    emit({"long": "tlog_drain_sparse K=4 L=Ld=65536 wide", "device_us": t[0] if t else None,
          "plain_ms": statistics.median(plain), "equal_to_plain": same})


def _split_classes(torch, row_plan, mod, run, equal, name: str) -> dict:
    """``run()`` (a launch of ``mod``'s wrapper, returning its outputs)
    in the CTA class where the row fits it, then in clusters of 2, 4, 8
    and 16 CTAs (each size whose share fits shared memory): device time
    a launch, and whether each class's outputs equal the first's."""
    out, first = {}, None
    orig = row_plan.plan_split
    old = (mod.WARP_ROW_BYTES, mod.CTA_ROW_BYTES)
    mod.WARP_ROW_BYTES = 0
    try:
        for klass in ("cta", 2, 4, 8, 16):
            if klass == "cta":
                mod.CTA_ROW_BYTES = row_plan.SMEM_LIMIT
            else:
                mod.CTA_ROW_BYTES = 0

                def split(nrows, share, n=klass):
                    if share(n) > row_plan.SMEM_LIMIT:
                        return orig(nrows, share)
                    return row_plan.RowPlan("cluster", 1, row_plan.CTA_THREADS, share(n),
                                            nrows * n, 0, share(n), n)

                row_plan.plan_split = split
            got, plan = run()
            torch.cuda.synchronize()
            label = plan.kind if plan.kind != "cluster" else f"cluster of {plan.cluster}"
            if label in out or (klass == "cta" and plan.kind != "cta") or (
                    klass != "cta" and plan.cluster != klass):
                continue
            t = kernel_times(torch, lambda: run(), name)
            first = got if first is None else first
            out[label] = dict(device_us=t[0] if t else None, smem=plan.smem,
                              scratch=plan.scratch, equal=equal(first, got))
    finally:
        row_plan.plan_split = orig
        mod.WARP_ROW_BYTES, mod.CTA_ROW_BYTES = old
    return out


def tlog_split_sweep(torch, cs, tlog, planes) -> None:
    """tlog_drain_sparse around and past a CTA's shared memory: every
    class that takes the row (_split_classes), rows filled to half of L
    and deltas as chip_smoke.py draws them."""
    from jylis_tpu_torch.ops import row_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 93)
    for k, length, ld in ((64, 8192, 1024), (16, 16384, 1024), (8, 24576, 1024),
                          (4, 65536, 1024), (4, 32768, 32768), (4, 65536, 65536),
                          (1, 65536, 65536)):
        for wide in (False, True):
            lens = rng.integers(0, min(900, length // 2) + 1, k)
            pl, lens32, cut, ts, vid = cs.tlog_rows_np(rng, k, length, lens, wide)
            rows = rng.permutation(k).astype(np.int32)
            d_ts, d_vid, d_cut = cs.tlog_delta_np(rng, ts, vid, lens, rows.astype(np.int64), ld)
            st0 = tlog.TLogState(
                *([] if wide else [None]),
                *(torch.from_numpy(p.view(np.int32)).to(dev) for p in pl),
                torch.from_numpy(lens32).to(dev), planes.to_tensor(cut, dev))
            args = (torch.from_numpy(rows).to(dev), planes.to_tensor(d_ts, dev),
                    torch.from_numpy(d_vid).to(dev), planes.to_tensor(d_cut, dev),
                    torch.from_numpy(cs.tlog_counts_np(rng, k)).to(dev))
            sk = _clone(st0)
            reset = cs.restorer(cs._tensors(sk), cs._tensors(st0))

            def run():
                reset()
                o = tlog.drain_sparse(sk, *args)
                return [*o, *cs._tensors(sk)], tlog.drain_plan(
                    k, length, ld, 3 if wide else 2).rows

            out = _split_classes(torch, row_plan, tlog, run, _same, "tlog_drain")
            emit({"sweep": "tlog_drain_sparse split", "K": k, "L": length, "Ld": ld,
                  "layout": "wide" if wide else "narrow", "classes": out,
                  "plan": cs.row_class(tlog.drain_plan(k, length, ld, 3 if wide else 2).rows)})
            del st0, sk, args
            torch.cuda.empty_cache()


def ujson_split_sweep(torch, cs, udev) -> None:
    """ujson_join of random rows around and past a CTA's shared memory
    (sorted output; a and b rows of the same widths, R = 32), and config
    5's broadcast: every class that takes the row (_split_classes)."""
    from jylis_tpu_torch.ops import row_plan
    from jylis_tpu_torch.ops import ujson_resident as ures

    rng = np.random.default_rng(SEED + 94)
    for n, width in ((64, 2048), (16, 4096), (8, 8192), (4, 16384), (2, 32768)):
        for wide in (False, True):
            shift = 32 if wide else udev.narrow_shift(32)
            a = cs.uj_random_planes(torch, rng, (n,), width, width, 32, shift)
            b = cs.uj_random_planes(torch, rng, (n,), width, width, 32, shift)
            ts = a.dots.element_size()

            def run():
                return udev.join_rows(a, b, shift), udev.plan_join(
                    n, ts, width, width, width, width, 32)

            out = _split_classes(torch, row_plan, udev, run, _same, "ujson_join")
            emit({"sweep": "ujson_join split", "rows": n, "width": width,
                  "layout": "wide" if wide else "narrow", "classes": out,
                  "plan": cs.uj_join_class(a, b)})
            del a, b
            torch.cuda.empty_cache()
    for wide in (False, True):
        st5, deltas, g5 = cs.uj_5_setup(wide)
        shift = st5._shift
        folded = udev.DocBatch(*(p[:, 0] for p in udev._fold_body(g5, shift)))
        out_w, out_c = st5._budget_widths(sum(len(x.entries) for x in deltas),
                                          sum(len(x.ctx.cloud) for x in deltas))
        occ = torch.zeros(st5._row_axis(), dtype=torch.bool, device="cuda")
        occ[list(st5._rows.values())] = True
        r0 = cs.uj_clone(st5._batch)
        rk = cs.uj_clone(r0)
        reset = cs.restorer(rk, r0)

        def run():
            reset()
            o = udev.join_rows(rk, folded, shift, finish=(out_w, out_c), occupied=occ,
                               out=ures.slice_widths(rk, out_w, out_c))
            return cs.uj_clone(o), udev.plan_join(
                r0.dots.shape[0], r0.dots.element_size(), r0.dots.shape[-1],
                folded.dots.shape[-1], r0.cloud.shape[-1], folded.cloud.shape[-1],
                r0.vv.shape[-1])

        out = _split_classes(torch, row_plan, udev, run, _same, "ujson_join")
        emit({"sweep": "ujson_join split", "rows": r0.dots.shape[0],
              "width": folded.dots.shape[-1], "data": "config 5 broadcast",
              "layout": "wide" if wide else "narrow", "classes": out,
              "plan": cs.uj_join_class(r0, folded)})
        del st5, g5, folded, r0, rk
        torch.cuda.empty_cache()


def smoke_phases(torch, root: Path) -> dict:
    """Wall seconds of the tree's chip_smoke.py TLOG and UJSON kernel
    phases, each called as its main() calls it."""
    spec = importlib.util.spec_from_file_location("chip_smoke_tree", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = cs.smi_line()
    t0 = time.perf_counter()
    cs.tlog_phases(torch, card)
    out = {"tlog_phases_s": time.perf_counter() - t0}
    flat = cs.uj_flat_data(cs.UJ_FLAT_KEYS)
    t0 = time.perf_counter()
    cs.ujson_phases(torch, card, flat[1])
    out["ujson_phases_s"] = time.perf_counter() - t0
    return out


FLAT_CLASSES = ("warp", "cta", "cluster")


def flat_boundaries(torch, cs, ures) -> None:
    """ujson_fold_flat at chip_smoke.py's class-boundary shapes
    (cs.UJ_FLAT_BOUNDARIES), narrow then wide, on the planes its UJSON
    kernel phase draws there (the same generator and seed): on a tree
    with ``ujson_resident.FLAT_CLASS``, each class that can take the
    shape forced in turn (``_flat_classes``); on any other tree whose
    ``fold_flat`` takes a (K, D, W) grid (a parent), a launch's device
    time, so both are timed on the same planes."""
    from jylis_tpu_torch.ops import ujson_device as udev

    brng = np.random.default_rng(cs.SEED + 31)
    for wide in (False, True):
        layout = "wide" if wide else "narrow"
        for k, d, w, c, r in cs.UJ_FLAT_BOUNDARIES[8 if wide else 4]:
            shift = 32 if wide else udev.narrow_shift(r)
            g = cs.uj_random_planes(torch, brng, (k, d), w, c, r, shift,
                                    empty=range(0, k * d, 5), wrap=True)
            if hasattr(ures, "FLAT_CLASS"):
                _flat_classes(torch, ures, g, shift, "chip_smoke.py boundary", layout)
            else:
                t = kernel_times(torch, lambda: ures.fold_flat(g, shift), "ujson_fold_flat")
                emit({"flat": "boundary", "keys": k, "d": d, "w": w, "c": c, "r": r,
                      "layout": layout, "device_us": t[0] if t else None})
            del g
            torch.cuda.empty_cache()


def flat_sweep(torch, cs, ures) -> None:
    """ujson_fold_flat, each class that can take the shape forced in
    turn: the flat leg's own deltas (chip_smoke.py's node phase, its
    first 64, 512 and 4,096 keys), then random delta stacks
    (cs.uj_random_planes): the flat leg's key (D = 64 x W = 4, C = 4,
    R = 32) at launches of 64-4,096 keys, wider keys at 4,096, 128, 64
    and 16, and few keys of 512-4,096 dots a delta."""
    from jylis_tpu_torch.ops import ujson_device as udev

    # the flat leg's own deltas (chip_smoke.py's node phase), its first K keys
    flat = cs.uj_flat_data(4096)[1]
    for wide in (False, True):
        st = ures.ResidentStore(n_rep=32, device="cuda")
        st._grow_reps_to(32)
        if wide:
            st._widen()
        grid = st._grid_to_device(st._encode_grid(flat))
        for k in (64, 512, 4096):
            g = type(grid)(*(p[:k].contiguous() for p in grid))
            _flat_classes(torch, ures, g, st._shift, f"flat leg, first {k} keys",
                          "wide" if wide else "narrow")
        del st, grid, g
        torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 92)
    shapes = [(k, 64, 4, 4, 32) for k in (64, 128, 512, 1024, 4096)]
    shapes += [(4096, 64, w, w, 8) for w in (8, 12, 16, 64)]
    shapes += [(k, 64, w, w, 8) for k in (16, 64, 128) for w in (16, 32, 64, 256)]
    shapes += [(2, 64, 512, 64, 8), (16, 64, 512, 64, 8), (2, 64, 4096, 64, 8)]
    for k, d, w, c, r in shapes:
        for wide in (False, True):
            shift = 32 if wide else udev.narrow_shift(r)
            g = cs.uj_random_planes(torch, rng, (k, d), w, c, r, shift, empty=range(0, k * d, 5))
            _flat_classes(torch, ures, g, shift, "random planes", "wide" if wide else "narrow")
            del g
            torch.cuda.empty_cache()


def _flat_classes(torch, ures, g, shift: int, data: str, layout: str) -> None:
    """One flat-fold grid in each class that can take it: device time a
    launch, the plan, and the classes' outputs compared bit for bit."""
    k, d, w = g.dots.shape
    c, r = g.cloud.shape[-1], g.vv.shape[-1]
    out, res = {}, {}
    for klass in FLAT_CLASSES:
        ures.FLAT_CLASS = klass
        try:
            plan = ures.flat_plan(k, g.dots.element_size(), d, w, c, r)
            if plan.kind != klass:
                continue
            res[klass] = ures.fold_flat(g, shift)
            torch.cuda.synchronize()
            t = kernel_times(torch, lambda: ures.fold_flat(g, shift), "ujson_fold_flat")
            out[klass] = dict(device_us=t[0] if t else None, smem=plan.smem,
                              keys_per_cta=plan.rows_per_cta, cluster=plan.cluster,
                              grid=plan.grid)
        finally:
            ures.FLAT_CLASS = None
    outs = list(res.values())
    same = all(torch.equal(x, y) for o in outs[1:] for x, y in zip(outs[0], o))
    emit({"sweep": "ujson_fold_flat", "data": data, "keys": k, "d": d, "w": w, "c": c,
          "r": r, "work_bytes": ures.flat_work_bytes(g.dots.element_size(), d, w, c, r),
          "layout": layout, "plan": ures.flat_plan(k, g.dots.element_size(), d, w, c, r).kind,
          "classes": out, "classes_equal": same})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose jylis_tpu_torch package is measured")
    ap.add_argument("--sweep", nargs="*", choices=("flat", "tlog", "join"),
                    help="also force each class of the row kernels (or of the ones "
                         "named) around its crossover")
    ap.add_argument("--flat", action="store_true",
                    help="also time ujson_fold_flat at chip_smoke.py's class-boundary shapes")
    ap.add_argument("--long", action="store_true",
                    help="also time the rows past shared memory (any tree)")
    ap.add_argument("--smoke-phases", action="store_true",
                    help="also time the tree's chip_smoke.py TLOG and UJSON kernel phases")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("row_kernel_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    cs = load_chip_smoke()
    from jylis_tpu_torch.ops import _build, planes, tlog
    from jylis_tpu_torch.ops import ujson_device as udev

    emit({"card": cs.smi_line(), "root": str(Path(args.root).resolve()),
          "package": str(Path(udev.__file__).resolve().parents[1]),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    from jylis_tpu_torch.ops import ujson_resident as ures

    t0 = time.perf_counter()
    _build.build()
    emit({"build_s": time.perf_counter() - t0})
    if args.smoke_phases:
        emit({"smoke_phases": str(Path(args.root).resolve()),
              **smoke_phases(torch, Path(args.root).resolve())})
    tree_profile(torch, cs, udev)
    if args.long:
        long_rows(torch, cs, udev, tlog, planes)
    if args.flat:
        flat_boundaries(torch, cs, ures)
    if args.sweep is not None:
        which = set(args.sweep or ("flat", "tlog", "join"))
        if not hasattr(udev, "join_plan"):
            raise SystemExit("--sweep needs a tree with ops/row_plan.py")
        split = hasattr(udev, "plan_join")
        if "tlog" in which:
            tlog_sweep(torch, cs, tlog, planes)
            if split:
                tlog_split_sweep(torch, cs, tlog, planes)
        if "join" in which:
            ujson_sweep(torch, cs, udev)
            if split:
                ujson_split_sweep(torch, cs, udev)
        if "flat" in which:
            if not hasattr(ures, "flat_plan"):
                raise SystemExit("--sweep flat needs a tree with ujson_resident.flat_plan")
            flat_sweep(torch, cs, ures)
    return 0


if __name__ == "__main__":
    sys.exit(main())
