#!/usr/bin/env python3
"""Per-launch device times of the port's row kernels on an NVIDIA GPU.

    python3 scripts/row_kernel_profile.py [--root DIR] [--flat] [--sweep [flat|tlog|join ...]]

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
* with ``--flat``: ``ujson_fold_flat`` at ``chip_smoke.py``'s
  class-boundary shapes on the planes it draws there: each class forced
  in turn as ``--sweep flat`` does, or, on a tree without classes (a
  parent), a launch's device time;
* with ``--sweep`` (trees that have ``ops/row_plan.py``): the warp and
  CTA classes of ``tlog_drain`` and ``ujson_join`` forced in turn at
  widths around their crossovers, each launch's device time, and the two
  classes' outputs compared bit for bit; ``--sweep flat`` (or ``tlog``,
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
                if has_plan:
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

    emit({"build_s": _build.build(("tlog_drain", "ujson_join", "ujson_fold_flat"))})
    tree_profile(torch, cs, udev)
    if args.flat:
        flat_boundaries(torch, cs, ures)
    if args.sweep is not None:
        which = set(args.sweep or ("flat", "tlog", "join"))
        if not hasattr(udev, "join_plan"):
            raise SystemExit("--sweep needs a tree with ops/row_plan.py")
        if "tlog" in which:
            tlog_sweep(torch, cs, tlog, planes)
        if "join" in which:
            ujson_sweep(torch, cs, udev)
        if "flat" in which:
            if not hasattr(ures, "flat_plan"):
                raise SystemExit("--sweep flat needs a tree with ujson_resident.flat_plan")
            flat_sweep(torch, cs, ures)
    return 0


if __name__ == "__main__":
    sys.exit(main())
