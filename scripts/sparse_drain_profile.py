#!/usr/bin/env python3
"""Per-launch times of the sparse drain kernels on an NVIDIA GPU.

    python3 scripts/sparse_drain_profile.py [--root DIR]

Measures ``counter_drain_sparse<1>``, ``counter_drain_sparse<2>`` and
``treg_drain_sparse`` of the ``jylis_tpu_torch`` package found under
``--root`` (default: this checkout), through the call every tree of the
port has: ``drain_sparse(state, key_idx, *deltas)`` with the rows padded
to a power of two as the repos padded them before the staged call. One
call can so hold a parent commit (a ``git archive`` unpacked into a
gitignored directory) and this tree side by side; run them in turns
(parent, this, this, parent). The kernels build from that tree's sources
into its own ``build/``. The inputs come from this checkout's
``chip_smoke.py`` generators and seeds.

Shapes: the counters at the node phase's K = 131,072 x R = 16 with
B = 512 (400 live) and at K = 1,048,576 x R = 64 with B = 1,024 (960
live) and 65,536 (61,440 live); TREG at K = 1,048,576 with B = 8,192
(5,000 live) and 65,536 (61,440 live), a third of the deltas tying
their row, each TREG launch on a fresh copy of the state.

Prints the card's name and power limit, then one JSON line per shape:
``device_ms`` (torch.profiler, the mean over 5 traced launches),
``event_ms`` (CUDA events, the median of 7 runs of 20 launches).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_gen", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose jylis_tpu_torch is measured")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sparse_drain_profile: no CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from jylis_tpu_torch.ops import gcount, planes, pncount, treg
    from jylis_tpu_torch.utils.batching import pad_rows

    print(cs.smi_line(), flush=True)
    tree = str(Path(args.root).resolve())
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 70)

    def emit(kernel, shape, fn, reset=None):
        call = fn if reset is None else (lambda: (reset(), fn()))
        print(json.dumps({
            "tree": tree, "kernel": kernel, "shape": shape,
            "device_ms": cs.device_ms(torch, call, kernel.split("<")[0]),
            "event_ms": cs.time_ms(torch, fn, reps=20) if reset is None
            else cs.time_ms(torch, fn, reset=reset)}), flush=True)

    for npl, mod in ((1, gcount), (2, pncount)):
        name = f"counter_drain_sparse<{npl}>"
        for k, r, cases in ((cs.K_NODE, cs.R_NODE, ((cs.B_NODE, cs.NODE_MORE),)),
                            (cs.K_COUNTER, cs.R_COUNTER,
                             ((cs.B_ENTRY, cs.B_ENTRY - cs.B_ENTRY // 16),
                              (cs.B_LARGE, cs.B_LARGE - cs.B_LARGE // 16)))):
            st = (mod.GCountState if npl == 1 else mod.PNCountState)(
                *(planes.to_tensor(cs.u64_np(rng, (k, r)), dev) for _ in range(npl)))
            for b, live in cases:
                ki = pad_rows(b)
                ki[:live] = rng.choice(k, size=live, replace=False)
                ki = torch.from_numpy(ki).to(dev)
                dl = [planes.to_tensor(cs.u64_np(rng, (b, r)), dev) for _ in range(npl)]
                emit(name, f"K={k} R={r} B={b} live={live}",
                     lambda st=st, ki=ki, dl=dl: mod.drain_sparse(st, ki, *dl))
            del st
            torch.cuda.empty_cache()

    st_np = cs.treg_planes(rng, cs.K_TREG)
    st0 = treg.TRegState(*cs.treg_tensors(torch, st_np, dev))
    st = treg.TRegState(*(x.clone() for x in st0))
    for b, live in ((cs.B_TREG_NODE, cs.TREG_NEW), (cs.B_LARGE, cs.B_LARGE - cs.B_LARGE // 16)):
        ki = pad_rows(b)
        ki[:live] = rng.choice(cs.K_TREG, size=live, replace=False)
        rows = np.where(np.arange(b) < live, ki, 0)
        d = cs.treg_tensors(torch, cs.treg_deltas(rng, st_np, rows), dev)
        ki = torch.from_numpy(ki).to(dev)
        emit("treg_drain_sparse", f"K={cs.K_TREG} B={b} live={live}",
             lambda ki=ki, d=d: treg.drain_sparse(st, ki, *d), reset=cs.restorer(st, st0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
