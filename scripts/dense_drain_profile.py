#!/usr/bin/env python3
"""Times of the dense drains on an NVIDIA GPU, on this tree or an older one.

    python3 scripts/dense_drain_profile.py [--root DIR] [--smoke-phases]

Measures ``counter_drain_dense<1>``, ``counter_drain_dense<2>`` and
``treg_drain_dense`` of the ``jylis_tpu_torch`` package found under
``--root`` (default: this checkout), through whichever dense drain that
tree has:

* a tree with ``ops.staging.DensePlan`` (the staged compact batch): the
  kernel as ``drain_dense(plan, rows, *deltas, out)`` on the staged
  batch already on the card, and the call as the repos make it,
  ``parallel.drain_unrouted_*(keyspace, rows, fill, dense=True)``;
  beside them the sparse drain on the same batch (``sparse_*``: the
  sparse kernel on a table of the state, and the call with the sparse
  step), which joins the same rows but writes no output for the other
  rows;
* an older tree (whole planes): the kernel as ``drain_dense(state,
  *delta_planes)`` on K-long delta planes already on the card, and the
  call as its repos made it: a zero host plane per field with the
  batch's rows filled in, one pageable copy of each to the card, the
  kernel, and the K-long outputs copied back and indexed at the rows.

So one call to the card can hold a parent commit (a ``git archive``
unpacked into a gitignored directory) and this tree side by side; run
them in turns (parent, this, this, parent). The kernels build from that
tree's sources into its own ``build/``. The inputs come from this
checkout's ``chip_smoke.py`` generators with one seed, so both trees see
the same data. Shapes: the counters at the node's K = 131,072 x R = 16
with B = K / 4 and K, and at K = 1,048,576 x R = 64 with B = K / 4; TREG
at K = 1,048,576 with B = K / 4 and K (a third of the deltas tie their
row; every TREG call on a fresh copy of its state).

Prints the card's name and power limit, then one JSON line per shape:
``event_ms`` (the kernel's call on the CUDA-event clock, median of 7),
``device_ms`` (torch.profiler: every kernel of the call: the walk and
the scatter, or the clear and the slot pass), ``call_ms`` (host batch to
host results on the CUDA-event clock, median of 7) and
``launch_host_ms`` (the host time of one kernel call, 50 back to back). With ``--smoke-phases``, then the wall seconds of that
tree's ``chip_smoke.py`` kernel phases that hold the dense rows
(``counter_phases``, ``treg_phases`` and, where the tree has it,
``dense_call_cases``), each run once as the script runs it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def load_chip_smoke(root: Path = HERE, name: str = "chip_smoke_gen"):
    spec = importlib.util.spec_from_file_location(name, root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_names(root: Path, kernel: str, staged: bool) -> tuple:
    """The CUDA kernels one dense drain of ``kernel`` launches in the
    tree: the counters' walk and scatter (or the whole-plane kernel);
    TREG's slot pass and clear where its source has the clear, else its
    walk and scatter (or the whole-plane kernel)."""
    base = kernel.split("<")[0]
    if not staged:
        return (base,)
    if base == "treg_drain_dense" and "treg_dense_clear" in (
            root / "jylis_tpu_torch" / "csrc" / "treg_drain.cu").read_text():
        return (base, "treg_dense_clear")
    return (base, "scatter_slots")


def smoke_phases(torch, root: Path) -> dict:
    """Wall seconds of the tree's chip_smoke.py phases that hold the dense
    rows, each called as its main() calls it."""
    cs = load_chip_smoke(root, "chip_smoke_tree")
    card = cs.smi_line()
    out = {}
    t0 = time.perf_counter()
    cs.counter_phases(torch, card)
    out["counter_phases_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.treg_phases(torch, card)
    out["treg_phases_s"] = time.perf_counter() - t0
    if hasattr(cs, "dense_call_cases"):
        xfer = cs.transfer_phase(torch)
        t0 = time.perf_counter()
        cs.dense_call_cases(torch, card, xfer)
        out["dense_call_cases_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose jylis_tpu_torch is measured")
    ap.add_argument("--smoke-phases", action="store_true",
                    help="also time the tree's chip_smoke.py phases with the dense rows")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dense_drain_profile: no CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from jylis_tpu_torch import parallel as par
    from jylis_tpu_torch.ops import gcount, planes, pncount, staging, treg

    staged = hasattr(staging, "DensePlan")
    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 71)

    def emit(kernel, shape, kernel_call, call, reset=None, sparse=None):
        """One line; ``sparse`` = (kernel call, call, kernel name) of the
        sparse drain on the same batch."""
        names = kernel_names(root, kernel, staged)
        fresh = kernel_call if reset is None else (lambda: (reset(), kernel_call()))
        line = {
            "tree": str(root), "design": "staged" if staged else "whole planes",
            "kernel": kernel, "shape": shape,
            "event_ms": cs.time_ms(torch, kernel_call, reset=reset),
            "device_ms": cs.call_device_ms(torch, fresh, names)["total"],
            "call_ms": cs.time_ms(torch, call, reset=reset)}
        # the wrapper's host time a call, back to back
        line["launch_host_ms"] = cs.launch_host_ms(torch, kernel_call)
        if sparse is not None:
            s_kernel, s_call, s_name = sparse
            s_fresh = s_kernel if reset is None else (lambda: (reset(), s_kernel()))
            line.update(sparse_event_ms=cs.time_ms(torch, s_kernel, reset=reset),
                        sparse_device_ms=cs.call_device_ms(torch, s_fresh, (s_name,))["total"],
                        sparse_call_ms=cs.time_ms(torch, s_call, reset=reset))
        print(json.dumps(line), flush=True)

    for npl, mod, unrouted in ((1, gcount, par.drain_unrouted_g),
                               (2, pncount, par.drain_unrouted_pn)):
        name = f"counter_drain_dense<{npl}>"
        for k, r, batches in ((cs.K_NODE, cs.R_NODE, (cs.K_NODE // 4, cs.K_NODE)),
                              (cs.K_COUNTER, cs.R_COUNTER, (cs.K_COUNTER // 4,))):
            st_np = [cs.u64_np(rng, (k, r)) for _ in range(npl)]
            cls = mod.GCountState if npl == 1 else mod.PNCountState
            for b in batches:
                rows = cs.dense_rows_np(rng, k, b)
                d = [cs.u64_np(rng, (b, r)) for _ in range(npl)]
                state = cls(*(planes.to_tensor(x, dev) for x in st_np))
                if staged:
                    plan = staging.DensePlan(state)
                    ki = torch.from_numpy(rows).to(dev)
                    dt = [planes.to_tensor(x, dev) for x in d]
                    out = torch.empty(b, dtype=torch.int64, device=dev)
                    kernel_call = lambda plan=plan, ki=ki, dt=dt, out=out: (  # noqa: E731
                        mod.drain_dense(plan, ki, *dt, out))
                    ks = par.Keyspace(None, dev)
                    ks.place(cls(*(planes.to_tensor(x, dev) for x in st_np)))
                    fill = par.fill_from(*d)
                    call = lambda ks=ks, rows=rows.astype(np.int64), fill=fill: (  # noqa: E731
                        unrouted(ks, rows, fill, dense=True))
                    table = staging.ShardTable.of(state)
                    ks_s = par.Keyspace(None, dev)
                    ks_s.place(cls(*(planes.to_tensor(x, dev) for x in st_np)))
                    sparse = (lambda table=table, ki=ki, dt=dt, out=out: (  # noqa: E731
                                  mod.drain_sparse(table, ki, *dt, out)),
                              lambda ks=ks_s, rows=rows.astype(np.int64), fill=fill: (  # noqa: E731
                                  unrouted(ks, rows, fill)),
                              "counter_drain_sparse")
                else:
                    sparse = None
                    whole = []
                    for x in d:
                        plane = np.zeros((k, r), np.uint64)
                        plane[rows] = x
                        whole.append(planes.to_tensor(plane, dev))
                    kernel_call = lambda state=state, whole=whole: (  # noqa: E731
                        mod.drain_dense(state, *whole))
                    state2 = cls(*(planes.to_tensor(x, dev) for x in st_np))

                    def call(state2=state2, rows=rows, d=d, k=k, r=r):
                        dl = []
                        for x in d:
                            plane = np.zeros((k, r), np.uint64)
                            plane[rows] = x
                            dl.append(planes.to_tensor(plane, dev))
                        sums = mod.drain_dense(state2, *dl).cpu().numpy().view(np.uint64)
                        return sums[rows]
                emit(name, f"K={k} R={r} B={b}", kernel_call, call, sparse=sparse)
                del state
                torch.cuda.empty_cache()

    k = cs.K_TREG
    st_np = cs.treg_planes(rng, k)
    st0 = treg.TRegState(*cs.treg_tensors(torch, st_np, dev))
    for b in (k // 4, k):
        rows = cs.dense_rows_np(rng, k, b)
        d = cs.treg_deltas(rng, st_np, rows.astype(np.int64))
        sk = cs._clone(st0)
        if staged:
            plan = staging.DensePlan(sk)
            ki = torch.from_numpy(rows).to(dev)
            dt = cs.treg_tensors(torch, d, dev)
            out = (torch.empty(b, dtype=torch.bool, device=dev),
                   torch.empty(b, dtype=torch.int64, device=dev),
                   torch.empty(b, dtype=torch.int32, device=dev))
            kernel_call = lambda plan=plan, ki=ki, dt=dt, out=out: (  # noqa: E731
                treg.drain_dense(plan, ki, *dt, out))
            ks = par.Keyspace(None, dev)
            ks.place(cs._clone(st0))
            fill = par.fill_from(*d)
            call = lambda ks=ks, rows=rows.astype(np.int64), fill=fill: (  # noqa: E731
                par.drain_unrouted_treg(ks, rows, fill, dense=True))
            call_state = ks.parts[0]
            # the sparse drain of the same batch, on the same two states
            table = staging.ShardTable.of(sk)
            sparse = (lambda table=table, ki=ki, dt=dt, out=out: (  # noqa: E731
                          treg.drain_sparse(table, ki, *dt, out)),
                      lambda ks=ks, rows=rows.astype(np.int64), fill=fill: (  # noqa: E731
                          par.drain_unrouted_treg(ks, rows, fill)),
                      "treg_drain_sparse")
        else:
            sparse = None
            ts, rank = np.zeros(k, np.uint64), np.zeros(k, np.uint64)
            vid = np.full(k, -1, np.int32)
            ts[rows], rank[rows], vid[rows] = d
            whole = cs.treg_tensors(torch, (ts, rank, vid), dev)
            kernel_call = lambda sk=sk, whole=whole: treg.drain_dense(sk, *whole)  # noqa: E731
            call_state = cs._clone(st0)

            def call(st=call_state, rows=rows, d=d):
                ts, rank = np.zeros(k, np.uint64), np.zeros(k, np.uint64)
                vid = np.full(k, -1, np.int32)
                ts[rows], rank[rows], vid[rows] = d
                tie = treg.drain_dense(st, planes.to_tensor(ts, dev), planes.to_tensor(rank, dev),
                                       torch.from_numpy(vid).to(dev))
                return (tie.cpu().numpy()[rows], planes.to_u64_np(st.ts)[rows],
                        st.vid.cpu().numpy()[rows])
        reset_k = cs.restorer(sk, st0)
        reset_c = cs.restorer(call_state, st0)

        def reset(reset_k=reset_k, reset_c=reset_c):
            reset_k()
            reset_c()

        emit("treg_drain_dense", f"K={k} B={b}", kernel_call, call, reset=reset,
             sparse=sparse)
        del sk
        torch.cuda.empty_cache()
    if args.smoke_phases:
        print(json.dumps({"tree": str(root), "design": "staged" if staged else "whole planes",
                          **smoke_phases(torch, root)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
