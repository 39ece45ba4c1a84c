"""The lower-precision control: the reference put in the program's place,
computed in the next narrower type than the configuration states (u64
counters as u32, u64 timestamps as u32), and judged by the same
comparison as a run (judge.py). It has to come out not correct.

``python -m cardbench.control --workload <cell> --seeds a,b,c --frames N``
runs it at the cell's own keyspace over the traffic of a run that sent
``N`` frames a peer past the fill, and prints each seed's numbers with
their limits. A run of the benchmark never runs it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from . import judge
from .run import TREG_GET_SAMPLE, load_cell
from .traffic import gen


def control_state(cfg: dict, narrow) -> dict:
    """What the node would give back, from the narrow reference."""
    if cfg["type"] == "PNCOUNT":
        return {"gets": (narrow.values().astype(np.int64), 0)}
    sample = np.arange(0, cfg["keys"], max(1, cfg["keys"] // TREG_GET_SAMPLE))
    ts = narrow.ts.astype(np.uint64)
    return {"device": (narrow.set, ts, narrow.value),
            "gets": (ts[sample], narrow.value[sample], 0), "sample": sample}


def run_control(cell: dict, seed: int, frames_past_fill: int) -> dict:
    cfg, traffic = cell["config"], cell["traffic"]
    n_fill = [s.n_fill for s in gen.streams(cfg, traffic, seed)]
    frames = [f + frames_past_fill for f in n_fill]
    ref = judge.reference(cfg, traffic, seed, frames)
    narrow = judge.reference(cfg, traffic, seed, frames, narrow=True)
    sound = judge.compare(cfg, ref, control_state(cfg, ref), None)
    checks = judge.compare(cfg, ref, control_state(cfg, narrow), None)
    return {"seed": seed, "frames": frames,
            "reference_correct": all(c["value"] <= c["limit"] for c in sound.values()),
            "control_correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "checks": checks}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m cardbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, **run_control(cell, seed, args.frames)}),
              flush=True)


if __name__ == "__main__":
    main()
