"""The lower-precision control: the reference put in the program's place,
computed in the next narrower type than the configuration states (the
type module's ``NARROW``, types/<type>.py), and judged by the same
comparison as a run (judge.py). It has to come out not correct.

``python -m cardbench.control --workload <cell> --seeds a,b,c --frames N``
runs it at the cell's own keyspace over the traffic of a run that sent
``N`` frames a peer past the fill, and prints each seed's numbers with
their limits. A run of the benchmark never runs it.
"""

from __future__ import annotations

import argparse
import json

from . import judge, types
from .run import load_cell
from .traffic import gen


def run_control(cell: dict, seed: int, frames_past_fill: int) -> dict:
    cfg, traffic = cell["config"], cell["traffic"]
    kind = types.load(cfg["type"], cell["types"])
    n_fill = [s.n_fill for s in gen.streams(cfg, traffic, seed, kind)]
    frames = [f + frames_past_fill for f in n_fill]
    ref = judge.reference(kind, cfg, traffic, seed, frames)
    narrow = judge.reference(kind, cfg, traffic, seed, frames, narrow=True)
    sound = judge.compare(kind, cfg, ref, kind.control_state(cfg, ref), None)
    checks = judge.compare(kind, cfg, ref, kind.control_state(cfg, narrow), None)
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
