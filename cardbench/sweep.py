"""The GET rate sweep that fixed ``gets_per_s`` of an open-loop cell.

``python -m cardbench.sweep --workload <cell> --seed <n> --seconds <s>
--rates 250,500,1000`` runs the cell once at each offered GET rate, one
node after another in this process, and prints per rate the GET median
and p95, the p95 of the window's first and last thirds (a last third far
above the first is a growing backlog), the reader's worst lateness and
merges/s. The cell's rate is set at about four fifths of the highest
rate whose p95 holds with no growing backlog. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

from .metrics._common import percentile
from .run import load_cell, run_cell


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m cardbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = load_cell(args.workload)
        cell["traffic"]["gets_per_s"] = rate
        cell["end_to_end"] = []
        out = run_cell(cell, args.seed, args.seconds, False)
        lat = out["record"]["gets"]["lat_ms"]
        third = max(1, len(lat) // 3)
        print(json.dumps({
            "rate": rate, "correct": out["result"]["correct"], "gets": len(lat),
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "p95_first_third_ms": percentile(lat[:third], 95),
            "p95_last_third_ms": percentile(lat[-third:], 95),
            "sender_lag_ms": out["record"]["gets"]["sender_lag_ms"],
            "merges_per_s": out["record"]["merges"] / out["record"]["window_s"],
        }), flush=True)


if __name__ == "__main__":
    main()
