"""Cells for the CPU tests: the benchmark's own, and the cells that
BENCHMARK.json does not run (the 1M-key TREG cell, `treg-1m` under
traffic `sweep`, and the dense-drain cell, `pncount-100k-r8` under
`sweep-batch`), each cut to a size a test run holds."""

from __future__ import annotations

from pathlib import Path

from cardbench import run

PKG = Path(__file__).resolve().parents[1]
SMALL = {"pn100k-r8.sweep-read": 4096, "pn100k-r8.sweep-batch": 4096, "treg1m.sweep": 16384}
UNLISTED = {"treg1m.sweep": ("treg-1m", "sweep"),
            "pn100k-r8.sweep-batch": ("pncount-100k-r8", "sweep-batch")}
E2E = [{"name": "acked_merges_per_s", "unit": "merges/s"}, {"name": "setup_s", "unit": "s"}]


def small_cell(name: str) -> dict:
    if name in UNLISTED:
        config, traffic = UNLISTED[name]
        cell = run.make_cell(name, 1, PKG / "configs" / f"{config}.json", traffic, E2E, [])
    else:
        cell = run.load_cell(name)
    cell["config"]["keys"] = SMALL[name]
    cell["traffic"]["warmup_s"] = 1
    if cell["traffic"].get("gets_per_s"):
        cell["traffic"]["gets_per_s"] = 64
    return cell
