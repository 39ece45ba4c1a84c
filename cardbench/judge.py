"""The comparison that decides ``correct``.

The plain reference (reference/) is computed from the deltas the peers
sent, regenerated from the seed and each peer's count of frames
(traffic/gen.py), and compared exactly with what the node gives back
after the window:

* counters: every key's GET over RESP. A GET's value is the row sum the
  drain kernels wrote into the host value cache, so it covers the wire
  decode, converge, the sparse and dense drains on the card, the cache
  and the RESP reply;
* TREG: every key's register on the card (ts and value id planes, after
  the last drain), and a seeded sample of keys' GETs over RESP (the host
  winner the reply renders).

Each number is a count of keys or replies that differ or never came, so
its limit is 0. ``precision`` lets the control compute the reference in
the next narrower type in the program's place (control.py).
"""

from __future__ import annotations

import numpy as np

from .reference.pncount import PNCount
from .reference.treg import TReg
from .traffic import gen

# the lower-precision control's types: u64 counters as u32, u64
# timestamps as u32
NARROW = {"PNCOUNT": np.uint32, "TREG": np.uint32}


def reference(cfg: dict, traffic: dict, seed: int, frames: list[int], narrow: bool = False):
    """The reference state after every peer's first ``frames[r]`` frames."""
    streams = gen.streams(cfg, traffic, seed)
    k = cfg["keys"]
    if cfg["type"] == "PNCOUNT":
        ref = PNCount(k, NARROW["PNCOUNT"] if narrow else np.uint64)
        for s, n in zip(streams, frames):
            for j in range(n):
                keys = s.keys(j)
                ref.join(keys, s.rid, *s.deltas(j, keys))
        return ref
    if cfg["type"] == "TREG":
        ref = TReg(k, cfg["values"]["value_bytes"], NARROW["TREG"] if narrow else np.uint64)
        for s, n in zip(streams, frames):
            for j in range(n):
                keys = s.keys(j)
                ref.join(keys, *s.deltas(j, keys))
        return ref
    raise ValueError(f"no reference for {cfg['type']}")


def compare(cfg: dict, ref, node: dict, window_gets: dict | None) -> dict:
    """The numbers compared, each {"value": n, "limit": 0}."""
    out = {}
    if cfg["type"] == "PNCOUNT":
        values, unread = node["gets"]
        want = ref.values().astype(np.int64)
        out["wrong_values"] = int(np.count_nonzero(values != want))
        out["unread_keys"] = int(unread)
    else:
        is_set, ts, value = node["device"]
        out["wrong_registers"] = int(np.count_nonzero(
            (is_set != ref.set) | (ts != ref.ts.astype(np.uint64)) | (value != ref.value)))
        g_ts, g_val, unread = node["gets"]
        s = node["sample"]
        out["wrong_gets"] = int(np.count_nonzero(
            (g_ts != ref.ts[s].astype(np.uint64)) | (g_val != ref.value[s])))
        out["unread_keys"] = int(unread)
    if window_gets is not None:
        none = sum(v is None for v in window_gets["lat_ms"])
        out["error_replies"] = int(window_gets["errors"])
        out["lost_replies"] = int(none - window_gets["errors"])
    return {name: {"value": v, "limit": 0} for name, v in out.items()}


def judge(cfg: dict, traffic: dict, seed: int, frames: list[int], node: dict,
          window_gets: dict | None) -> dict:
    return compare(cfg, reference(cfg, traffic, seed, frames), node, window_gets)
