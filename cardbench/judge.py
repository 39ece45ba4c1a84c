"""The comparison that decides ``correct``.

The plain reference (reference/) is computed from the deltas the peers
sent, regenerated from the seed and each peer's count of frames
(traffic/gen.py), and compared exactly with what the node gives back
after the window: what the data type's module (types/<type>.py) reads
back and compares, and the window's GETs. Each number is a count of
keys or replies that differ or never came, so its limit is 0.
``narrow`` lets the control compute the reference in the type's next
narrower type in the program's place (control.py).
"""

from __future__ import annotations

from .traffic import gen


def reference(kind, cfg: dict, traffic: dict, seed: int, frames: list[int],
              narrow: bool = False):
    """The reference state after every peer's first ``frames[r]`` frames;
    ``kind`` is the configuration's type module."""
    ref = kind.reference(cfg, narrow)
    for s, n in zip(gen.streams(cfg, traffic, seed, kind), frames):
        for j in range(n):
            keys = s.keys(j)
            kind.join(ref, s, keys, s.deltas(j, keys))
    return ref


def compare(kind, cfg: dict, ref, node: dict, window_gets: dict | None) -> dict:
    """The numbers compared, each {"value": n, "limit": 0}."""
    out = dict(kind.compare(cfg, ref, node))
    if window_gets is not None:
        none = sum(v is None for v in window_gets["lat_ms"])
        out["error_replies"] = int(window_gets["errors"])
        out["lost_replies"] = int(none - window_gets["errors"])
    return {name: {"value": v, "limit": 0} for name, v in out.items()}


def judge(kind, cfg: dict, traffic: dict, seed: int, frames: list[int], node: dict,
          window_gets: dict | None) -> dict:
    return compare(kind, cfg, reference(kind, cfg, traffic, seed, frames), node, window_gets)
