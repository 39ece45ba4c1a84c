"""PNCOUNT: a peer's delta is its column of both planes, ({rid: p},
{rid: n}) per key, raised by a seeded increment every cycle: ``p = p0 + c
* p_inc`` and the same for ``n``, with c = 0 in the fill and 1 + the
cycle after it. The p column lies in [2^63, 2^64), so unsigned compares
and wrapping row sums both matter; n lies in [2^56, 2^63).

``correct``: every key's GET over RESP after the window against the
plain reference (reference/pncount.py); the control computes it with u32
columns.
"""

from __future__ import annotations

import numpy as np

from cardbench.reference.pncount import PNCount
from cardbench.traffic import gen, wire
from cardbench.types import _counters

NARROW = np.uint32
DRAIN_AT_CLOSE = _counters.DRAIN_AT_CLOSE
DRAIN_KERNELS = _counters.DRAIN_KERNELS
PLANES = 2


def push(key_bytes: np.ndarray, rid: int, p: np.ndarray, n: np.ndarray,
         p_width: int = 10, n_width: int = 9) -> bytes:
    """A PNCOUNT ``MsgPushDeltas`` body: per key ({rid: p}, {rid: n}).
    ``rid`` takes 10 varint bytes, ``p`` and ``n`` ``p_width`` and
    ``n_width``."""
    rid_col = np.frombuffer(wire.varint(1) + wire.varint(rid), np.uint8)
    cols = [wire.key_column(key_bytes), rid_col, wire.leb128_fixed(p, p_width), rid_col,
            wire.leb128_fixed(n, n_width)]
    return wire.push("PNCOUNT", cols)


class Stream(gen.Stream):
    """A PNCOUNT replica raising its columns every cycle."""

    def __init__(self, cfg, traffic, seed, peer, keys):
        super().__init__(cfg, traffic, seed, peer, keys)
        g = gen.rng(seed, 12, peer)
        k = self.num_keys
        self.rid = int(g.integers(1 << 63, (1 << 64) - 1, dtype=np.uint64, endpoint=True))
        self.p0 = g.integers(1 << 63, (1 << 64) - (1 << 61), k, dtype=np.uint64)
        self.n0 = g.integers(1 << 56, 1 << 62, k, dtype=np.uint64)
        self.p_inc = g.integers(1, 1 << 40, k, dtype=np.uint64)
        self.n_inc = g.integers(1, 1 << 40, k, dtype=np.uint64)

    def deltas(self, j: int, keys=None):
        """(p, n): the column values frame j carries for its keys."""
        keys = self.keys(j) if keys is None else keys
        cycle = np.uint64(0 if j < self.n_fill else 1 + self._cycle_pos(j)[0])
        return (self.p0[keys] + cycle * self.p_inc[keys],
                self.n0[keys] + cycle * self.n_inc[keys])

    def encode(self, key_rows, p, n) -> bytes:
        return push(key_rows, self.rid, p, n)


def reference(cfg: dict, narrow: bool = False) -> PNCount:
    return PNCount(cfg["keys"], NARROW if narrow else np.uint64)


def join(ref: PNCount, stream: Stream, keys: np.ndarray, deltas) -> None:
    ref.join(keys, stream.rid, *deltas)


def readback(node, resp, cfg: dict, keys: np.ndarray, seed: int) -> dict:
    return {"gets": _counters.read_gets(resp, cfg, keys)}


def control_state(cfg: dict, ref: PNCount) -> dict:
    return {"gets": (ref.values().astype(np.int64), 0)}


def compare(cfg: dict, ref: PNCount, state: dict) -> dict:
    return _counters.compare_values(*state["gets"], ref.values().astype(np.int64))


def drain_bytes_per_key(cfg: dict) -> int:
    return _counters.bytes_per_key(PLANES, cfg["replicas"])
