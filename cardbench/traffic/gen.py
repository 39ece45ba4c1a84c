"""The general traffic generator: one peer's delta stream, from the
seed, a configuration file and a traffic file.

Every peer is one replica id on one connection. It walks the keyspace
in cycles, each cycle a seeded permutation of all keys of its own, cut
into frames of ``frame_keys`` keys (the node's own ``SYNC_CHUNK_KEYS``),
each frame's keys in order as a node's own flushes and dumps send them;
frame ``j`` of the stream is a pure function of (seed, peer, j), so the
reference regenerates exactly the frames a run sent from their count.
The set-up fill comes first in the stream: the keys split among the
peers, each peer sends its share once, so every key exists, and every
replica id has a column, before the window.

What a delta carries follows the configuration's data type:

* PNCOUNT: the peer's column of both planes, raised by a seeded
  increment every cycle: ``p = p0 + c * p_inc`` and the same for ``n``,
  with c = 0 in the fill and 1 + the cycle after it. The p column lies in [2^63, 2^64), so unsigned compares and
  wrapping row sums both matter; n lies in [2^56, 2^63).
* TREG: a (value, timestamp) pair. Timestamps are ``2^63 | hi << 32 |
  lo`` with ``hi`` and ``lo`` drawn from small seeded sets, so equal
  timestamps meet (the value breaks the tie) and the low 32 bits alone
  do not order them; values share a few 8-byte prefixes, so some ties
  need the full value.

Imports nothing of the program.
"""

from __future__ import annotations

import re

import numpy as np

from . import wire

HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


def key_bytes(fmt: str, count: int) -> np.ndarray:
    """(count, L) uint8: the keys ``fmt % i`` for ``fmt`` of the form
    ``<prefix>%0<N>d``, all of one length."""
    m = re.fullmatch(r"(.*)%0(\d+)d", fmt)
    if m is None:
        raise ValueError(f"key_format must be <prefix>%0<N>d: {fmt!r}")
    prefix, digits = m.group(1).encode(), int(m.group(2))
    if count > 10 ** digits:
        raise ValueError(f"{count} keys do not fit {digits} digits")
    idx = np.arange(count, dtype=np.int64)
    out = np.empty((count, len(prefix) + digits), np.uint8)
    out[:, : len(prefix)] = np.frombuffer(prefix, np.uint8)
    for d in range(digits):
        out[:, len(prefix) + digits - 1 - d] = 48 + (idx // 10 ** d) % 10
    return out


def _rng(*words) -> np.random.Generator:
    return np.random.default_rng([int(w) & 0xFFFFFFFF for w in words]
                                 + [int(w) >> 32 for w in words])


class Stream:
    """One peer's frames: ``keys(j)`` (the key indices of frame j),
    ``deltas(j)`` (what they carry, as arrays) and ``frame(j)`` (the
    message body on the wire). ``n_fill`` frames of set-up come first."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, peer: int, keys: np.ndarray):
        self.cfg, self.seed, self.peer = cfg, seed, peer
        self.num_keys = cfg["keys"]
        self.peers = cfg["replicas"]
        self.frame_keys = traffic["frame_keys"]
        self.key_table = keys
        self.per_cycle = -(-self.num_keys // self.frame_keys)
        self._perm_cycle, self._perm = -1, None
        self.fill_keys = np.arange(peer, self.num_keys, self.peers, dtype=np.int64)
        self.n_fill = -(-len(self.fill_keys) // self.frame_keys)

    def _cycle_pos(self, j: int) -> tuple[int, int]:
        """(cycle, frame within it) of stream frame j >= n_fill."""
        return divmod(j - self.n_fill, self.per_cycle)

    def keys(self, j: int) -> np.ndarray:
        if j < self.n_fill:
            return self.fill_keys[j * self.frame_keys : (j + 1) * self.frame_keys]
        cycle, pos = self._cycle_pos(j)
        if cycle != self._perm_cycle:
            self._perm = _rng(self.seed, 11, self.peer, cycle).permutation(self.num_keys)
            self._perm_cycle = cycle
        # a frame lists its keys in order, as a node's flush and dump do
        return np.sort(self._perm[pos * self.frame_keys : (pos + 1) * self.frame_keys])

    def frame(self, j: int) -> bytes:
        keys = self.keys(j)
        return self._encode(self.key_table[keys], *self.deltas(j, keys))


class PNCountStream(Stream):
    """A PNCOUNT replica raising its columns every cycle."""

    def __init__(self, cfg, traffic, seed, peer, keys):
        super().__init__(cfg, traffic, seed, peer, keys)
        g = _rng(seed, 12, peer)
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

    def _encode(self, key_rows, p, n) -> bytes:
        return wire.pncount_push(key_rows, self.rid, p, n)


class TRegStream(Stream):
    """A TREG replica setting random (value, timestamp) pairs."""

    def __init__(self, cfg, traffic, seed, peer, keys):
        super().__init__(cfg, traffic, seed, peer, keys)
        vals = cfg["values"]
        shared = _rng(seed, 20)  # one set of each for all peers: they collide
        hi = set()
        while len(hi) < vals["ts_hi_count"]:
            hi.update(shared.integers(0, 1 << 31, vals["ts_hi_count"]).tolist())
        self.ts_hi = np.array(sorted(hi)[: vals["ts_hi_count"]], np.uint64)
        self.ts_lo_count = vals["ts_lo_count"]
        self.prefixes = HEX[shared.integers(0, 16, (vals["value_prefixes"], 8))]
        self.value_bytes = vals["value_bytes"]

    def deltas(self, j: int, keys=None):
        """(values (n, value_bytes) uint8, ts u64) of frame j."""
        n = len(self.keys(j) if keys is None else keys)
        g = _rng(self.seed, 21, self.peer, j)
        ts = (np.uint64(1 << 63)
              | (self.ts_hi[g.integers(0, len(self.ts_hi), n)] << np.uint64(32))
              | g.integers(0, self.ts_lo_count, n).astype(np.uint64))
        values = np.empty((n, self.value_bytes), np.uint8)
        values[:, :8] = self.prefixes[g.integers(0, len(self.prefixes), n)]
        values[:, 8:] = HEX[g.integers(0, 16, (n, self.value_bytes - 8))]
        return values, ts

    def _encode(self, key_rows, values, ts) -> bytes:
        return wire.treg_push(key_rows, values, ts)


STREAMS = {"PNCOUNT": PNCountStream, "TREG": TRegStream}


def streams(cfg: dict, traffic: dict, seed: int) -> list[Stream]:
    """Every peer's stream of a cell."""
    keys = key_bytes(cfg["key_format"], cfg["keys"])
    cls = STREAMS[cfg["type"]]
    return [cls(cfg, traffic, seed, r, keys) for r in range(cfg["replicas"])]
