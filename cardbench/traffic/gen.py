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

What a delta carries, and its bytes on the wire, follow the
configuration's data type: its module's ``Stream`` (types/<type>.py).

Imports nothing of the program.
"""

from __future__ import annotations

import re

import numpy as np

from .. import types

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


def rng(*words) -> np.random.Generator:
    return np.random.default_rng([int(w) & 0xFFFFFFFF for w in words]
                                 + [int(w) >> 32 for w in words])


class Stream:
    """One peer's frames: ``keys(j)`` (the key indices of frame j),
    ``deltas(j, keys)`` (what they carry, as arrays; the type's) and
    ``frame(j)`` (the message body on the wire, ``encode`` of the key
    rows and the deltas; the type's). ``n_fill`` frames of set-up come
    first."""

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
            self._perm = rng(self.seed, 11, self.peer, cycle).permutation(self.num_keys)
            self._perm_cycle = cycle
        # a frame lists its keys in order, as a node's flush and dump do
        return np.sort(self._perm[pos * self.frame_keys : (pos + 1) * self.frame_keys])

    def frame(self, j: int) -> bytes:
        keys = self.keys(j)
        return self.encode(self.key_table[keys], *self.deltas(j, keys))


def streams(cfg: dict, traffic: dict, seed: int, kind=None) -> list[Stream]:
    """Every peer's stream of a cell, of the ``Stream`` of ``kind`` (the
    configuration's type module, types.load)."""
    kind = types.load(cfg["type"]) if kind is None else kind
    keys = key_bytes(cfg["key_format"], cfg["keys"])
    return [kind.Stream(cfg, traffic, seed, r, keys) for r in range(cfg["replicas"])]
