"""String interning: host strings <-> device integer ids.

The port's copy of jylis_tpu/ops/interner.py (no device code).

Keys and values live on the host; the device sees only integer ids plus an
order-preserving 8-byte prefix rank so lattice tie-breaks that the reference
resolves "by sorting rules" (bytewise string comparison,
docs/_docs/types/treg.md:60-63, tlog.md:124-127) can run on-device. Two
strings with the same 8-byte prefix but different tails compare equal on
device; callers get a tie flag and resolve those rare cases on host with the
full strings.
"""

from __future__ import annotations

import numpy as np

from ..utils.batching import bucket

_PAD = b"\x00" * 8


def prefix_rank(s: bytes) -> int:
    """Order-preserving uint64: big-endian first 8 bytes, zero padded.

    rank(a) < rank(b) implies a < b bytewise; equality is inconclusive
    (prefix collision) unless both strings are <= 8 bytes.
    """
    return int.from_bytes((s[:8] + _PAD)[:8], "big")


class Interner:
    """Bidirectional bytes<->id table with a device-shippable rank array.

    Ids are dense and never reused BETWEEN compactions; id equality is
    exact string equality, which is what the device dedup kernels rely on
    (e.g. TLOG duplicate detection requires equal timestamp AND equal
    value, docs/_docs/types/tlog.md:122). Long-running write churn
    (TREG overwrites, TLOG trims) strands dead ids; owners periodically
    `compact` with their live-id set and remap every stored id — host
    caches and device planes alike — so memory tracks the LIVE state,
    not the write history."""

    __slots__ = ("_to_id", "_strings", "_ranks", "_cap")

    def __init__(self, initial_capacity: int = 1024):
        self._to_id: dict[bytes, int] = {}
        self._strings: list[bytes] = []
        self._cap = max(int(initial_capacity), 16)
        self._ranks = np.zeros(self._cap, dtype=np.uint64)

    def __len__(self) -> int:
        return len(self._strings)

    # ids must stay below 2**31 - 1: the TLOG sort planes carry the biased
    # id (vid + 1) in one u32 lane (ops/tlog._planes). Unreachable in
    # practice — two billion live strings would exhaust host memory first,
    # and compaction keeps ids dense — but fail loudly, never corrupt.
    MAX_ID = (1 << 31) - 2

    def intern(self, s: bytes) -> int:
        sid = self._to_id.get(s)
        if sid is None:
            sid = len(self._strings)
            if sid > self.MAX_ID:
                raise RuntimeError(
                    "interner id space exhausted (2**31 ids); compaction "
                    "should have reclaimed dead ids long before this"
                )
            self._to_id[s] = sid
            self._strings.append(s)
            if sid >= self._cap:
                self._cap *= 2
                ranks = np.zeros(self._cap, dtype=np.uint64)
                ranks[: len(self._ranks)] = self._ranks
                self._ranks = ranks
            self._ranks[sid] = prefix_rank(s)
        return sid

    def intern_many(self, strings) -> np.ndarray:
        return np.fromiter(
            (self.intern(s) for s in strings), dtype=np.int64, count=len(strings)
        )

    def lookup(self, sid: int) -> bytes:
        return self._strings[sid]

    def rank(self, sid: int) -> int:
        return int(self._ranks[sid])

    def ranks_for(self, ids: np.ndarray) -> np.ndarray:
        """Vectorised id -> rank (ids must be valid; -1 maps to rank 0)."""
        ids = np.asarray(ids, dtype=np.int64)
        out = np.zeros(ids.shape, dtype=np.uint64)
        valid = ids >= 0
        out[valid] = self._ranks[ids[valid]]
        return out

    def contains(self, s: bytes) -> bool:
        return s in self._to_id

    def compact(self, live_ids) -> np.ndarray:
        """Drop every string not in `live_ids` (ints, repeats fine).

        Returns the remap array: old id -> new id, -1 for dead ids. The
        caller MUST apply it to every place an old id is stored (host
        caches, device planes) before interning anything new — old and
        new ids share the same space."""
        remap = np.full(len(self._strings), -1, np.int64)
        new_strings: list[bytes] = []
        for oid in live_ids:
            oid = int(oid)
            if remap[oid] < 0:
                remap[oid] = len(new_strings)
                new_strings.append(self._strings[oid])
        self._strings = new_strings
        self._to_id = {s: i for i, s in enumerate(new_strings)}
        self._cap = bucket(len(new_strings), 16)
        ranks = np.zeros(self._cap, dtype=np.uint64)
        for i, s in enumerate(new_strings):
            ranks[i] = prefix_rank(s)
        self._ranks = ranks
        return remap
