"""TREG: a peer's delta is a (value, timestamp) pair per key. Timestamps
are ``2^63 | hi << 32 | lo`` with ``hi`` and ``lo`` drawn from small
seeded sets, so equal timestamps meet (the value breaks the tie) and the
low 32 bits alone do not order them; values share a few 8-byte prefixes,
so some ties need the full value.

``correct``: every key's register on the card (ts and value id planes,
after the last drain), and a seeded sample of keys' GETs over RESP (the
host winner the reply renders), against the plain reference
(reference/treg.py); the control computes it with u32 timestamps.

The drain's roofline, per key: its row index (4); its delta and its
state register read (ts 8, value-prefix rank 8, value id 4: 20 each);
its result out (tie flag 1, ts 8, value id 4). A register the delta wins
would add 20 written; what the data decides is not counted, so the bound
is a lower bound and a share of it never overstates.
"""

from __future__ import annotations

import numpy as np

from cardbench.reference.treg import TReg
from cardbench.traffic import gen, wire

NARROW = np.uint32
GET_SAMPLE = 20000
DRAIN_AT_CLOSE = False
DRAIN_KERNELS = ("treg_drain_sparse", "treg_drain_dense", "treg_dense_clear", "scatter_slots")
BYTES_PER_KEY = 4 + 20 + 20 + 1 + 8 + 4


def push(key_bytes: np.ndarray, values: np.ndarray, ts: np.ndarray,
         ts_width: int = 10) -> bytes:
    """A TREG ``MsgPushDeltas`` body: per key (value, ts). ``values`` is
    an (n, V) uint8 array of fixed-length values."""
    cols = [wire.key_column(key_bytes), wire.key_column(values), wire.leb128_fixed(ts, ts_width)]
    return wire.push("TREG", cols)


class Stream(gen.Stream):
    """A TREG replica setting random (value, timestamp) pairs."""

    def __init__(self, cfg, traffic, seed, peer, keys):
        super().__init__(cfg, traffic, seed, peer, keys)
        vals = cfg["values"]
        shared = gen.rng(seed, 20)  # one set of each for all peers: they collide
        hi = set()
        while len(hi) < vals["ts_hi_count"]:
            hi.update(shared.integers(0, 1 << 31, vals["ts_hi_count"]).tolist())
        self.ts_hi = np.array(sorted(hi)[: vals["ts_hi_count"]], np.uint64)
        self.ts_lo_count = vals["ts_lo_count"]
        self.prefixes = gen.HEX[shared.integers(0, 16, (vals["value_prefixes"], 8))]
        self.value_bytes = vals["value_bytes"]

    def deltas(self, j: int, keys=None):
        """(values (n, value_bytes) uint8, ts u64) of frame j."""
        n = len(self.keys(j) if keys is None else keys)
        g = gen.rng(self.seed, 21, self.peer, j)
        ts = (np.uint64(1 << 63)
              | (self.ts_hi[g.integers(0, len(self.ts_hi), n)] << np.uint64(32))
              | g.integers(0, self.ts_lo_count, n).astype(np.uint64))
        values = np.empty((n, self.value_bytes), np.uint8)
        values[:, :8] = self.prefixes[g.integers(0, len(self.prefixes), n)]
        values[:, 8:] = gen.HEX[g.integers(0, 16, (n, self.value_bytes - 8))]
        return values, ts

    def encode(self, key_rows, values, ts) -> bytes:
        return push(key_rows, values, ts)


def reference(cfg: dict, narrow: bool = False) -> TReg:
    return TReg(cfg["keys"], cfg["values"]["value_bytes"], NARROW if narrow else np.uint64)


def join(ref: TReg, stream: Stream, keys: np.ndarray, deltas) -> None:
    ref.join(keys, *deltas)


def read_gets(resp, keys: np.ndarray, sample: np.ndarray, value_bytes: int):
    """GETs of the sampled keys: (ts u64, value, unreadable count)."""
    replies = resp.pipeline([[b"TREG", b"GET", keys[i].tobytes()] for i in sample])
    ts = np.zeros(len(sample), np.uint64)
    val = np.zeros(len(sample), f"S{value_bytes}")
    bad = 0
    for i, r in enumerate(replies):
        if isinstance(r, list) and len(r) == 2 and isinstance(r[0], bytes) and isinstance(r[1], int):
            val[i], ts[i] = r[0], r[1]
        else:
            bad += 1
    return ts, val, bad


def read_device(db, keys: np.ndarray, value_bytes: int):
    """The TREG state on the card after the last drain, per key: (set,
    ts u64, value). Reads the repo's planes (``_state``: ts and the
    interned value id per row) and maps rows and ids back through its
    host tables. Runs under the repo locks."""
    repo = db.manager("TREG").repo
    repo.drain()
    st = repo._state
    ts_plane = st.ts.cpu().numpy().view(np.uint64)
    vid_plane = st.vid.cpu().numpy()
    n = len(keys)
    rows = np.fromiter((repo._tbl.find(keys[i].tobytes()) for i in range(n)), np.int64, n)
    have = rows >= 0
    vids = np.where(have, vid_plane[np.where(have, rows, 0)], -1)
    is_set = vids >= 0
    ts = np.where(is_set, ts_plane[np.where(have, rows, 0)], 0).astype(np.uint64)
    value = np.zeros(n, f"S{value_bytes}")
    uniq, inverse = np.unique(vids[is_set], return_inverse=True)
    lookup = repo._interner.lookup
    value[is_set] = np.array([lookup(int(v)) for v in uniq], f"S{value_bytes}")[inverse]
    return is_set, ts, value


def readback(node, resp, cfg: dict, keys: np.ndarray, seed: int) -> dict:
    sample = np.sort(np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 41]).choice(
        cfg["keys"], min(GET_SAMPLE, cfg["keys"]), replace=False))
    vb = cfg["values"]["value_bytes"]
    state = {"device": node.locked(lambda: read_device(node.db, keys, vb))}
    state["gets"] = read_gets(resp, keys, sample, vb)
    state["sample"] = sample
    return state


def control_state(cfg: dict, ref: TReg) -> dict:
    sample = np.arange(0, cfg["keys"], max(1, cfg["keys"] // GET_SAMPLE))
    ts = ref.ts.astype(np.uint64)
    return {"device": (ref.set, ts, ref.value),
            "gets": (ts[sample], ref.value[sample], 0), "sample": sample}


def compare(cfg: dict, ref: TReg, state: dict) -> dict:
    is_set, ts, value = state["device"]
    g_ts, g_val, unread = state["gets"]
    s = state["sample"]
    return {
        "wrong_registers": int(np.count_nonzero(
            (is_set != ref.set) | (ts != ref.ts.astype(np.uint64)) | (value != ref.value))),
        "wrong_gets": int(np.count_nonzero(
            (g_ts != ref.ts[s].astype(np.uint64)) | (g_val != ref.value[s]))),
        "unread_keys": int(unread),
    }


def drain_bytes_per_key(cfg: dict) -> int:
    return BYTES_PER_KEY
