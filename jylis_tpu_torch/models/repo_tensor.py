"""TENSOR repo: device-mirrored tensor-valued register keyspace.

The port of jylis_tpu/models/repo_tensor.py on one device. Each key
holds a fixed-dim f32 vector whose join is per-coordinate MAX,
per-coordinate LWW (replica-id tiebreak), or timestamp-weighted AVG —
the ops/tensor_host.py lattice.

Serving posture is observe-first: GET joins the drained cache with the
pending window entirely on the host — an O(dim) compare, never a device
round-trip — while SET/MRG and incoming deltas coalesce per key in the
host table and drain to the device mirror in one gathered join
(ops/tensor.converge_batch, one kernel launch on a CUDA state) when the
pending window trips the threshold.

Device row mapping: one row per MAX/LWW key; one row per (key,
contributing replica) for AVG keys — so all three merge modes drain
through the ONE (ts, rid, okey) select. The rid plane is the low 32
bits of the contributor id (mirror-only narrowing: the host lattice
keeps full ints and is the serving truth).

Delta wire shape: an ops/tensor_host.Tensor (full joinable state,
delta-state style — cluster/codec.py delta/TENSOR).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cluster import codec
from ..ops import tensor
from ..ops.tensor_host import (
    MODE_AVG,
    MODE_LWW,
    MODE_MAX,
    MODE_NAMES,
    MODES_BY_NAME,
    Tensor,
)
from ..utils.metrics import timed_drain
from .base import ParseError, bucket, need, pad_rows, parse_u64
from .help import RepoHelp
from .tensor_table import PyTensorTable

TENSOR_HELP = RepoHelp(
    "TENSOR",
    {
        "GET": "key",
        "SET": "key mode timestamp vector",
        "MRG": "key delta",
    },
)

# pending writes/deltas flush to the device mirror once they pile this
# high; GETs never need the drain (host winner join), so this bounds
# host-window size while keeping device batches large. Lower than
# TREG's 4096: each row is a whole vector, not a scalar.
PENDING_DRAIN_THRESHOLD = 1024

BADSHAPE = (
    "BADSHAPE (tensor payload must be a non-empty multiple of 4 bytes: "
    "packed little-endian float32)"
)


# jylis_tpu/models/repo_tensor.py:72: the gathered join, IN PLACE (JAX
# donates the state). On a CUDA state it launches one hand-written
# kernel.
def _drain(state, ki, d_val, d_ts_hi, d_ts_lo, d_rid):
    return tensor.converge_batch(state, ki, d_val, d_ts_hi, d_ts_lo, d_rid)


class RepoTENSOR:
    name = "TENSOR"
    help = TENSOR_HELP

    def __init__(self, identity: int, row_cap: int = 1024, device="cuda"):
        self._identity = identity
        self._device = torch.device(device)
        self._tbl = PyTensorTable()
        self._row_cap = row_cap
        self._dim_cap = 8
        self._state = tensor.init(self._row_cap, self._dim_cap, self._device)
        # device rows per table row: {contributor: device row} —
        # contributor is -1 for the single MAX/LWW row, the AVG replica
        # id otherwise (keyed by row so a dominance-flip retirement is
        # O(that row's contributions), not a scan of every device row)
        self._dev_rows: dict[int, dict[int, int]] = {}
        # monotone row allocator: retired rows (dominance flips) are
        # never reused — a reused id would inherit the old rank's planes
        self._next_dev = 0
        # per-AVG-device-row monotone version stamp (see drain)
        self._avg_ver: dict[int, int] = {}
        # last-mirrored (mode, dim) per table row: a dominance flip
        # (replication can upgrade a key's rank wholesale) retires the
        # row's device rows — the old planes hold another lattice's
        # bits, which the monotone select could never regress past
        self._row_stamp: dict[int, tuple[int, int]] = {}

    # -- commands ------------------------------------------------------------

    def apply(self, resp, args: list[bytes]) -> bool:
        op = need(args, 0)
        if op == b"GET":
            row = self._tbl.find(need(args, 1))
            w = self._tbl.winner(row) if row >= 0 else None
            rendered = w.read() if w is not None else None
            if rendered is None:
                resp.null()
            else:
                vec, ts = rendered
                resp.array_start(3)
                resp.string(MODE_NAMES[w.mode])
                resp.string(vec)
                resp.u64(ts)
            return False
        if op == b"SET":
            key = need(args, 1)
            mode = MODES_BY_NAME.get(need(args, 2))
            if mode is None:
                raise ParseError()
            ts = parse_u64(need(args, 3))
            payload = need(args, 4)
            if not payload or len(payload) % 4:
                resp.err(BADSHAPE)
                return False
            if mode == MODE_MAX:
                delta = Tensor.max_value(payload)
            elif mode == MODE_LWW:
                delta = Tensor.lww(payload, ts, self._identity & 0xFFFFFFFF)
            else:
                delta = Tensor.avg(self._identity, ts, payload)
            return self._admit(resp, key, delta)
        if op == b"MRG":
            # client-side anti-entropy: the payload is one canonical
            # wire delta (cluster/codec.py delta/TENSOR bytes) — merge
            # an externally-computed tensor state into the key
            key = need(args, 1)
            try:
                delta = codec.decode_delta("TENSOR", need(args, 2))
            except codec.CodecError:
                resp.err(
                    "BADPAYLOAD (MRG payload must be a canonical "
                    "delta/TENSOR encoding)"
                )
                return False
            if delta.mode == 0:
                resp.err("BADPAYLOAD (empty tensor delta)")
                return False
            return self._admit(resp, key, delta)
        raise ParseError()

    def _admit(self, resp, key: bytes, delta: Tensor) -> bool:
        """The RESP boundary's mode/dim gate: a client write whose
        (mode, dim) stamp disagrees with the key's is REJECTED here —
        only replication paths exercise the lattice's dominance rule."""
        row = self._tbl.find(key)
        if row >= 0:
            stamp = self._tbl.stamp(row)
            if stamp is not None and stamp != (delta.mode, delta.dim):
                cur_m, cur_d = stamp
                resp.err(
                    "BADSHAPE (key holds %s/%d, write is %s/%d)"
                    % (
                        MODE_NAMES[cur_m].decode(),
                        cur_d,
                        MODE_NAMES[delta.mode].decode(),
                        delta.dim,
                    )
                )
                return False
        row = self._tbl.upsert(key)
        self._tbl.write(row, delta)
        self._tbl.note_delta(row, delta)
        if self._tbl.pend_count() >= PENDING_DRAIN_THRESHOLD:
            self.drain()
        resp.ok()
        return True

    # -- lattice plumbing ----------------------------------------------------

    def converge(self, key: bytes, delta: Tensor) -> None:
        # buffer only: the serving path drains via drain_overdue in a
        # worker thread; sync callers (snapshot restore) drain explicitly
        self._tbl.write(self._tbl.upsert(key), delta)

    def load_state(self, batch) -> None:
        """Converge a snapshot's or a journal's batch (buffered; the
        restore's ``drain_all`` lands it on the device)."""
        for key, delta in batch:
            self.converge(key, delta)

    def deltas_size(self) -> int:
        return self._tbl.deltas_size()

    def flush_deltas(self):
        return self._tbl.flush_deltas()

    def may_drain(self, args: list[bytes]) -> bool:
        """GET never drains (host winner join); a SET/MRG may trigger
        the threshold drain, which the server offloads to a thread."""
        return (
            bool(args)
            and args[0] in (b"SET", b"MRG")
            and self._tbl.pend_count() + 1 >= PENDING_DRAIN_THRESHOLD
        )

    def drain_overdue(self) -> bool:
        return self._tbl.pend_count() >= PENDING_DRAIN_THRESHOLD

    # -- sync digest (models/database.py) ------------------------------------

    def sync_dirty_keys(self) -> list[bytes]:
        return [self._tbl.key_of(r) for r in self._tbl.export_sync_dirty()]

    def sync_canon(self, key: bytes) -> bytes | None:
        row = self._tbl.find(key)
        w = self._tbl.winner(row) if row >= 0 else None
        if w is None or w.mode == 0:
            return None
        return repr(w.canon()).encode()

    def dump_state(self):
        """Full state in the wire-delta shape, keys sorted: the host
        truth IS the join the device converges to; the drain brings the
        mirror up to date first."""
        self.drain()
        return self._tbl.dump()

    # -- device drain --------------------------------------------------------

    def _dev_row(self, row: int, contrib: int) -> int:
        m = self._dev_rows.setdefault(row, {})
        dev = m.get(contrib)
        if dev is None:
            dev = self._next_dev
            self._next_dev += 1
            m[contrib] = dev
        return dev

    @timed_drain("TENSOR")
    def drain(self) -> int:
        """Mirror the pending window's winners into the device planes;
        returns its key count (timed_drain's ``keys``)."""
        pend = self._tbl.export_pend()
        if not pend:
            return 0
        # expand to device rows FIRST (capacity growth must see the
        # post-expansion row count and the batch's widest vector). Every
        # plane mirrors the table WINNER (cache ⊔ pending), never the
        # bare pending delta: a stale remote delta in the window must
        # not regress the mirror below the host truth.
        entries: list[tuple[int, Tensor, int]] = []  # dev, winner, rid
        max_dim = 1
        for row, t in pend:
            w = self._tbl.winner(row)
            if w is None or w.mode == 0:
                continue
            max_dim = max(max_dim, w.dim)
            stamp = (w.mode, w.dim)
            prev = self._row_stamp.get(row)
            if prev is not None and prev != stamp:
                # dominance flip: abandon every device row this table
                # row ever mapped to (fresh rows start at the identity,
                # so the new-rank winner lands exactly; the orphaned
                # rows are garbage bounded by the flip count)
                for dev in self._dev_rows.pop(row, {}).values():
                    self._avg_ver.pop(dev, None)
            self._row_stamp[row] = stamp
            if w.mode == MODE_AVG:
                rids = (
                    sorted(t.contribs)
                    if t.mode == MODE_AVG and t.dim == w.dim and prev == stamp
                    else sorted(w.contribs)  # flip/fresh: re-mirror all
                )
                for rid in rids:
                    if rid in w.contribs:
                        entries.append((self._dev_row(row, rid), w, rid))
            else:
                entries.append((self._dev_row(row, -1), w, -1))
        self._grow_to_fit(max_dim)
        if not entries:
            self._tbl.fold_pend()
            return len(pend)
        b = bucket(len(entries))
        d = self._dim_cap
        ki = pad_rows(b)
        d_val = np.full((b, d), tensor.BOTTOM_BITS, np.uint32)
        d_ts = np.zeros((b, d), np.uint64)
        d_rid = np.zeros((b, d), np.uint32)
        for i, (dev, w, contrib) in enumerate(entries):
            ki[i] = dev
            dim = w.dim
            if w.mode == MODE_AVG:
                # an AVG contribution row mirrors the host's whole-vector
                # winner for (key, rid): the host joins same-rid
                # contributions as whole vectors (lexicographic
                # (ts, okey-tuple)), which a per-coordinate select cannot
                # reproduce at equal-ts ties — so the ts planes carry a
                # LOCAL monotone version stamp, making the select
                # degenerate to take-latest-host-winner. The mirror
                # reflects this node's converged truth; cross-replica
                # convergence already happened in the host join.
                _cts, vec = w.contribs[contrib]
                ver = self._avg_ver.get(dev, 0) + 1
                self._avg_ver[dev] = ver
                d_val[i, :dim] = np.frombuffer(vec, "<u4")
                d_ts[i, :dim] = ver
                d_rid[i, :dim] = contrib & 0xFFFFFFFF
            else:
                # MAX/LWW winners are per-coordinate monotone across
                # drains WITHIN one (mode, dim) rank — flips retire the
                # row above — so the device join lands exactly the winner
                d_val[i, :dim] = np.frombuffer(w.val, "<u4")
                if w.mode == MODE_LWW:
                    d_ts[i, :dim] = np.frombuffer(w.ts, "<u8")
                    d_rid[i, :dim] = np.frombuffer(w.rid, "<u4")
        ts_hi = (d_ts >> np.uint64(32)).astype(np.uint32)
        ts_lo = d_ts.astype(np.uint32)

        def dev(x):
            return torch.from_numpy(x.view(np.int32)).to(self._device)

        _drain(self._state, dev(ki), dev(d_val), dev(ts_hi), dev(ts_lo),
               dev(d_rid))
        self._tbl.fold_pend()
        return len(pend)

    def _grow_to_fit(self, max_dim: int) -> None:
        rows = bucket(max(self._next_dev, 1), self._row_cap)
        dim = bucket(max_dim, self._dim_cap)
        if (rows, dim) != (self._row_cap, self._dim_cap):
            self._row_cap, self._dim_cap = rows, dim
            self._state = tensor.grow(self._state, rows, dim)
