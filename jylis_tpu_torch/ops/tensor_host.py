"""TENSOR host lattice: fixed-shape f32 vectors with per-coordinate joins.

The sixth data type (ROADMAP item 3) and the first whose VALUES are
tensors: each key holds a fixed-dimension float32 vector, and the join
is per-coordinate — the workload of "CRDTs for Neural Network Model
Merging" (arXiv:2605.19373) and "Cache Merging as a Convergent
Replicated State for Multi-Agent Latent Reasoning" (arXiv:2607.01308),
where replicated embedding/feature rows converge coordinatewise.

The port's copy of jylis_tpu/ops/tensor_host.py, unchanged in
behaviour: it is the wire-value object the delta codec ships
(cluster/codec.py) and the serving host truth behind
models/tensor_table.py. The batched device mirror lives in
ops/tensor.py.

Three merge modes, all total orders per cell, so every join is a
lattice join by construction:

* ``MAX``  — element-wise maximum. Coordinates are ordered by
  ``okey`` (the order-preserving u32 transform of the f32 bit pattern),
  which totalises IEEE order: ``-0.0 < +0.0`` and the canonical quiet
  NaN sits ABOVE ``+inf`` as the per-coordinate lattice top. Every
  ingest path canonicalises NaN payloads to one bit pattern
  (``0x7FC00000``) so converged replicas are byte-identical.
* ``LWW``  — per-coordinate last-writer-wins: cell B beats cell A iff
  ``(ts_B, rid_B, okey(val_B)) > (ts_A, rid_A, okey(val_A))``. The
  replica-id tiebreak makes equal-timestamp writes from different
  replicas deterministic; the final value-bits tiebreak keeps the order
  total even for adversarial inputs that reuse a (ts, rid) pair.
* ``AVG``  — timestamp-weighted average (arXiv:2605.19373): state is a
  per-replica contribution map ``rid -> (ts, vector)`` joined per rid
  by ``(ts, okey-tuple)`` — a product of total orders — and the READ
  derives ``sum(ts_i * v_i) / sum(ts_i)`` over the converged
  contributions in sorted-rid f64 order, so every converged replica
  renders the same f32 bytes.

Values with different ``(mode, dim)`` stamps are joined by dominance:
the greater ``(mode, dim)`` pair wins wholesale (a lexicographic sum of
lattices over totally-ordered classes — still a lattice). The RESP
boundary REJECTS mode/dim mismatches before they reach the lattice
(models/repo_tensor.py); the dominance rule exists so a malformed or
rolled-upgrade peer can never wedge convergence.

Wire shape (cluster/codec.py delta/TENSOR): every field ships every
time — ``(mode, dim, val, ts, rid, contribs)`` with empty byte strings
for the planes a mode does not use — so the codec's encode/decode
bodies stay branch-free.
"""

from __future__ import annotations

import numpy as np

from ..utils.wire import WireError

MODE_NONE = 0  # unset bottom
MODE_MAX = 1
MODE_LWW = 2
MODE_AVG = 3

MODE_NAMES = {MODE_MAX: b"MAX", MODE_LWW: b"LWW", MODE_AVG: b"AVG"}
MODES_BY_NAME = {v: k for k, v in MODE_NAMES.items()}

_U32 = np.uint32
_EXP_MASK = _U32(0x7F800000)
_MANT_MASK = _U32(0x007FFFFF)
CANON_NAN_BITS = 0x7FC00000  # the one quiet-NaN pattern the lattice keeps

# per-coordinate identity: okey == 0 (below every canonical float)
BOTTOM_BITS = 0xFFFFFFFF


def okey_u32(u: np.ndarray) -> np.ndarray:
    """Order-preserving u32 transform of f32 bit patterns: unsigned
    compares on the result match IEEE order, totalised (-0 < +0, the
    canonical NaN above +inf). Mirrors ops/tensor.py's device _okey."""
    u = np.asarray(u, _U32)
    return np.where(u >> _U32(31), ~u, u | _U32(0x80000000)).astype(_U32)


def canon_f32(raw: bytes) -> bytes:
    """Canonicalise a packed little-endian f32 vector: every NaN payload
    collapses to CANON_NAN_BITS so joins and digests are byte-stable."""
    u = np.frombuffer(raw, "<u4").copy()
    nan = ((u & _EXP_MASK) == _EXP_MASK) & ((u & _MANT_MASK) != 0)
    if nan.any():
        u[nan] = _U32(CANON_NAN_BITS)
    return u.tobytes()


def unpack_f32(raw: bytes) -> list[float]:
    return np.frombuffer(raw, "<f4").astype(float).tolist()


def pack_f32(values) -> bytes:
    return canon_f32(np.asarray(list(values), "<f4").tobytes())


def _okey_tuple(raw: bytes) -> tuple:
    return tuple(okey_u32(np.frombuffer(raw, "<u4")).tolist())


class Tensor:
    """One key's joinable tensor state (and, delta-state style, every
    delta is itself a Tensor)."""

    __slots__ = ("mode", "dim", "val", "ts", "rid", "contribs")

    def __init__(self):
        self.mode = MODE_NONE
        self.dim = 0
        self.val = b""  # (dim,) packed <f4, canonical (MAX/LWW)
        self.ts = b""  # (dim,) packed <u8 (LWW)
        self.rid = b""  # (dim,) packed <u4 (LWW)
        self.contribs: dict[int, tuple[int, bytes]] = {}  # AVG: rid->(ts, vec)

    # ---- constructors ------------------------------------------------------

    @classmethod
    def max_value(cls, raw: bytes) -> "Tensor":
        t = cls()
        t.mode, t.dim, t.val = MODE_MAX, _vec_dim(raw), canon_f32(raw)
        return t

    @classmethod
    def lww(cls, raw: bytes, ts: int, rid: int) -> "Tensor":
        """A whole-vector write: every coordinate stamped (ts, rid)."""
        t = cls()
        t.mode, t.dim, t.val = MODE_LWW, _vec_dim(raw), canon_f32(raw)
        t.ts = np.full(t.dim, ts, "<u8").tobytes()
        t.rid = np.full(t.dim, rid, "<u4").tobytes()
        return t

    @classmethod
    def avg(cls, rid: int, ts: int, raw: bytes) -> "Tensor":
        t = cls()
        t.mode, t.dim = MODE_AVG, _vec_dim(raw)
        t.contribs = {int(rid): (int(ts), canon_f32(raw))}
        return t

    # ---- the lattice join --------------------------------------------------

    def _rank(self) -> tuple[int, int]:
        return (self.mode, self.dim)

    def _copy_from(self, other: "Tensor") -> None:
        self.mode, self.dim = other.mode, other.dim
        self.val, self.ts, self.rid = other.val, other.ts, other.rid
        self.contribs = dict(other.contribs)  # values are immutable tuples

    def converge(self, other: "Tensor") -> bool:
        if other.mode == MODE_NONE or other._rank() < self._rank():
            return False
        if self.mode == MODE_NONE or other._rank() > self._rank():
            self._copy_from(other)
            return True
        if self.mode == MODE_MAX:
            return self._join_max(other)
        if self.mode == MODE_LWW:
            return self._join_lww(other)
        return self._join_avg(other)

    def _join_max(self, other: "Tensor") -> bool:
        a = np.frombuffer(self.val, "<u4")
        b = np.frombuffer(other.val, "<u4")
        take = okey_u32(b) > okey_u32(a)
        if not take.any():
            return False
        self.val = np.where(take, b, a).astype(_U32).tobytes()
        return True

    def _join_lww(self, other: "Tensor") -> bool:
        a_ts = np.frombuffer(self.ts, "<u8")
        b_ts = np.frombuffer(other.ts, "<u8")
        a_rid = np.frombuffer(self.rid, "<u4")
        b_rid = np.frombuffer(other.rid, "<u4")
        a_k = okey_u32(np.frombuffer(self.val, "<u4"))
        b_k = okey_u32(np.frombuffer(other.val, "<u4"))
        ts_eq = a_ts == b_ts
        rid_eq = a_rid == b_rid
        take = (b_ts > a_ts) | (
            ts_eq & ((b_rid > a_rid) | (rid_eq & (b_k > a_k)))
        )
        if not take.any():
            return False
        a_v = np.frombuffer(self.val, "<u4")
        b_v = np.frombuffer(other.val, "<u4")
        self.val = np.where(take, b_v, a_v).astype(_U32).tobytes()
        self.ts = np.where(take, b_ts, a_ts).astype("<u8").tobytes()
        self.rid = np.where(take, b_rid, a_rid).astype(_U32).tobytes()
        return True

    def _join_avg(self, other: "Tensor") -> bool:
        changed = False
        for rid, (ts, vec) in other.contribs.items():
            cur = self.contribs.get(rid)
            if cur is None or (ts, _okey_tuple(vec)) > (
                cur[0], _okey_tuple(cur[1])
            ):
                self.contribs[rid] = (ts, vec)
                changed = True
        return changed

    # ---- reads -------------------------------------------------------------

    def read(self) -> tuple[bytes, int] | None:
        """(rendered vector bytes, newest timestamp), or None when unset.
        Deterministic on every converged replica: AVG sums in f64 over
        sorted rids, MAX reports ts 0 (it carries no clock)."""
        if self.mode == MODE_NONE:
            return None
        if self.mode == MODE_MAX:
            return self.val, 0
        if self.mode == MODE_LWW:
            ts = np.frombuffer(self.ts, "<u8")
            return self.val, int(ts.max()) if ts.size else 0
        acc = np.zeros(self.dim, np.float64)
        wtot = 0.0
        ts_max = 0
        # NaN/inf coordinates propagate through the mean by IEEE rules —
        # deterministic on every replica (sorted-rid f64 accumulation),
        # so the arithmetic warnings are expected, not errors
        with np.errstate(invalid="ignore", over="ignore"):
            for rid in sorted(self.contribs):
                ts, vec = self.contribs[rid]
                w = float(ts)
                acc += w * np.frombuffer(vec, "<f4").astype(np.float64)
                wtot += w
                ts_max = max(ts_max, ts)
            if wtot == 0.0:
                # all-zero weights: fall back to the unweighted mean —
                # from a FRESH accumulator (the weighted pass leaves
                # 0*inf = NaN contamination behind)
                acc = np.zeros(self.dim, np.float64)
                for rid in sorted(self.contribs):
                    acc += np.frombuffer(
                        self.contribs[rid][1], "<f4"
                    ).astype(np.float64)
                wtot = float(len(self.contribs))
            out = (acc / wtot).astype("<f4").tobytes()
        return canon_f32(out), ts_max

    def canon(self) -> tuple:
        """Canonical comparable/digestable form (representation-normal)."""
        return (
            self.mode,
            self.dim,
            self.val,
            self.ts,
            self.rid,
            tuple(sorted(self.contribs.items())),
        )

    # ---- wire validation (cluster/codec.py delta/TENSOR) -------------------

    @classmethod
    def from_wire(
        cls, mode: int, dim: int, val: bytes, ts: bytes, rid: bytes, contribs
    ) -> "Tensor":
        """Rebuild + validate a decoded delta: plane lengths must match
        the mode's shape exactly (a mismatch is wire corruption, not a
        lattice state)."""
        t = cls()
        if mode == MODE_NONE and dim == 0 and not (val or ts or rid or contribs):
            return t
        if mode not in MODE_NAMES or dim < 1:
            raise WireError(f"bad tensor header: mode={mode} dim={dim}")
        want_val = 4 * dim
        if mode == MODE_MAX:
            if len(val) != want_val or ts or rid or contribs:
                raise WireError("MAX tensor plane shape mismatch")
        elif mode == MODE_LWW:
            if len(val) != want_val or len(ts) != 8 * dim or len(rid) != 4 * dim:
                raise WireError("LWW tensor plane shape mismatch")
            if contribs:
                raise WireError("LWW tensor carries contributions")
        else:
            if val or ts or rid or not contribs:
                raise WireError("AVG tensor plane shape mismatch")
            for rid_k, (cts, vec) in contribs.items():
                if rid_k < 0 or len(vec) != want_val:
                    raise WireError("AVG tensor contribution shape mismatch")
                # varints admit ~2^77; the lattice is u64-stamped (the
                # SET path's parse_u64 bound) — an oversized ts would
                # otherwise be accepted, journaled, and re-broadcast,
                # then crash every drain that touches the u64 planes
                if cts > 0xFFFFFFFFFFFFFFFF:
                    raise WireError("AVG tensor contribution ts exceeds u64")
        t.mode, t.dim = mode, dim
        t.val, t.ts, t.rid = canon_f32(val), ts, rid
        t.contribs = {
            int(r): (int(cts), canon_f32(vec))
            for r, (cts, vec) in contribs.items()
        }
        return t

    def __eq__(self, other) -> bool:
        return isinstance(other, Tensor) and self.canon() == other.canon()

    def __hash__(self):
        return hash(self.canon())

    def __repr__(self) -> str:
        return f"Tensor{self.canon()!r}"


def _vec_dim(raw: bytes) -> int:
    if not raw or len(raw) % 4:
        raise ValueError(f"tensor payload must be k*4 bytes, got {len(raw)}")
    return len(raw) // 4
