"""ctypes wrapper for the native MsgPushDeltas wire codec.

The port's copy of jylis_tpu/native/codec.py. ``encode_push(msg)`` /
``decode_push(body)`` return None whenever the input lies outside the
native path's domain -- values outside u64, payloads that are not
host-lattice shaped, a type it does not pack (TENSOR, MAP, BCOUNT),
malformed bytes (a decode result of -1 or -2) -- and the caller, the
port's cluster/codec.py, takes the pure-Python oracle for that one
message. For every input the native path accepts, its bytes equal the
oracle's (encode) and its batches compare equal to the oracle's
(decode); tests/test_torch_native_codec.py holds that, and holds both
against the JAX package's bytes.

The Python side makes one flattening pass over the delta objects; all
varint and byte work happens in one or two FFI calls over contiguous
buffers (src/cluster_codec.cpp). Decoded u64 values are Python ints in
[0, 2^64) (``tolist`` of the uint64 arrays).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..cluster.msg import Msg, MsgPushDeltas
from . import lib

_U64_MAX = (1 << 64) - 1

# name -> ndicts for the counter family
_COUNTER_NDICTS = {"GCOUNT": 1, "PNCOUNT": 2}


def _ptr(arr: np.ndarray):
    return ctypes.c_void_p(arr.ctypes.data)


def _u64_array(values) -> np.ndarray | None:
    """Values as u64, or None if any falls outside [0, 2^64).

    Validation rides numpy's own dtype inference instead of a per-item
    Python isinstance/range scan (which dominated the whole encode): a
    list of in-range ints infers an integer dtype; anything else — a
    float, a bool, a negative mixed with >=2^63, an int past 2^64
    (object dtype) — infers a non-integer dtype and falls back to the
    oracle, which raises on genuinely invalid values rather than
    broadcasting a silently wrapped number to peers."""
    if not len(values):
        return np.empty(0, np.uint64)  # empty infers float64 below
    try:
        arr = np.asarray(values)
    except (OverflowError, TypeError, ValueError):
        return None
    if arr.dtype.kind == "u":
        return arr.astype(np.uint64, copy=False)
    if arr.dtype.kind == "i":
        if arr.size and int(arr.min()) < 0:
            return None
        return arr.astype(np.uint64)
    # mixed magnitudes (e.g. [1, 2**63]) infer float64 and ints past 2**64
    # infer object — exactly like genuine floats do, so only here pay the
    # per-item type scan, then let numpy's strict u64 conversion validate
    # the range (bools and floats fall back to the oracle)
    if all(type(v) is int and 0 <= v <= _U64_MAX for v in values):
        # explicit range check: numpy 1.x silently wraps out-of-range ints
        # on this conversion (pyproject now floors numpy>=2, but a wrapped
        # value broadcast to peers is bad enough to guard twice)
        try:
            return np.array(values, dtype=np.uint64)
        except (OverflowError, TypeError, ValueError):
            return None
    return None


def _key_blob(batch) -> tuple[bytes, np.ndarray, np.ndarray]:
    offs = np.empty(len(batch), np.int64)
    lens = np.empty(len(batch), np.int64)
    pos = 0
    parts = []
    for i, (key, _delta) in enumerate(batch):
        offs[i] = pos
        lens[i] = len(key)
        pos += len(key)
        parts.append(key)
    return b"".join(parts), offs, lens


# ---- encode ----------------------------------------------------------------


def encode_push(msg: MsgPushDeltas) -> bytes | None:
    cdll = lib()
    name = msg.name
    if name in _COUNTER_NDICTS:
        return _encode_counters(cdll, msg, _COUNTER_NDICTS[name])
    if name == "TREG":
        return _encode_treg(cdll, msg)
    if name in ("TLOG", "SYSTEM"):
        return _encode_tlog(cdll, msg)
    if name == "UJSON":
        return _encode_ujson(cdll, msg)
    return None  # unknown: oracle


def _encode_counters(cdll, msg: MsgPushDeltas, ndicts: int) -> bytes | None:
    batch = msg.batch
    key_blob, key_off, key_len = _key_blob(batch)
    counts_l: list[int] = []
    rids: list[int] = []
    vals: list[int] = []
    # spans ship in dict-iteration order (keys()/values() extends are
    # C-speed); the native encoder sorts each span by rid on the wire —
    # the per-key sorted() this replaces dominated the whole encode
    for _key, delta in batch:
        dicts = (delta,) if ndicts == 1 else delta
        if len(dicts) != ndicts:
            return None
        for dct in dicts:
            counts_l.append(len(dct))
            rids.extend(dct.keys())
            vals.extend(dct.values())
    counts = np.asarray(counts_l, np.int64)
    rid_arr = _u64_array(rids)
    val_arr = _u64_array(vals)
    if rid_arr is None or val_arr is None:
        return None
    name_b = msg.name.encode()
    cap = (
        16 + len(name_b) + len(key_blob)
        + len(batch) * (10 + 10 * ndicts) + 20 * len(rids)
    )
    out = np.empty(cap, np.uint8)
    n = cdll.jy_push_counters_encode(
        name_b, len(name_b), len(batch),
        key_blob, _ptr(key_off), _ptr(key_len),
        ndicts, _ptr(counts), _ptr(rid_arr), _ptr(val_arr),
        _ptr(out), cap,
    )
    return out[:n].tobytes() if n >= 0 else None


def _encode_treg(cdll, msg: MsgPushDeltas) -> bytes | None:
    batch = msg.batch
    key_blob, key_off, key_len = _key_blob(batch)
    val_off = np.empty(len(batch), np.int64)
    val_len = np.empty(len(batch), np.int64)
    ts_list = []
    pos = 0
    parts = []
    for i, (_key, delta) in enumerate(batch):
        value, ts = delta
        val_off[i] = pos
        val_len[i] = len(value)
        pos += len(value)
        parts.append(value)
        ts_list.append(ts)
    ts_arr = _u64_array(ts_list)
    if ts_arr is None:
        return None
    val_blob = b"".join(parts)
    name_b = msg.name.encode()
    cap = 16 + len(name_b) + len(key_blob) + len(val_blob) + 30 * len(batch)
    out = np.empty(cap, np.uint8)
    n = cdll.jy_push_treg_encode(
        name_b, len(name_b), len(batch),
        key_blob, _ptr(key_off), _ptr(key_len),
        val_blob, _ptr(val_off), _ptr(val_len), _ptr(ts_arr),
        _ptr(out), cap,
    )
    return out[:n].tobytes() if n >= 0 else None


def _encode_tlog(cdll, msg: MsgPushDeltas) -> bytes | None:
    batch = msg.batch
    key_blob, key_off, key_len = _key_blob(batch)
    entry_counts = np.empty(len(batch), np.int64)
    cut_list = []
    ts_list: list[int] = []
    ent_parts: list[bytes] = []
    for i, (_key, delta) in enumerate(batch):
        entries, cutoff = delta
        entry_counts[i] = len(entries)
        cut_list.append(cutoff)
        for value, ts in entries:
            ent_parts.append(value)
            ts_list.append(ts)
    ts_arr = _u64_array(ts_list)
    cut_arr = _u64_array(cut_list)
    if ts_arr is None or cut_arr is None:
        return None
    ent_off = np.empty(len(ent_parts), np.int64)
    ent_len = np.empty(len(ent_parts), np.int64)
    pos = 0
    for i, part in enumerate(ent_parts):
        ent_off[i] = pos
        ent_len[i] = len(part)
        pos += len(part)
    ent_blob = b"".join(ent_parts)
    name_b = msg.name.encode()
    cap = (
        16 + len(name_b) + len(key_blob) + len(ent_blob)
        + 30 * len(batch) + 20 * len(ent_parts)
    )
    out = np.empty(cap, np.uint8)
    n = cdll.jy_push_tlog_encode(
        name_b, len(name_b), len(batch),
        key_blob, _ptr(key_off), _ptr(key_len),
        _ptr(entry_counts),
        ent_blob, _ptr(ent_off), _ptr(ent_len), _ptr(ts_arr),
        _ptr(cut_arr), _ptr(out), cap,
    )
    return out[:n].tobytes() if n >= 0 else None


def _encode_ujson(cdll, msg: MsgPushDeltas) -> bytes | None:
    """Flatten UJSON deltas in oracle order (entries by dot, vv by rid,
    cloud sorted; strings = path parts then token per entry) and varint-
    pack the whole batch in one FFI call."""
    batch = msg.batch
    key_blob, key_off, key_len = _key_blob(batch)
    counts = np.empty(len(batch) * 3, np.int64)
    ent_rid: list[int] = []
    ent_seq: list[int] = []
    path_counts: list[int] = []
    str_parts: list[bytes] = []
    vv_rid: list[int] = []
    vv_val: list[int] = []
    cl_rid: list[int] = []
    cl_seq: list[int] = []
    try:
        for i, (_key, u) in enumerate(batch):
            entries = u.entries
            counts[i * 3] = len(entries)
            for dot in sorted(entries):
                rid, seq = dot
                path, token = entries[dot]
                ent_rid.append(rid)
                ent_seq.append(seq)
                path_counts.append(len(path))
                for part in path:
                    str_parts.append(part.encode())
                str_parts.append(token.encode())
            vv = u.ctx.vv
            counts[i * 3 + 1] = len(vv)
            for rid in sorted(vv):
                vv_rid.append(rid)
                vv_val.append(vv[rid])
            cloud = sorted(u.ctx.cloud)
            counts[i * 3 + 2] = len(cloud)
            for rid, seq in cloud:
                cl_rid.append(rid)
                cl_seq.append(seq)
    except (AttributeError, TypeError):
        return None  # not host-lattice-shaped: oracle decides
    arrs = [
        _u64_array(ent_rid), _u64_array(ent_seq), _u64_array(vv_rid),
        _u64_array(vv_val), _u64_array(cl_rid), _u64_array(cl_seq),
    ]
    if any(a is None for a in arrs):
        return None
    er, es, vr, vvv, cr, cs = arrs
    pc = np.asarray(path_counts, np.int64) if path_counts else np.empty(0, np.int64)
    str_off = np.empty(len(str_parts), np.int64)
    str_len = np.empty(len(str_parts), np.int64)
    pos = 0
    for i, part in enumerate(str_parts):
        str_off[i] = pos
        str_len[i] = len(part)
        pos += len(part)
    str_blob = b"".join(str_parts)
    name_b = msg.name.encode()
    cap = (
        16 + len(name_b) + len(key_blob) + len(str_blob)
        + 40 * len(batch) + 30 * len(ent_rid) + 10 * len(str_parts)
        + 20 * (len(vv_rid) + len(cl_rid))
    )
    out = np.empty(cap, np.uint8)
    n = cdll.jy_push_ujson_encode(
        name_b, len(name_b), len(batch),
        key_blob, _ptr(key_off), _ptr(key_len),
        _ptr(counts), _ptr(er), _ptr(es), _ptr(pc),
        str_blob, _ptr(str_off), _ptr(str_len),
        _ptr(vr), _ptr(vvv), _ptr(cr), _ptr(cs),
        _ptr(out), cap,
    )
    return out[:n].tobytes() if n >= 0 else None


# ---- decode ----------------------------------------------------------------


def _read_header(body: bytes) -> tuple[str, int] | None:
    """Parse tag + name; return (name, offset-past-name) or None."""
    if not body or body[0] != 3:
        return None
    pos, shift, n = 1, 0, 0
    while True:
        if pos >= len(body) or shift > 70:
            return None
        b = body[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if pos + n > len(body):
        return None
    try:
        name = body[pos : pos + n].decode()
    except UnicodeDecodeError:
        return None
    return name, pos + n


def decode_push(body: bytes) -> Msg | None:
    cdll = lib()
    header = _read_header(body)
    if header is None:
        return None
    name, off = header
    rest = body[off:]
    if name in _COUNTER_NDICTS:
        return _decode_counters(cdll, name, rest, _COUNTER_NDICTS[name])
    if name == "TREG":
        return _decode_treg(cdll, name, rest)
    if name in ("TLOG", "SYSTEM"):
        return _decode_tlog(cdll, name, rest)
    if name == "UJSON":
        return _decode_ujson(cdll, name, rest)
    return None


class LazyU64Map:
    """A counter delta ({rid: u64}) decoded lazily from the wire arrays —
    the counter analog of ops/ujson_wire.WireUJSON: the wire decode
    banks list slices in O(1) per key and the dict materialises only
    when a consumer (converge's .items(), re-encode, equality) actually
    walks it. Compares equal to the real dict it denotes."""

    __slots__ = ("_rids", "_vals", "_lo", "_n", "_real")

    def __init__(self, rids, vals, lo, n):
        self._rids = rids
        self._vals = vals
        self._lo = lo
        self._n = n
        self._real = None

    def _mat(self) -> dict:
        real = self._real
        if real is None:
            lo = self._lo
            real = self._real = dict(
                zip(self._rids[lo : lo + self._n], self._vals[lo : lo + self._n])
            )
        return real

    def __eq__(self, other):
        if isinstance(other, LazyU64Map):
            other = other._mat()
        return self._mat() == other

    __hash__ = None  # mutable-mapping semantics, like dict

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, k):
        return self._mat()[k]

    def __contains__(self, k) -> bool:
        return k in self._mat()

    def get(self, k, default=None):
        return self._mat().get(k, default)

    def items(self):
        return self._mat().items()

    def keys(self):
        return self._mat().keys()

    def values(self):
        return self._mat().values()

    def __repr__(self) -> str:
        return repr(self._mat())

    def wire(self):
        """(rids, vals, lo, (n,)): the decoded wire lists this map reads
        and its entries' span in them, for a converge that reads them in
        place (models/repo_counters.converge_batch)."""
        return self._rids, self._vals, self._lo, (self._n,)


class LazyPNPair:
    """A PNCOUNT delta ((p_dict, n_dict)) decoded lazily from the wire
    arrays: one banked object per key instead of two maps plus a tuple
    (decode cost at this batch scale is Python allocation). Compares
    equal to the real pair it denotes and unpacks like one."""

    __slots__ = ("_rids", "_vals", "_lo", "_np", "_nn", "_real")

    def __init__(self, rids, vals, lo, n_p, n_n):
        self._rids = rids
        self._vals = vals
        self._lo = lo
        self._np = n_p
        self._nn = n_n
        self._real = None

    def _mat(self) -> tuple:
        real = self._real
        if real is None:
            lo, mid = self._lo, self._lo + self._np
            real = self._real = (
                dict(zip(self._rids[lo:mid], self._vals[lo:mid])),
                dict(
                    zip(
                        self._rids[mid : mid + self._nn],
                        self._vals[mid : mid + self._nn],
                    )
                ),
            )
        return real

    def __eq__(self, other):
        if isinstance(other, LazyPNPair):
            other = other._mat()
        return self._mat() == other

    __hash__ = None

    def __len__(self) -> int:
        return 2

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]

    def __repr__(self) -> str:
        return repr(self._mat())

    def wire(self):
        """(rids, vals, lo, (n_p, n_n)): the decoded wire lists, and the
        P entries then the N entries from ``lo`` on (``LazyU64Map.wire``)."""
        return self._rids, self._vals, self._lo, (self._np, self._nn)


def _decode_counters(cdll, name, rest, ndicts) -> Msg | None:
    n_keys = ctypes.c_int64()
    total = ctypes.c_int64()
    rc = cdll.jy_push_counters_measure(
        rest, len(rest), ndicts, ctypes.byref(n_keys), ctypes.byref(total)
    )
    if rc != 0:
        return None
    nk, ne = n_keys.value, total.value
    key_off = np.empty(nk, np.int64)
    key_len = np.empty(nk, np.int64)
    counts = np.empty(nk * ndicts, np.int64)
    rids = np.empty(ne, np.uint64)
    vals = np.empty(ne, np.uint64)
    rc = cdll.jy_push_counters_decode(
        rest, len(rest), ndicts,
        _ptr(key_off), _ptr(key_len), _ptr(counts), _ptr(rids), _ptr(vals),
    )
    if rc != 0:
        return None
    rid_l = rids.tolist()
    val_l = vals.tolist()
    ko = key_off.tolist()
    kl = key_len.tolist()
    cl = counts.tolist()
    batch = []
    e = 0
    if ndicts == 1:
        for k in range(nk):
            c = cl[k]
            batch.append(
                (rest[ko[k] : ko[k] + kl[k]], LazyU64Map(rid_l, val_l, e, c))
            )
            e += c
    else:
        for k in range(nk):
            cp = cl[2 * k]
            cn = cl[2 * k + 1]
            batch.append(
                (
                    rest[ko[k] : ko[k] + kl[k]],
                    LazyPNPair(rid_l, val_l, e, cp, cn),
                )
            )
            e += cp + cn
    return MsgPushDeltas(name, tuple(batch))


def _decode_treg(cdll, name, rest) -> Msg | None:
    n_keys = ctypes.c_int64()
    rc = cdll.jy_push_treg_measure(rest, len(rest), ctypes.byref(n_keys))
    if rc != 0:
        return None
    nk = n_keys.value
    key_off = np.empty(nk, np.int64)
    key_len = np.empty(nk, np.int64)
    val_off = np.empty(nk, np.int64)
    val_len = np.empty(nk, np.int64)
    ts = np.empty(nk, np.uint64)
    rc = cdll.jy_push_treg_decode(
        rest, len(rest),
        _ptr(key_off), _ptr(key_len), _ptr(val_off), _ptr(val_len), _ptr(ts),
    )
    if rc != 0:
        return None
    ko, kl = key_off.tolist(), key_len.tolist()
    vo, vl = val_off.tolist(), val_len.tolist()
    tl = ts.tolist()
    batch = tuple(
        (rest[ko[k] : ko[k] + kl[k]], (rest[vo[k] : vo[k] + vl[k]], tl[k]))
        for k in range(nk)
    )
    return MsgPushDeltas(name, batch)


def _decode_ujson(cdll, name, rest) -> Msg | None:
    """Lazy receive path: one native pass splits the body into per-key
    WireUJSON payload spans (structure + utf-8 validated up front);
    documents materialise only if a host-lattice path touches them.
    Device-bound deltas go wire->planes without ever becoming dicts
    (ops/ujson_wire.grid_from_wire)."""
    from ..ops.ujson_wire import split_push_ujson

    batch = split_push_ujson(rest)
    if batch is None:
        return None
    return MsgPushDeltas(name, tuple(batch))


def _decode_tlog(cdll, name, rest) -> Msg | None:
    n_keys = ctypes.c_int64()
    total = ctypes.c_int64()
    rc = cdll.jy_push_tlog_measure(
        rest, len(rest), ctypes.byref(n_keys), ctypes.byref(total)
    )
    if rc != 0:
        return None
    nk, ne = n_keys.value, total.value
    key_off = np.empty(nk, np.int64)
    key_len = np.empty(nk, np.int64)
    entry_counts = np.empty(nk, np.int64)
    ent_off = np.empty(ne, np.int64)
    ent_len = np.empty(ne, np.int64)
    ent_ts = np.empty(ne, np.uint64)
    cutoffs = np.empty(nk, np.uint64)
    rc = cdll.jy_push_tlog_decode(
        rest, len(rest),
        _ptr(key_off), _ptr(key_len), _ptr(entry_counts),
        _ptr(ent_off), _ptr(ent_len), _ptr(ent_ts), _ptr(cutoffs),
    )
    if rc != 0:
        return None
    ko, kl = key_off.tolist(), key_len.tolist()
    cnt = entry_counts.tolist()
    eo, el = ent_off.tolist(), ent_len.tolist()
    et = ent_ts.tolist()
    cut = cutoffs.tolist()
    batch = []
    e = 0
    for k in range(nk):
        entries = [
            (rest[eo[i] : eo[i] + el[i]], et[i]) for i in range(e, e + cnt[k])
        ]
        e += cnt[k]
        batch.append((rest[ko[k] : ko[k] + kl[k]], (entries, cut[k])))
    return MsgPushDeltas(name, tuple(batch))
