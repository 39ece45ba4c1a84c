"""UJSON deltas as wire bytes: the path that builds no Python objects.

The port's copy of jylis_tpu/ops/ujson_wire.py:

* ``read_ujson`` -- the one Python reader of the wire shape
  (``delta/UJSON``: entries, vv, cloud); the codec oracle calls it.
* ``WireUJSON`` -- a lazy ``UJSON`` holding a delta's raw wire payload
  plus the counts and max seq the native splitter measured. It
  materialises the dict form only when something touches
  ``.entries``/``.ctx`` (the host-lattice paths); deltas bound for the
  card never do.
* ``split_push_ujson(body)`` -- one native pass over a PushDeltas body
  (src/ujson_planes.cpp) giving per-key payload spans and counts, with
  structure and utf-8 checked up front so a later materialisation
  cannot fail mid-serving.
* ``grid_from_wire(...)`` -- the resident store's grid encoder: native
  measure + fill straight from the concatenated payloads into the padded
  (rows, W) dot/pay/vv/cloud host planes that ops/ujson_resident.py
  folds on the card, replica ids interned against the store's columns
  inside the call and payloads interned by their canonical wire bytes.

tests/test_torch_native_codec.py holds the splitter and the grid encoder
against the Python reader and the object encoder.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils.wire import Reader, WireError
from .ujson_device import PAD32, PAD64
from .ujson_host import UJSON, CausalContext


def read_ujson(r: Reader) -> UJSON:
    """Parse one UJSON delta payload at the reader's position (the
    oracle wire shape: entries, vv, cloud)."""
    u = UJSON()
    for _ in range(r.varint()):
        rid, seq = r.varint(), r.varint()
        path = tuple(r.str_() for _ in range(r.varint()))
        u.entries[(rid, seq)] = (path, r.str_())
    u.ctx.vv = {r.varint(): r.varint() for _ in range(r.varint())}
    u.ctx.cloud = {(r.varint(), r.varint()) for _ in range(r.varint())}
    return u


class WireUJSON(UJSON):
    """A UJSON delta carried as its wire payload, materialised lazily.

    Everything that treats it as a document (host converge, render,
    equality) works through the ``entries``/``ctx`` properties; the
    resident drain recognises the type and consumes ``raw`` directly.
    Deltas are immutable in every consumer, so the measured counts stay
    exact whether or not materialisation ever happens.
    """

    __slots__ = ("raw", "n_entries", "n_vv", "n_cloud", "max_seq", "_mat")

    def __init__(
        self, raw: bytes, n_entries: int, n_vv: int, n_cloud: int, max_seq: int
    ):
        # deliberately NO placeholder entries/ctx: deltas are created in
        # bulk on the receive hot path, and the dict/context objects
        # would be 4 dead allocations per delta for the device-bound case
        self.raw = raw
        self.n_entries = n_entries
        self.n_vv = n_vv
        self.n_cloud = n_cloud
        self.max_seq = max_seq
        self._mat = False

    def _materialize(self) -> None:
        if self._mat:
            return
        r = Reader(self.raw)
        u = read_ujson(r)
        if not r.done():
            raise WireError("trailing bytes in UJSON payload")
        UJSON.entries.__set__(self, u.entries)
        UJSON.ctx.__set__(self, u.ctx)
        self._mat = True

    @property
    def entries(self):
        self._materialize()
        return UJSON.entries.__get__(self)

    @property
    def ctx(self):
        self._materialize()
        return UJSON.ctx.__get__(self)


# ---- native wrappers -------------------------------------------------------


def split_push_ujson(body: bytes) -> list[tuple[bytes, WireUJSON]] | None:
    """Split a PushDeltas body (past tag+name) into per-key WireUJSON
    deltas in ONE native pass, no per-entry Python work. Returns None
    when the bytes are outside the fast path's domain (malformed,
    varints past u64): the caller then takes the oracle, which decodes
    or raises properly."""
    from ..native import lib
    from ..native.codec import _ptr

    cdll = lib()
    n_keys = ctypes.c_int64()
    rc = cdll.jy_ujson_split_measure(body, len(body), ctypes.byref(n_keys))
    if rc != 0:
        return None
    nk = n_keys.value
    key_off = np.empty(nk, np.int64)
    key_len = np.empty(nk, np.int64)
    pay_off = np.empty(nk, np.int64)
    pay_len = np.empty(nk, np.int64)
    n_entries = np.empty(nk, np.int64)
    n_vv = np.empty(nk, np.int64)
    n_cloud = np.empty(nk, np.int64)
    max_seq = np.empty(nk, np.uint64)
    rc = cdll.jy_ujson_split(
        body, len(body), _ptr(key_off), _ptr(key_len), _ptr(pay_off),
        _ptr(pay_len), _ptr(n_entries), _ptr(n_vv), _ptr(n_cloud),
        _ptr(max_seq),
    )
    if rc != 0:
        return None
    ko, kl = key_off.tolist(), key_len.tolist()
    po, pl = pay_off.tolist(), pay_len.tolist()
    ne, nv, nc = n_entries.tolist(), n_vv.tolist(), n_cloud.tolist()
    ms = max_seq.tolist()
    return [
        (
            body[ko[k] : ko[k] + kl[k]],
            WireUJSON(body[po[k] : po[k] + pl[k]], ne[k], nv[k], nc[k], ms[k]),
        )
        for k in range(nk)
    ]


class GridOverflow(Exception):
    """The wire grid needs a layout the caller's shift can't hold."""


class GridRepBudget(Exception):
    """Replica columns exceeded the vv plane; grow n_rep and retry."""

    def __init__(self, needed: int):
        self.needed = needed


def grid_from_wire(
    deltas: list[WireUJSON],
    dest_rows: np.ndarray,
    rows: int,
    w: int,
    c: int,
    shift: int,
    n_rep: int,
    known_rids: list[int],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list[int], list[bytes]]:
    """Native wire->planes encode: fill padded (rows, w/c/n_rep) planes
    from raw delta payloads. Replica ids intern against known_rids
    (store columns, in column order); NEW rids get the next columns and
    are returned for the caller to merge. Payload ids in the returned
    pay plane are CALL-LOCAL; the caller remaps them through the
    returned canonical wire spans (see ResidentStore._encode_grid_wire).

    Raises GridOverflow (needs a wider shift) / GridRepBudget (needs a
    wider vv plane); both leave no visible state."""
    from ..native import lib
    from ..native.codec import _ptr

    cdll = lib()
    n = len(deltas)
    d_off = np.empty(n, np.int64)
    d_len = np.empty(n, np.int64)
    pos = 0
    parts = []
    for i, d in enumerate(deltas):
        raw = d.raw
        d_off[i] = pos
        d_len[i] = len(raw)
        pos += len(raw)
        parts.append(raw)
    blob = b"".join(parts)
    dtype = np.int32 if shift < 32 else np.uint64
    pad = PAD32 if shift < 32 else PAD64
    dots = np.full((rows, w), pad, dtype)
    pay = np.full((rows, w), -1, np.int32)
    vv = np.zeros((rows, n_rep), np.uint32)
    cloud = np.full((rows, c), pad, dtype)
    known = np.asarray(known_rids, np.uint64)
    total_ent = int(sum(d.n_entries for d in deltas))
    # every rid occurrence can be distinct: entries + vv + cloud all intern
    rid_cap = (
        len(known) + total_ent
        + int(sum(d.n_vv + d.n_cloud for d in deltas)) + 64
    )
    new_rids = np.empty(rid_cap, np.uint64)
    pay_span_off = np.empty(max(total_ent, 1), np.int64)
    pay_span_len = np.empty(max(total_ent, 1), np.int64)
    n_new = ctypes.c_int64()
    n_pays = ctypes.c_int64()
    rids_seen = ctypes.c_int64()
    rc = cdll.jy_ujson_grid_fill(
        blob, n, _ptr(d_off), _ptr(d_len), _ptr(dest_rows),
        ctypes.c_int32(shift), w, c, n_rep,
        _ptr(known), len(known),
        _ptr(dots), _ptr(pay), _ptr(vv), _ptr(cloud),
        _ptr(new_rids), ctypes.byref(n_new),
        _ptr(pay_span_off), _ptr(pay_span_len), ctypes.byref(n_pays),
        ctypes.byref(rids_seen),
    )
    if rc == -2:
        raise GridOverflow()
    if rc == -3:
        raise GridRepBudget(rids_seen.value)
    if rc != 0:
        raise WireError("malformed UJSON wire payload in grid encode")
    spans = [
        blob[int(pay_span_off[i]) : int(pay_span_off[i]) + int(pay_span_len[i])]
        for i in range(n_pays.value)
    ]
    return dots, pay, vv, cloud, new_rids[: n_new.value].tolist(), spans
