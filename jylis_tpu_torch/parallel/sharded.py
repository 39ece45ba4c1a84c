"""Keys-sharded keyspaces: routed per-shard drains and the replica join.

The port of jylis_tpu/parallel/sharded.py. The JAX package shards each
plane ``P("keys", None)`` and runs one ``shard_map`` program over the
mesh; the port holds a keyspace as a ``Keyspace``: a list of per-shard
states, one per device of the mesh's keys axis (one part without a
mesh), each a contiguous block of ``rows_per_shard`` key rows with every
replica column resident (global row g lives in shard
``g // rows_per_shard`` at local row ``g % rows_per_shard``). A drain is
then one launch of the single-device kernel per shard, on that shard's
device and its current stream:

* **Routing** (host, numpy): ``route_batch`` / ``route_drain``
  coalesce duplicate keys (max-combine), bucket the rows per shard and
  pad every shard to one width with DISTINCT out-of-range pad rows, so
  each shard's index vector stays unique. Payloads stay u64 (the JAX
  package splits them into hi/lo u32 planes; its ``route_drain64`` is
  ``route_drain`` here).
* **Routed drains** (the JAX package's API): ``drain_sharded_g`` /
  ``_pn`` launch ``counter_drain_sparse<NP>`` per shard,
  ``drain_sharded_treg`` ``treg_drain_sparse``, ``drain_sharded_tlog``
  ``tlog_drain_sparse`` (the wide layout, trims fused). Each moves
  every shard's slice of the routed batch to its device first, then
  launches every shard, then reads the per-slot results back, so no
  shard waits on another's kernel. States update in place (JAX returns
  new arrays). Pad slots read back 0 (JAX clamps their gathers to row
  K-1); callers read live slots only (``slot_rows >= 0``). TLOG's
  repo drains through them.
* **Unrouted drains** (the counter and TREG repos' path):
  ``drain_unrouted_g`` / ``_pn`` / ``_treg`` take the repo's unique
  global rows as they are. The kernels take a card's shards as a table
  and find each slot's shard themselves (ops/staging.py), so a card
  holding every shard (one device, or a mesh on one card) needs no
  routing at all; over several cards one counting pass orders the slots
  by card. Per card: one staged host-to-device copy, one launch and one
  device-to-host copy, no pad slot; each result comes back at its
  slot's index. On a single device the same staged call takes the dense
  drains (``dense=True``, ``Keyspace.dense_plan``): the counters' kernel
  walks every row of the state through the keyspace's slot map.
* **Replica join**: ``join_replica_axis`` folds S stacked full states
  over the mesh's rep axis with the hand-written ``replica_join`` kernel
  (csrc/replica_join.cu): an unsigned 64-bit max per column, which on
  the port's int64 layout is the JAX two-phase hi/lo u32 pmax in one.
  The kernel writes the one joined row; JAX's broadcast to every row is
  a zero-copy ``expand`` of it.

Every function returns host numpy arrays for what it reads back (the
repos consume them on the host at once).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..obs.registry import null_span
from ..ops import _build, gcount, planes, pncount, tlog, treg
from ..ops.staging import DensePlan, ShardTable, SlotMap, Stage, max_slots, split
from ..utils.batching import bucket, pad_rows

SIGN = planes.SIGN


# ---- placement -------------------------------------------------------------


def shard_plane(mesh, x) -> list[torch.Tensor]:
    """Split one (K, ...) plane into contiguous row blocks, block i a copy
    on the mesh's keys device i. K must divide evenly by the keys axis
    (pad capacity with the lattice identity first). A u64 ndarray becomes
    int64 bits."""
    if isinstance(x, np.ndarray):
        x = planes.to_tensor(x, "cpu") if x.dtype == np.uint64 else torch.from_numpy(x)
    devs = mesh.keys_devices
    k = x.shape[0]
    if k % len(devs):
        raise ValueError(f"{k} rows do not split over {len(devs)} key shards")
    rps = k // len(devs)
    return [x[i * rps:(i + 1) * rps].to(d, copy=True) for i, d in enumerate(devs)]


def shard_state(mesh, state) -> list:
    """A state NamedTuple of (K, ...) planes (counter, TREG and TLOG
    states, a UJSON DocBatch; None planes stay None) -> one state of the
    same type per key shard."""
    n = len(mesh.keys_devices)
    cols = [[None] * n if p is None else shard_plane(mesh, p) for p in state]
    return [type(state)(*parts) for parts in zip(*cols)]


def gather_state(shards, device=None):
    """The per-shard states joined back into one state on ``device``
    (default: the first shard's device)."""
    first = shard_device(shards[0])
    dev = first if device is None else torch.device(device)
    return type(shards[0])(*(
        None if p0 is None else torch.cat([s[i].to(dev) for s in shards])
        for i, p0 in enumerate(shards[0])
    ))


def shard_device(state) -> torch.device:
    """The device of a (per-shard) state: that of its first plane."""
    return next(p for p in state if p is not None).device


class Keyspace:
    """A keyspace's device state as one part per keys shard: the mesh's
    keys devices, or the one ``device`` without a mesh (one part, held as
    is). Owns the layout every repo shares: capacity rounded to the shard
    count, contiguous blocks of ``rows_per_shard`` rows, growth by
    gather-grow-resplit (the rows per shard change with the capacity, so
    a block cannot grow in place), and global row -> (part, local row).

    For the unrouted drains it also groups the shards by card: each run
    of consecutive shards on one device is a card, with one ``Stage``
    (its staging buffers, kept for the keyspace's life) and one
    ``ShardTable`` (rebuilt whenever ``parts`` is replaced)."""

    def __init__(self, mesh, device):
        self.mesh = mesh
        self.devices = [torch.device(device)] if mesh is None else mesh.keys_devices
        self.cards: list[tuple[int, int]] = []  # (first shard, shards)
        for i, d in enumerate(self.devices):
            if self.cards and self.devices[self.cards[-1][0]] == d:
                self.cards[-1] = (self.cards[-1][0], self.cards[-1][1] + 1)
            else:
                self.cards.append((i, 1))
        self.card_of = np.repeat(np.arange(len(self.cards)), [n for _, n in self.cards])
        self.stages = [Stage(self.devices[f]) for f, _ in self.cards]
        self.slots: SlotMap | None = None  # the counter dense drains' map (one device)
        self.parts = None

    @property
    def parts(self) -> list | None:
        return self._parts

    @parts.setter
    def parts(self, parts) -> None:
        self._parts = parts
        self._tables = None
        self._plan = None

    def dense_plan(self) -> DensePlan:
        """The single device's ``DensePlan`` over the current part, for a
        counter state with the keyspace's slot map (allocated at -1 on the
        first dense drain, replaced by ``grow``); rebuilt whenever
        ``parts`` is replaced."""
        if self.mesh is not None:
            raise ValueError("the dense drains run on a single device, not a mesh")
        if self._plan is None:
            state = self.parts[0]
            if self.slots is None and not isinstance(state, treg.TRegState):
                self.slots = SlotMap(self.key_cap, shard_device(state))
            self._plan = DensePlan(state, self.slots)
        return self._plan

    def tables(self) -> list[ShardTable]:
        """One ShardTable per card, over the current parts."""
        if self._tables is None:
            rps = self.rows_per_shard
            self._tables = [ShardTable(self.parts[f:f + n], rps, f) for f, n in self.cards]
        return self._tables

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def rows_per_shard(self) -> int:
        return next(p for p in self.parts[0] if p is not None).shape[0]

    @property
    def key_cap(self) -> int:
        """Rows over every part (0 before the first ``init``)."""
        return self.n_shards * self.rows_per_shard if self.parts else 0

    def round_cap(self, k: int) -> int:
        """``k`` rounded up to a multiple of the shard count."""
        return -(-k // self.n_shards) * self.n_shards

    def init(self, key_cap: int, make) -> None:
        """Fresh parts: ``make(rows, device)`` for each shard's block of
        ``round_cap(key_cap)`` rows."""
        rows = self.round_cap(key_cap) // self.n_shards
        self.parts = [make(rows, d) for d in self.devices]

    def whole(self):
        """The state as one NamedTuple: the one part itself, or the parts
        gathered on the first device (a copy, for reading)."""
        return self.parts[0] if self.mesh is None else gather_state(self.parts)

    def place(self, state) -> None:
        """Make the whole ``state`` the keyspace: one part, or split over
        the shards (its row count must divide by them)."""
        self.parts = [state] if self.mesh is None else shard_state(self.mesh, state)

    def grow(self, fn) -> None:
        """Apply a whole-state transform that changes the capacity. The
        slot map, clean between drains, is replaced by a clean one of the
        new capacity."""
        self.place(fn(self.whole()))
        if self.slots is not None and self.slots.map.shape[0] != self.key_cap:
            self.slots = SlotMap(self.key_cap, shard_device(self.parts[0]))

    def map(self, fn) -> None:
        """Apply a row-wise transform to every part."""
        self.parts = [fn(p) for p in self.parts]

    def set_plane(self, name: str, host: np.ndarray) -> None:
        """Replace one plane of every part with its block of the whole
        (K, ...) host array."""
        rps = self.rows_per_shard
        self.parts = [
            p._replace(**{name: torch.from_numpy(host[i * rps:(i + 1) * rps]).to(d)})
            for i, (p, d) in enumerate(zip(self.parts, self.devices))
        ]

    def locate(self, row: int):
        """(part, local row) holding global ``row``."""
        shard, local = divmod(row, self.rows_per_shard)
        return self.parts[shard], local

    def split_rows(self, rows: np.ndarray):
        """(part, positions in ``rows``, local rows) for every part that
        holds some of the global ``rows`` (``ops.staging.split``)."""
        for i, sel, local in split(rows, self.rows_per_shard, 0, self.n_shards):
            yield self.parts[i], sel, local

    def route(self, rows, payload):
        """`route_drain` of a batch over this keyspace's shards."""
        return route_drain(np.asarray(rows, np.int64), payload, self.n_shards,
                           self.rows_per_shard)


# ---- routing (host) ------------------------------------------------------------


def _route(key_idx, deltas, n_shards: int, rows_per_shard: int, bucket_width=False):
    """Shared routing core: coalesce, bucket per shard, pad to a common
    width. Returns (local_rows, payload, slot_rows) where slot_rows maps
    each flattened slot back to its GLOBAL key row (-1 for pad slots).
    With bucket_width the width is padded to a power of two (>= 8)."""
    key_idx, deltas = planes.coalesce(key_idx, deltas)
    shard_of = key_idx // rows_per_shard
    order = np.argsort(shard_of, kind="stable")
    counts = np.bincount(shard_of, minlength=n_shards)
    width = max(int(counts.max()) if len(key_idx) else 0, 1)
    if bucket_width:
        width = bucket(width, 8)
    # distinct out-of-range pads per shard: each shard's index vector
    # stays unique, which the sparse kernels rely on
    local_rows = np.broadcast_to(pad_rows(width), (n_shards, width)).copy()
    local_deltas = np.zeros((n_shards, width, deltas.shape[-1]), np.uint64)
    slot_rows = np.full((n_shards, width), -1, np.int64)
    start = 0
    for s in range(n_shards):
        c = int(counts[s])
        sel = order[start : start + c]
        local_rows[s, :c] = key_idx[sel] % rows_per_shard
        local_deltas[s, :c] = deltas[sel]
        slot_rows[s, :c] = key_idx[sel]
        start += c
    return (
        local_rows.reshape(n_shards * width),
        local_deltas.reshape(n_shards * width, deltas.shape[-1]),
        slot_rows.reshape(n_shards * width),
    )


def route_batch(key_idx, deltas, n_shards: int, rows_per_shard: int):
    """Global (B,) rows + (B, R) u64 deltas -> ((n_shards * W,) int32
    local rows, (n_shards * W, R) u64 deltas), shard s owning slots
    [s * W, (s + 1) * W); W is the widest shard's load. Duplicate keys
    are max-combined; pad slots carry distinct rows >= rows_per_shard."""
    local_rows, payload, _ = _route(key_idx, deltas, n_shards, rows_per_shard)
    return local_rows, payload


def route_drain(key_idx, deltas, n_shards: int, rows_per_shard: int):
    """Serving-path routing: like `route_batch`, with the per-shard width
    bucketed to a power of two and the slot -> global-row map (-1 at pad
    slots) returned, for the host caches the drains refresh."""
    return _route(key_idx, deltas, n_shards, rows_per_shard, bucket_width=True)


# ---- per-shard launches ---------------------------------------------------------


def _to(x: np.ndarray, dev) -> torch.Tensor:
    """Host array -> tensor on ``dev`` (u64 as int64 bits)."""
    if x.dtype == np.uint64:
        return planes.to_tensor(x, dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _per_shard(shards, cols, step):
    """Split each routed host column into the shards' equal slices, move
    every slice to its shard's device, THEN launch ``step(state, *slices)``
    on every shard, THEN read the outputs back: one (n_shards * W,) host
    array per output, in slot order."""
    n = len(shards)
    ins = [
        [_to(c, shard_device(st)) for c in parts]
        for st, parts in zip(shards, zip(*(np.split(c, n) for c in cols)))
    ]
    outs = [step(st, *x) for st, x in zip(shards, ins)]
    if not isinstance(outs[0], tuple):
        outs = [(o,) for o in outs]
    return tuple(np.concatenate([o.cpu().numpy() for o in parts]) for parts in zip(*outs))


def converge_sharded(mesh, blocks, local_rows, deltas):
    """One anti-entropy merge step over the mesh: each shard joins its
    routed slice of (n_shards * W, R) u64 ``deltas`` into its (K/n, R)
    int64 block, in place (``counter_drain_sparse<1>`` per shard; the
    sums go unread). Returns ``blocks``."""
    _per_shard([gcount.GCountState(b) for b in blocks], (local_rows, deltas),
               gcount.drain_sparse)
    return blocks


def read_all_sharded(mesh, blocks) -> np.ndarray:
    """Every row's wrapping u64 sum, as int64 bits, for the whole
    keyspace (plain torch per shard)."""
    return np.concatenate([planes.rowsum64(b).cpu().numpy() for b in blocks])


def drain_sharded_g(mesh, shards, local_rows, deltas) -> np.ndarray:
    """GCOUNT sharded drain: join the routed (n_shards * W, R) u64 batch
    into each shard's GCountState in place; returns the per-slot row sums
    (int64 bits of the u64; 0 at pad slots)."""
    return _per_shard(shards, (local_rows, deltas), gcount.drain_sparse)[0]


def drain_sharded_pn(mesh, shards, local_rows, deltas) -> np.ndarray:
    """PNCOUNT sharded drain: the deltas arrive polarity-stacked
    (n_shards * W, 2R), P columns first; both polarities join in one
    launch per shard. Returns the per-slot net values sum(P) - sum(N)
    (int64; 0 at pad slots)."""
    r = deltas.shape[1] // 2
    return _per_shard(
        shards, (local_rows, deltas[:, :r], deltas[:, r:]), pncount.drain_sparse
    )[0]


def drain_sharded_treg(mesh, shards, local_rows, payload):
    """TREG sharded drain: ``payload`` is (n_shards * W, 3) u64 columns
    [ts, rank, vid] per slot; LWW-join into each shard's TRegState in
    place. Returns per-slot (tie bool, ts int64 bits, vid int32) after
    the join (0 at pad slots)."""
    payload = np.ascontiguousarray(payload, np.uint64)
    bits = payload.view(np.int64)
    return _per_shard(
        shards,
        (local_rows, bits[:, 0], bits[:, 1], payload[:, 2].astype(np.int32)),
        treg.drain_sparse,
    )


def _patch(state, ki, vids):
    live = planes.live_rows(ki, state.vid.shape[0])
    state.vid[ki[live].long()] = vids[live]
    return vids


def patch_sharded_treg(mesh, shards, local_rows, patch_vid) -> None:
    """Host-resolved prefix-rank ties scatter their winning vids back into
    each shard's vid plane (plain torch, as the single-device repo's
    patch); pad slots drop."""
    _per_shard(shards, (local_rows, np.asarray(patch_vid, np.int32)), _patch)


def drain_sharded_tlog(mesh, shards, local_rows, payload, ld: int):
    """TLOG sharded drain + fused per-row trim over the wide layout:
    ``payload`` is (n_shards * W, 2 * ld + 2) u64 columns
    [ts(ld) | vid(ld) | cutoff | count], vids of empty slots all ones (-1
    as int64). ``tlog_drain_sparse`` per shard, in place; a row flagged
    as overflow is left untouched (the caller grows and drains again).
    Returns per-slot (overflow, length, cutoff int64 bits)."""
    bits = np.ascontiguousarray(payload, np.uint64).view(np.int64)
    return _per_shard(
        shards,
        (local_rows, bits[:, :ld], bits[:, ld : 2 * ld], bits[:, 2 * ld],
         bits[:, 2 * ld + 1]),
        tlog.drain_sparse,
    )


# ---- unrouted drains: one staged call per card -----------------------------------


def _bits(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.int64) if x.dtype == np.uint64 else x)


def fill_from(*arrays):
    """A ``fill`` for the unrouted drains that copies host arrays, one per
    batch field in slot order, into the staged views (a field of 1 MiB
    or more through torch's copy, which spreads it over the CPU
    threads)."""
    def fill(views, sel):
        for view, a in zip(views, arrays):
            src = a[sel]
            if src.nbytes >= 1 << 20 and src.dtype == view.dtype:
                _bits(view).copy_(_bits(src))
            else:
                view[...] = src
    return fill


def _by_card(ks: Keyspace, rows: np.ndarray):
    """The slots of each card, as positions in ``rows``: all of them when
    one card holds every shard (no routing at all), else one counting
    pass, a stable order by card and nothing padded."""
    if len(ks.cards) == 1:
        return [slice(None)]
    card = ks.card_of[rows // ks.rows_per_shard]
    order = np.argsort(card, kind="stable")
    return np.split(order, np.cumsum(np.bincount(card, minlength=len(ks.cards)))[:-1])


def _drain_unrouted(ks: Keyspace, rows, fill, ins, outs, step, dense=False,
                    reg=None, name=""):
    """Stage, launch and read back a drain of the UNIQUE global ``rows``
    on every card that holds some of them, each card's copies and launch
    queued before the host waits on any (in rounds of at most
    ``max_slots`` slots a card when the batch overflows the staging).
    ``fill(views, sel)`` writes the batch fields ``ins`` ((dtype, row
    shape) each) of the slots ``sel`` (positions in ``rows``: an index
    array or a slice) into the staged numpy views, in that order;
    ``step(table, rows, *fields, out)`` launches the kernel (or runs the
    plain version on a CPU card) and writes ``outs`` into ``out``. With
    ``dense`` (a single device only) ``step`` takes the keyspace's
    ``DensePlan`` in place of the table: each staged call is one dense
    drain. Returns one host array per output, in slot order.

    With a registry ``reg``, each card's staged call of a round is timed
    as the ``drain.<name>.fill`` (the row and field writes), ``.launch``
    (copy up, kernel, copy down: enqueued only) and ``.wait`` (until the
    copy down has landed) spans, each with the call's slots as items."""
    rows = np.asarray(rows, np.int64)
    n = len(rows)
    if n and (rows.min() < 0 or rows.max() >= ks.key_cap):
        raise ValueError(f"rows must lie in [0, {ks.key_cap})")
    span = null_span if reg is None else reg.span
    fill_span, launch_span, wait_span = (f"drain.{name}.{p}" for p in ("fill", "launch", "wait"))
    fields = ((np.int32, ()), *ins)
    width = max_slots(fields)
    if dense:
        cards = [(ks.dense_plan(), ks.stages[0], slice(None))]
    else:
        cards = list(zip(ks.tables(), ks.stages, _by_card(ks, rows)))
    results = [np.empty(n, dt) for dt, _ in outs]
    # one round unless a card's slots overflow its staging: each round
    # waits before the next writes the same buffers
    for lo in range(0, n, width):
        queued = []
        for table, stage, sel in cards:
            sel = slice(lo, min(lo + width, n)) if isinstance(sel, slice) else sel[lo:lo + width]
            m = sel.stop - sel.start if isinstance(sel, slice) else len(sel)
            if m <= 0:
                continue
            with span(fill_span, m):
                views = stage.host_in(m, fields)
                views[0][...] = rows[sel]
                fill(views[1:], sel)
            with span(launch_span, m):
                ki, *batch = stage.upload()
                step(table, ki, *batch, stage.device_out(m, outs))
                stage.download()
            queued.append((stage, sel, m))
        for stage, sel, m in queued:
            with span(wait_span, m):
                for res, got in zip(results, stage.wait()):
                    res[sel] = got
    return results


def drain_unrouted_g(ks: Keyspace, rows, fill, step=None,
                     dense=False, reg=None) -> np.ndarray:
    """GCOUNT drain of the unique global ``rows`` over ``ks``: ``fill``
    writes each card's (m, R) u64 delta rows (see ``_drain_unrouted``;
    ``step`` defaults to gcount.drain_sparse, or with ``dense`` to
    gcount.drain_dense; ``reg`` times its phases). Returns the joined
    rows' sums in slot order (int64 bits of the u64)."""
    r = ks.parts[0].counts.shape[1]
    step = step or (gcount.drain_dense if dense else gcount.drain_sparse)
    return _drain_unrouted(ks, rows, fill, [(np.uint64, (r,))], [(np.int64, ())],
                           lambda t, ki, d, out: step(t, ki, d, out[0]), dense,
                           reg, "GCOUNT")[0]


def drain_unrouted_pn(ks: Keyspace, rows, fill, step=None,
                      dense=False, reg=None) -> np.ndarray:
    """PNCOUNT drain of the unique global ``rows`` over ``ks``: ``fill``
    writes each card's P and N (m, R) u64 delta rows (``dense`` and
    ``reg`` as for ``drain_unrouted_g``). Returns the joined rows' net
    values sum(P) - sum(N) in slot order (int64)."""
    r = ks.parts[0].p.shape[1]
    step = step or (pncount.drain_dense if dense else pncount.drain_sparse)
    return _drain_unrouted(ks, rows, fill, [(np.uint64, (r,))] * 2, [(np.int64, ())],
                           lambda t, ki, dp, dn, out: step(t, ki, dp, dn, out[0]),
                           dense, reg, "PNCOUNT")[0]


def drain_unrouted_treg(ks: Keyspace, rows, fill, step=None, dense=False, reg=None):
    """TREG drain of the unique global ``rows`` over ``ks``: ``fill``
    writes each card's ts, rank (u64) and vid (int32) fields (``dense``
    and ``reg`` as for ``drain_unrouted_g``). Returns (tie bool, ts int64
    bits, vid int32) per slot after the join."""
    step = step or (treg.drain_dense if dense else treg.drain_sparse)
    return tuple(_drain_unrouted(
        ks, rows, fill, [(np.uint64, ()), (np.uint64, ()), (np.int32, ())],
        [(np.bool_, ()), (np.int64, ()), (np.int32, ())],
        lambda t, ki, ts, rank, vid, out: step(t, ki, ts, rank, vid, tuple(out)), dense,
        reg, "TREG"))


# ---- the replica-axis join ------------------------------------------------------

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_JOIN_ARGS = [_P, _P, _LL, _LL, _P]


def replica_join_plain(stack: torch.Tensor) -> torch.Tensor:
    """(S, K) int64 bits -> (K,): the per-column unsigned u64 max over
    the S rows."""
    return (stack ^ SIGN).amax(0) ^ SIGN


def replica_join(stack: torch.Tensor) -> torch.Tensor:
    """`replica_join_plain` as one launch of csrc/replica_join.cu on a
    CUDA tensor (a CPU tensor runs the plain version)."""
    if stack.device.type == "cpu":
        return replica_join_plain(stack)
    if stack.dtype != torch.int64 or stack.dim() != 2 or not stack.is_contiguous():
        raise ValueError("replica_join: expected a contiguous (S, K) int64 tensor")
    s, k = stack.shape
    if s < 1 or k < 1:
        raise ValueError(f"replica_join: empty shape S={s} K={k}")
    dev = stack.device
    out = torch.empty(k, dtype=torch.int64, device=dev)
    fn = _build.function("replica_join", "jt_replica_join", _JOIN_ARGS)
    with torch.cuda.device(dev):
        rc = fn(stack.data_ptr(), out.data_ptr(), s, k,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "replica_join")
    _build.count(replica_join, dev)
    return out


_build.counter(replica_join)


def shard_grid(mesh, x) -> list[list[torch.Tensor]]:
    """(S, K) plane -> blocks[r][k] sharded ``P("rep", "keys")``: rows
    split over the rep axis, columns over the keys axis, block (r, k) a
    contiguous copy on ``mesh.devices[r, k]``."""
    if isinstance(x, np.ndarray):
        x = planes.to_tensor(x, "cpu")
    rep, nk = mesh.devices.shape
    s, k = x.shape
    if s % rep or k % nk:
        raise ValueError(f"({s}, {k}) does not split over the {rep} x {nk} mesh")
    sr, kc = s // rep, k // nk
    return [
        [x[r * sr:(r + 1) * sr, c * kc:(c + 1) * kc].to(mesh.devices[r, c], copy=True)
         for c in range(nk)]
        for r in range(rep)
    ]


def gather_grid(blocks) -> torch.Tensor:
    """blocks[r][k] -> the (S, K) plane on the first block's device."""
    dev = blocks[0][0].device
    return torch.cat([torch.cat([b.to(dev) for b in row], 1) for row in blocks], 0)


def join_replica_axis(mesh, blocks):
    """Lattice-join full states sharded over the rep axis.

    ``blocks[r][k]``: (S/rep, K/keys) int64 blocks as `shard_grid` lays
    them out, S per-replica u64 states. Returns blocks of the same shapes
    in which every row holds the converged state: each a zero-copy
    ``expand`` of the one joined row, as JAX's broadcast gives the
    (S, K) shape. With one rep row each block folds in one launch;
    otherwise every block first folds its own rows (all launched before
    any copy), then the folded rows of each keys column are copied to
    that column's rep-0 device, folded there, and the row copied back.
    Only a mesh whose rep rows sit on different devices makes those
    copies cross devices."""
    rep, nk = mesh.devices.shape
    if rep == 1:
        return [[replica_join(b).expand(b.shape[0], -1) for b in blocks[0]]]
    local = [[replica_join(b) for b in row] for row in blocks]
    out = [[None] * nk for _ in range(rep)]
    for c in range(nk):
        lead = local[0][c].device
        joined = replica_join(torch.stack([local[r][c].to(lead) for r in range(rep)]))
        for r in range(rep):
            b = blocks[r][c]
            out[r][c] = joined.to(b.device).expand(b.shape[0], -1)
    return out
