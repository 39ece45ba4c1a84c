"""The staged call of the sparse drains: shard tables and pinned staging.

The sparse drain kernels (``counter_drain_sparse<NP>``,
``treg_drain_sparse``) take the shards of a keyspace that live on one
card as a ``ShardTable`` and an UNROUTED batch of global rows: the
kernel finds each slot's shard itself and writes each result at the
slot's own index. A single device is the table of one shard of K rows.

A ``Stage`` is one card's staging memory, owned by the keyspace of one
repo: a pinned host buffer the repo writes the batch into (numpy views,
no intermediate arrays), a device buffer it is copied to, a device
buffer the kernel writes its outputs into, packed, and a pinned host
buffer they come back to. A drain then makes, per card, one
host-to-device copy, one launch and one device-to-host copy, and
synchronises once before the host reads the results. Each buffer grows
by powers of two, up to ``MAX_STAGE_BYTES``, and is reused across
drains. A drain larger than that (a full sync of a wide keyspace) is
cut into staged calls of at most ``max_slots`` slots each, so one
repo's staging holds at most that much pinned host memory and as much
on the card, whatever the drain. Reuse is safe: every staged call
synchronises before its buffers are written again, and drains run
under the repo's lock, so no copy of an earlier call is in flight when
the next one writes a buffer.

On a CPU "card" the staged buffer already is the batch: nothing is
copied and the plain versions run on the views as they are, but the
steps are the same ones, and ``Stage.uploads`` / ``Stage.downloads``
count them the same way on either device.

The dense drains (``counter_drain_dense<NP>``, ``treg_drain_dense``) take
the same staged batch on a single device, with the state's
``DensePlan``; the counters' holds the keyspace's ``SlotMap``, which the
kernel walks over every row of the state, joining a row's staged delta
where the map holds its slot.

Every region of a layout starts at a 16-byte aligned offset, which the
counter kernels' 16-byte vector loads need.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.batching import bucket

ALIGN = 16
MAX_SHARDS = 8  # shards one card's table holds (the kernels' kMaxShards)
# the most one staged call copies each way, and so the largest buffer a
# Stage keeps: PNCOUNT's 65,536 slots of 2 x 64 columns (64.3 MiB) fit
MAX_STAGE_BYTES = 128 << 20
_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.uint64): torch.int64, np.dtype(np.bool_): torch.bool}


def layout(b: int, fields):
    """(byte offset, bytes, shape) of each of ``fields`` ((dtype, row
    shape) each) for ``b`` rows, each region 16-byte aligned, and the
    total bytes."""
    regions, at = [], 0
    for dt, shape in fields:
        n = b * math.prod(shape) * np.dtype(dt).itemsize
        regions.append((at, n, (b, *shape)))
        at += -(-n // ALIGN) * ALIGN
    return regions, at


def max_slots(fields) -> int:
    """The most slots of ``fields`` one staged call takes: their layout
    stays within MAX_STAGE_BYTES."""
    per_slot = sum(math.prod(shape) * np.dtype(dt).itemsize for dt, shape in fields)
    return max(1, (MAX_STAGE_BYTES - ALIGN * len(fields)) // per_slot)


class ShardTable:
    """The shards of a keyspace that live on one card: ``parts`` (their
    states, in shard order), ``rows_per_shard`` and ``first``, the global
    index of ``parts[0]``. Global row g lives in shard
    ``g // rows_per_shard`` at local row ``g % rows_per_shard``; a drain
    given the table joins the slots whose shard is one of ``parts`` and
    writes nothing for the others. ``c`` caches the kernel's ctypes table
    (built and checked once, on the first launch)."""

    __slots__ = ("parts", "rows_per_shard", "first", "c")

    def __init__(self, parts, rows_per_shard: int, first: int = 0):
        if not 1 <= len(parts) <= MAX_SHARDS:
            raise ValueError(
                f"a card's shard table holds 1 to {MAX_SHARDS} shards, got {len(parts)}")
        if not 1 <= rows_per_shard < 1 << 32:
            raise ValueError(f"rows_per_shard {rows_per_shard} out of range")
        self.parts = tuple(parts)
        self.rows_per_shard = int(rows_per_shard)
        self.first = int(first)
        self.c = None

    @classmethod
    def of(cls, shards) -> "ShardTable":
        """``shards`` as a table: a table as it is, a state as the one
        shard holding all of its rows."""
        if isinstance(shards, cls):
            return shards
        rows = next(p for p in shards if p is not None).shape[0]
        return cls((shards,), max(rows, 1))

    @property
    def device(self) -> torch.device:
        return next(p for p in self.parts[0] if p is not None).device

    def split(self, key_idx: torch.Tensor):
        """(part, slot indices, local rows), as tensors on ``key_idx``'s
        device, for each part holding some of the (B,) int32 ``key_idx``
        (the plain versions' split; see ``split``)."""
        dev = key_idx.device
        for i, sel, local in split(key_idx.cpu().numpy(), self.rows_per_shard,
                                   self.first, len(self.parts)):
            yield (self.parts[i], torch.from_numpy(sel).to(dev),
                   torch.from_numpy(local).to(dev))


class SlotMap:
    """A keyspace's slot map for the dense drains: a (K,) int32 tensor on
    its device, -1 ("no delta") at every row between drains. A dense drain
    writes ``map[rows[s]] = s`` for its staged slots and its walk resets
    every entry it reads back to -1, so the map is clean after each call
    and no fill runs per drain. ``dirty`` is set for the length of a call
    (``begin`` / ``end``): a call that raised leaves it set, and the next
    ``begin`` refills the map with -1 first."""

    __slots__ = ("map", "dirty")

    def __init__(self, rows: int, device):
        self.map = torch.full((rows,), -1, dtype=torch.int32, device=device)
        self.dirty = False

    def begin(self) -> None:
        if self.dirty:
            self.map.fill_(-1)
        self.dirty = True

    def end(self) -> None:
        self.dirty = False


class DensePlan:
    """A state's dense-drain plan: the ``state`` (a counter or TREG state
    of K rows on one device), ``slots``, the ``SlotMap`` the counters'
    walk goes through (the keyspace's own, or one the counter wrappers
    add to a plan without; None for TREG, whose drain runs in the batch's
    order), ``full`` (the (K,) output
    every row gets, allocated by the kernel's module on the first drain
    and reused) and ``c``, the kernel's launch arguments, built and
    checked once (see ops/planes.py ``counter_plan``, ops/treg.py
    ``dense_plan``). A keyspace rebuilds its plan whenever its state is
    replaced."""

    __slots__ = ("state", "slots", "full", "c")

    def __init__(self, state, slots: SlotMap | None = None):
        self.state = state
        rows = state[0].shape[0]
        if slots is not None and (slots.map.shape[0] != rows
                                  or slots.map.device != state[0].device):
            raise ValueError(f"slot map of {slots.map.shape[0]} rows on "
                             f"{slots.map.device} for a state of {rows} on "
                             f"{state[0].device}")
        self.slots = slots
        self.full = None
        self.c = None

    @classmethod
    def of(cls, state) -> "DensePlan":
        """``state`` as a plan: a plan as it is, a state with a fresh one."""
        return state if isinstance(state, cls) else cls(state)

    @property
    def device(self) -> torch.device:
        return self.state[0].device


def split(rows: np.ndarray, rows_per_shard: int, first: int, count: int):
    """The host's global row -> (shard, local row) rule, as the kernels
    apply it: row g, read as unsigned 32 bits, lives in shard
    ``g // rows_per_shard`` at local row ``g % rows_per_shard``. Yields
    (i, positions in ``rows``, local rows) for each shard ``first + i``,
    i < ``count``, holding some of ``rows``; rows in no such shard (a
    negative row, a row past the keyspace) are in none."""
    g = np.asarray(rows).astype(np.int64) & 0xFFFFFFFF
    shard = g // rows_per_shard
    for i in range(count):
        sel = np.flatnonzero(shard == first + i)
        if len(sel):
            yield i, sel, g[sel] - (first + i) * rows_per_shard


class Stage:
    """One card's staging buffers (see the module docstring). The views
    of a buffer for one (batch size, fields) are built once and kept
    until the buffer grows (at most 256 at a time)."""

    uploads = 0  # host-to-device steps, over every Stage (tests read them)
    downloads = 0

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._bufs: dict[str, torch.Tensor] = {}
        self._views: dict[tuple, tuple] = {}  # (buffer, b, fields) -> (bytes, views)
        self._in = self._out = None  # the call's (b, fields, bytes)

    def _view(self, name: str, b: int, fields):
        """(total bytes, views of buffer ``name`` for ``b`` rows of
        ``fields``): numpy arrays of the host buffers, tensors of the
        device ones (u64 as int64, flags as bool)."""
        key = (name, b, fields)
        got = self._views.get(key)
        if got is not None:
            return got
        if len(self._views) >= 256:  # batch sizes vary from drain to drain
            self._views.clear()
        regions, total = layout(b, fields)
        if total > MAX_STAGE_BYTES:
            raise ValueError(f"a staged call of {total} bytes: at most {MAX_STAGE_BYTES}")
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < total:
            size = bucket(total, 4096)
            if self.cuda and name.startswith("dev"):
                buf = torch.empty(size, dtype=torch.uint8, device=self.device)
            else:  # a failure to pin raises: it never falls back to pageable
                buf = torch.empty(size, dtype=torch.uint8, pin_memory=self.cuda)
            self._bufs[name] = buf
            for k in [k for k in self._views if k[0] == name]:
                del self._views[k]
        views = []
        if name.startswith("host") or not self.cuda:
            raw = buf.numpy()
            for (dt, _), (o, n, shape) in zip(fields, regions):
                views.append(raw[o:o + n].view(dt).reshape(shape))
        else:
            for (dt, _), (o, n, shape) in zip(fields, regions):
                views.append(buf[o:o + n].view(_TORCH[np.dtype(dt)]).view(shape))
        got = self._views[key] = (total, views)
        return got

    def host_in(self, b: int, fields) -> list[np.ndarray]:
        """Numpy views of the pinned input buffer, one per field (a tuple
        of (dtype, row shape)), for a batch of ``b`` slots: the caller
        writes the batch into them."""
        fields = tuple(fields)
        total, views = self._view("host_in", b, fields)
        self._in = (b, fields, total)
        return views

    def upload(self) -> list[torch.Tensor]:
        """The staged batch on the card: one copy of the whole input
        buffer, on the device's current stream; tensor views of it, one
        per field. On a CPU card, tensor views of the staged buffer."""
        b, fields, total = self._in
        Stage.uploads += 1
        if not self.cuda:
            return [torch.from_numpy(v.view(np.int64) if v.dtype == np.uint64 else v)
                    for v in self._view("host_in", b, fields)[1]]
        _, views = self._view("dev_in", b, fields)
        with torch.cuda.device(self.device):
            self._bufs["dev_in"][:total].copy_(self._bufs["host_in"][:total], non_blocking=True)
        return views

    def device_out(self, b: int, fields) -> list[torch.Tensor]:
        """Tensor views of the packed device output buffer, one per field
        (int64 for u64, bool for flags), for the kernel to write."""
        fields = tuple(fields)
        total, views = self._view("dev_out", b, fields)
        if not self.cuda:
            views = [torch.from_numpy(v) for v in views]
        self._out = (b, fields, total)
        return views

    def download(self) -> None:
        """Queue one copy of the packed outputs into pinned memory, on
        the device's current stream (``wait`` reads them)."""
        b, fields, total = self._out
        Stage.downloads += 1
        if self.cuda:
            self._view("host_out", b, fields)
            with torch.cuda.device(self.device):
                self._bufs["host_out"][:total].copy_(self._bufs["dev_out"][:total],
                                                     non_blocking=True)

    def wait(self) -> list[np.ndarray]:
        """Synchronise with the card, then numpy views of the outputs
        (valid until this Stage's next drain)."""
        b, fields, _ = self._out
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()
            return self._view("host_out", b, fields)[1]
        return self._view("dev_out", b, fields)[1]
