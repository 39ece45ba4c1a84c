"""GCOUNT: grow-only counter lattice on (keys x replicas) tensors.

Semantics (docs/_docs/types/gcount.md:43-47): state is a map
replica-id -> u64; join takes the per-replica max; the counter's value is
the sum over replicas. The port of jylis_tpu/ops/gcount.py: the whole
keyspace is ONE dense (K, R) plane of u64 counters held as int64 bit
patterns (ops/planes.py), on the device the caller names.

Functions that join into the state (``converge_batch``, ``increment``,
``decrement`` and the two drains) update it in place and return it; the
JAX versions return new arrays and let XLA reuse the donated buffers.

``drain_dense`` and ``drain_sparse`` are the serving path's fused
join + row-sum steps, both on a compact batch of rows and delta rows
(the dense one walks every row of the state through its slot map and
also returns every row's sum). On a CPU tensor they run their plain
versions below; on a CUDA tensor they launch the hand-written kernels
``counter_drain_dense<1>`` / ``counter_drain_sparse<1>`` or raise.
Batches must carry UNIQUE key rows (the repos' pending dicts guarantee
it).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build, planes
from .staging import ShardTable


class GCountState(NamedTuple):
    """Dense grow-only counter keyspace: u64 ``counts[key, replica]``."""

    counts: torch.Tensor  # (K, R) int64 bit patterns


def init(num_keys: int, num_replicas: int, device="cuda") -> GCountState:
    return GCountState(
        torch.zeros((num_keys, num_replicas), dtype=torch.int64, device=device)
    )


def from_counts(counts, device="cuda") -> GCountState:
    """Build from a u64 ndarray (tests / interop)."""
    return GCountState(planes.to_tensor(np.asarray(counts), device))


def to_counts(state: GCountState) -> np.ndarray:
    return planes.to_u64_np(state.counts)


def join(a: GCountState, b: GCountState) -> GCountState:
    """Full-state lattice join: elementwise per-replica u64 max."""
    return GCountState(planes.join_max(a.counts, b.counts))


def converge_batch(
    state: GCountState, key_idx: torch.Tensor, deltas: torch.Tensor
) -> GCountState:
    """Join a (B, R) delta batch at UNIQUE rows ``key_idx``, in place.
    Rows >= K are dropped, as fire-and-forget delivery drops them."""
    planes.scatter_join(state.counts, key_idx, deltas)
    return state


def increment(
    state: GCountState,
    key_idx: torch.Tensor,
    replica_idx: torch.Tensor,
    amount: torch.Tensor,
) -> GCountState:
    """Local INC at UNIQUE (key, replica) coordinates, in place, wrapping
    at 2^64; ``amount`` is (B,) int64 bits. Out-of-range rows are
    dropped."""
    live = planes.live_rows(key_idx, state.counts.shape[0])
    k, r = key_idx[live].long(), replica_idx[live].long()
    state.counts[k, r] += amount[live]
    return state


def read(state: GCountState, key_idx: torch.Tensor) -> torch.Tensor:
    """GET for a batch of in-range keys: row sums, u64 bits, wrapping."""
    return planes.rowsum64(state.counts[key_idx.long()])


def read_all(state: GCountState) -> torch.Tensor:
    return planes.rowsum64(state.counts)


def grow(state: GCountState, num_keys: int, num_replicas: int) -> GCountState:
    """Capacity growth (zeros are the lattice identity)."""
    k, r = state.counts.shape
    if num_keys == k and num_replicas == r:
        return state
    out = init(num_keys, num_replicas, state.counts.device)
    out.counts[:k, :r] = state.counts
    return out


# ---- the drain steps: kernels and their plain versions ------------------------


def drain_dense_plain(
    plan, key_idx: torch.Tensor, deltas: torch.Tensor, out=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``drain_dense``: the slot map's scatter and
    walk, ``join`` at the rows holding a slot, in place, then
    ``read_all`` into the plan's full output and the joined rows' sums
    at their slots."""
    plan = planes.mapped_plan(plan)
    if out is None:
        out = torch.zeros(key_idx.shape[0], dtype=torch.int64, device=deltas.device)
    m = plan.slots.map
    rows, slots = planes.walk_slots(m, key_idx)
    x = plan.state.counts
    x[rows] = planes.join_max(x[rows], deltas[slots])
    full = planes.dense_full(plan, torch.int64)
    full.copy_(read_all(plan.state))
    out[slots] = full[rows]
    m[rows] = -1
    return full, out


def drain_dense(
    plan, key_idx: torch.Tensor, deltas: torch.Tensor, out=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-keyspace drain of a compact batch on one device: join the
    (B, R) ``deltas`` at the UNIQUE rows ``key_idx`` ((B,) int32, in
    [0, K)) into the state of ``plan`` (a ``DensePlan``, or a
    GCountState given one of its own), in place, through the plan's slot
    map. Returns (every row's sum (K,), the plan's full output, valid
    until its next drain; ``out``, the joined rows' sums (B,) at their
    slots, allocated zeroed when None), as int64 bits. A duplicate row is
    the caller's fault: one of its slots is left out. A raised call
    leaves the slot map to be refilled by the next."""
    plan = planes.mapped_plan(plan)
    slots = plan.slots
    slots.begin()
    if plan.device.type == "cpu":
        res = drain_dense_plain(plan, key_idx, deltas, out)
        slots.end()
        return res
    if out is None:
        out = torch.zeros(key_idx.shape[0], dtype=torch.int64, device=plan.device)
    planes.launch_drain_dense(plan, key_idx, (deltas,), out)
    slots.end()
    _build.count(drain_dense, plan.device)
    return plan.full, out


_build.counter(drain_dense)


def drain_sparse_plain(
    shards, key_idx: torch.Tensor, deltas: torch.Tensor, out=None
) -> torch.Tensor:
    """The plain version of ``drain_sparse``: per part of the table,
    ``converge_batch`` at the local rows of its slots, then the joined
    rows' sums at those slots."""
    table = ShardTable.of(shards)
    if out is None:
        out = torch.zeros(key_idx.shape[0], dtype=torch.int64, device=deltas.device)
    for part, sel, local in table.split(key_idx):
        converge_batch(part, local, deltas[sel])
        out[sel] = read(part, local)
    return out


def drain_sparse(
    shards, key_idx: torch.Tensor, deltas: torch.Tensor, out=None
) -> torch.Tensor:
    """Batched drain at UNIQUE global rows ``key_idx`` ((B,) int32) over
    ``shards``: a GCountState (one shard holding all of its rows) or the
    ``ShardTable`` of the shards on one card. Joins the (B, R) ``deltas``
    into the shard holding each row, in place, and writes the joined
    rows' sums as int64 bits into ``out`` (B,) at each slot whose shard is
    in the table; with ``out`` None it is allocated zeroed, so a slot off
    the table (the routed callers' pads: rows >= K) reads 0."""
    table = ShardTable.of(shards)
    if table.device.type == "cpu":
        return drain_sparse_plain(table, key_idx, deltas, out)
    if out is None:
        out = torch.zeros(key_idx.shape[0], dtype=torch.int64, device=table.device)
    if key_idx.shape[0]:
        planes.launch_drain_sparse(table, key_idx, (deltas,), out)
        _build.count(drain_sparse, table.device)
    return out


_build.counter(drain_sparse)
