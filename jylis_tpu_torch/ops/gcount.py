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
join + row-sum steps. On a CPU tensor they run their plain versions
below; on a CUDA tensor they launch the hand-written kernels
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


def drain_dense_plain(state: GCountState, deltas: torch.Tensor) -> torch.Tensor:
    """``join`` with a (K, R) delta plane, in place, then ``read_all``."""
    state.counts.copy_(planes.join_max(state.counts, deltas))
    return read_all(state)


def drain_dense(state: GCountState, deltas: torch.Tensor) -> torch.Tensor:
    """Whole-keyspace drain: join (K, R) ``deltas`` into ``state`` in place
    and return every row's sum (K,) as int64 bits."""
    if state.counts.device.type == "cpu":
        return drain_dense_plain(state, deltas)
    sums = planes.launch_drain_dense((state.counts,), (deltas,))
    _build.count(drain_dense, state.counts.device)
    return sums


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
