"""PNCOUNT: positive/negative counter lattice on (keys x replicas) tensors.

Semantics (docs/_docs/types/pncount.md:49-55): two grow-only per-replica
maps, P and N, converged independently by per-replica max; the value is
sum(P) - sum(N) as a signed 64-bit integer. The port of
jylis_tpu/ops/pncount.py: each polarity is one (K, R) plane of u64
counters held as int64 bit patterns (ops/planes.py). Since the planes are
int64, the wrapped u64 difference is already the signed value the
reference's (p - n).i64() defines.

As in ops/gcount.py, joins into the state happen in place, and
``drain_dense`` / ``drain_sparse`` launch ``counter_drain_dense<2>`` /
``counter_drain_sparse<2>`` on a CUDA tensor and run their plain versions
on a CPU one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build, planes
from .staging import ShardTable


class PNCountState(NamedTuple):
    p: torch.Tensor  # (K, R) int64 bit patterns
    n: torch.Tensor


def init(num_keys: int, num_replicas: int, device="cuda") -> PNCountState:
    return PNCountState(
        *(
            torch.zeros((num_keys, num_replicas), dtype=torch.int64, device=device)
            for _ in range(2)
        )
    )


def from_counts(p, n, device="cuda") -> PNCountState:
    return PNCountState(
        planes.to_tensor(np.asarray(p), device),
        planes.to_tensor(np.asarray(n), device),
    )


def to_counts(state: PNCountState) -> tuple[np.ndarray, np.ndarray]:
    return planes.to_u64_np(state.p), planes.to_u64_np(state.n)


def join(a: PNCountState, b: PNCountState) -> PNCountState:
    return PNCountState(planes.join_max(a.p, b.p), planes.join_max(a.n, b.n))


def converge_batch(
    state: PNCountState,
    key_idx: torch.Tensor,
    dp: torch.Tensor,
    dn: torch.Tensor,
) -> PNCountState:
    """Join a delta batch at UNIQUE (B,) key rows, in place; (B, R) planes
    per polarity. Rows >= K are dropped."""
    planes.scatter_join(state.p, key_idx, dp)
    planes.scatter_join(state.n, key_idx, dn)
    return state


def _bump(x, key_idx, replica_idx, amount) -> None:
    live = planes.live_rows(key_idx, x.shape[0])
    x[key_idx[live].long(), replica_idx[live].long()] += amount[live]


def increment(
    state: PNCountState, key_idx, replica_idx, amount
) -> PNCountState:
    """INC at UNIQUE (key, replica) coordinates, in place; amount (B,)
    int64 bits, wrapping at 2^64."""
    _bump(state.p, key_idx, replica_idx, amount)
    return state


def decrement(
    state: PNCountState, key_idx, replica_idx, amount
) -> PNCountState:
    _bump(state.n, key_idx, replica_idx, amount)
    return state


def read(state: PNCountState, key_idx: torch.Tensor) -> torch.Tensor:
    """GET for a batch of in-range keys: the signed net value, computed
    with u64 wraparound (repo_pncount.pony:55-57)."""
    rows = key_idx.long()
    return planes.rowsum64(state.p[rows]) - planes.rowsum64(state.n[rows])


def read_all(state: PNCountState) -> torch.Tensor:
    return planes.rowsum64(state.p) - planes.rowsum64(state.n)


def grow(state: PNCountState, num_keys: int, num_replicas: int) -> PNCountState:
    k, r = state.p.shape
    if num_keys == k and num_replicas == r:
        return state
    out = init(num_keys, num_replicas, state.p.device)
    out.p[:k, :r] = state.p
    out.n[:k, :r] = state.n
    return out


# ---- the drain steps: kernels and their plain versions ------------------------


def drain_dense_plain(
    plan, key_idx: torch.Tensor, dp: torch.Tensor, dn: torch.Tensor, out=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``drain_dense``: the slot map's scatter and
    walk, ``join`` at the rows holding a slot, in place, then
    ``read_all`` into the plan's full output and the joined rows' net
    values at their slots."""
    plan = planes.mapped_plan(plan)
    if out is None:
        out = torch.zeros(key_idx.shape[0], dtype=torch.int64, device=dp.device)
    m = plan.slots.map
    rows, slots = planes.walk_slots(m, key_idx)
    for x, d in zip(plan.state, (dp, dn)):
        x[rows] = planes.join_max(x[rows], d[slots])
    full = planes.dense_full(plan, torch.int64)
    full.copy_(read_all(plan.state))
    out[slots] = full[rows]
    m[rows] = -1
    return full, out


def drain_dense(
    plan, key_idx: torch.Tensor, dp: torch.Tensor, dn: torch.Tensor, out=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-keyspace drain of a compact batch on one device (as
    gcount.drain_dense): join the (B, R) ``dp``/``dn`` at the UNIQUE rows
    ``key_idx`` into the state of ``plan`` (a ``DensePlan`` or a
    PNCountState) in place. Returns (every row's signed net value (K,),
    the plan's full output; ``out``, the joined rows' net values (B,) at
    their slots)."""
    plan = planes.mapped_plan(plan)
    slots = plan.slots
    slots.begin()
    if plan.device.type == "cpu":
        res = drain_dense_plain(plan, key_idx, dp, dn, out)
        slots.end()
        return res
    if out is None:
        out = torch.zeros(key_idx.shape[0], dtype=torch.int64, device=plan.device)
    planes.launch_drain_dense(plan, key_idx, (dp, dn), out)
    slots.end()
    _build.count(drain_dense, plan.device)
    return plan.full, out


_build.counter(drain_dense)


def drain_sparse_plain(
    shards, key_idx: torch.Tensor, dp: torch.Tensor, dn: torch.Tensor, out=None
) -> torch.Tensor:
    """The plain version of ``drain_sparse``: per part of the table,
    ``converge_batch`` at the local rows of its slots, then the joined
    rows' net values at those slots."""
    table = ShardTable.of(shards)
    if out is None:
        out = torch.zeros(key_idx.shape[0], dtype=torch.int64, device=dp.device)
    for part, sel, local in table.split(key_idx):
        converge_batch(part, local, dp[sel], dn[sel])
        out[sel] = read(part, local)
    return out


def drain_sparse(
    shards, key_idx: torch.Tensor, dp: torch.Tensor, dn: torch.Tensor, out=None
) -> torch.Tensor:
    """Batched drain at UNIQUE global rows ``key_idx`` ((B,) int32) over
    ``shards`` (a PNCountState, or the ``ShardTable`` of one card's
    shards; as gcount.drain_sparse): join the (B, R) ``dp``/``dn`` in
    place and write the joined rows' net values into ``out`` (B,) at the
    table's slots (allocated zeroed when None: 0 at the routed callers'
    pads)."""
    table = ShardTable.of(shards)
    if table.device.type == "cpu":
        return drain_sparse_plain(table, key_idx, dp, dn, out)
    if out is None:
        out = torch.zeros(key_idx.shape[0], dtype=torch.int64, device=table.device)
    if key_idx.shape[0]:
        planes.launch_drain_sparse(table, key_idx, (dp, dn), out)
        _build.count(drain_sparse, table.device)
    return out


_build.counter(drain_sparse)
