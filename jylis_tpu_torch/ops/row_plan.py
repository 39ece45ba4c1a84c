"""Launch plans of the row kernels (csrc/tlog_drain.cu, csrc/ujson_join.cu,
csrc/ujson_fold_flat.cu).

A row kernel gives each row of a launch a work buffer of the same size
(the launch's rows share one width), and the plan puts the rows in one
of these classes:

* ``warp``: a warp per row, up to ``WARPS_PER_CTA`` rows a CTA, each
  warp owning a slice of the CTA's shared memory; as many rows a CTA as
  keep the most rows resident on an SM, and fewer when the rows would
  not cover the card's SMs;
* ``cta``: a CTA of ``CTA_THREADS`` threads per row, its buffer in
  shared memory;
* ``cluster`` (``plan_split``, the row kernels' rows past a CTA's
  shared memory): a thread-block cluster of n CTAs per row (n a power
  of two), each CTA holding its share of the row's work buffer in its
  own shared memory and reading the others' through the cluster's
  distributed shared memory; a row too wide even for
  ``CLUSTER_LARGE`` CTAs keeps the shares in device scratch, one region
  a cluster, as many clusters as ``SCRATCH_LIMIT`` holds;
* ``cluster`` (``plan_cluster``, the flat fold): a thread-block cluster
  of up to ``CLUSTER_MAX`` CTAs per row, each taking a share of the
  row's parts, reading the row from device memory, its flags in device
  scratch, one region a cluster.

Pure Python, so the CPU tests check the plans the card gets.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

# a CTA's dynamic shared memory, at most (the H100 allows 232,448 bytes
# a block; the rest is headroom for the kernels' static shared memory)
SMEM_LIMIT = 200 * 1024
SCRATCH_LIMIT = 256 << 20  # bytes of device scratch per launch, at most
WARPS_PER_CTA = 8
CTA_THREADS = 256
CLUSTER_MAX = 8  # CTAs a thread-block cluster holds, portably
CLUSTER_LARGE = 16  # the non-portable size an H100 allows (plan_split)
# an H100 SXM: streaming multiprocessors, shared memory an SM holds, and
# what each resident CTA reserves of it
SMS = 132
SM_SMEM = 233_472
CTA_RESERVED = 1_024


class RowPlan(NamedTuple):
    kind: str  # "warp", "cta" or "cluster"
    rows_per_cta: int  # rows a CTA holds at once (1 unless "warp")
    threads: int  # threads a CTA
    smem: int  # dynamic shared-memory bytes a CTA
    grid: int  # CTAs launched
    scratch: int  # bytes of device scratch (0 unless the buffers live there)
    stride: int  # bytes between two rows' (clusters'; plan_split: CTAs') work buffers
    cluster: int = 1  # CTAs a row (plan_cluster, plan_split)
    held: int = 0  # parts of a row a CTA takes (plan_cluster; the flat fold: deltas)


def align(n: int, a: int) -> int:
    return (n + a - 1) // a * a


def _resident_rows(rpc: int, warp_bytes: int) -> int:
    """Rows an SM holds at once with ``rpc`` warps a CTA, by shared
    memory (at most 32 CTAs and 64 warps an SM)."""
    ctas = min(32, 64 // rpc, SM_SMEM // (rpc * warp_bytes + CTA_RESERVED))
    return ctas * rpc


def plan_rows(nrows: int, warp_bytes: Optional[int], cta_bytes: int,
              warp_limit: int, warp_min_rows: int = 1, share=None,
              cta_limit: int = SMEM_LIMIT) -> RowPlan:
    """The plan for ``nrows`` rows whose work buffer takes ``warp_bytes``
    in the warp class (None: the kernel has no warp class for this
    width), ``cta_bytes`` in the CTA class and ``share(n)`` a CTA in a
    cluster of n (``plan_split``). The warp class takes rows up to
    ``warp_limit`` bytes, in launches of at least ``warp_min_rows`` rows
    (the kernel's measured crossovers: fewer rows than that keep more of
    the card busy a CTA per row); the CTA class rows up to ``cta_limit``
    (at most ``SMEM_LIMIT``); the cluster class the rest."""
    if (warp_bytes is not None and nrows >= warp_min_rows
            and warp_bytes <= min(warp_limit, SMEM_LIMIT)):
        top = max(1, min(WARPS_PER_CTA, SMEM_LIMIT // warp_bytes, -(-nrows // SMS)))
        rpc = max(range(1, top + 1), key=lambda n: (_resident_rows(n, warp_bytes), n))
        return RowPlan("warp", rpc, 32 * rpc, rpc * warp_bytes, -(-nrows // rpc), 0,
                       warp_bytes)
    if cta_bytes <= min(cta_limit, SMEM_LIMIT):
        return RowPlan("cta", 1, CTA_THREADS, cta_bytes, nrows, 0, cta_bytes)
    return plan_split(nrows, share)


def plan_split(nrows: int, share) -> RowPlan:
    """A cluster of n CTAs per row, CTA q holding its share of the row's
    work buffer, ``share(n)`` bytes (n a power of two). n is the least
    size whose share fits ``SMEM_LIMIT``, raised until the launch's
    clusters cover the card's SMs (up to ``CLUSTER_MAX``, the portable
    size; ``CLUSTER_LARGE`` only where the share needs it: the kernel
    checks that the card can place such a cluster). A row whose share
    does not fit even ``CLUSTER_LARGE`` CTAs keeps every CTA's share in
    device scratch (``stride`` bytes a CTA, so CTA b of the launch at
    b * stride), as many clusters as ``SCRATCH_LIMIT`` holds, striding
    over the rows."""
    cover = 2
    while cover < CLUSTER_MAX and cover * nrows < SMS:
        cover *= 2
    n = 2
    while n < CLUSTER_LARGE and share(n) > SMEM_LIMIT:
        n *= 2
    if share(n) > SMEM_LIMIT:
        stride = align(share(n), 256)
        clusters = max(1, min(nrows, SCRATCH_LIMIT // (n * stride)))
        return RowPlan("cluster", 1, CTA_THREADS, 0, clusters * n, clusters * n * stride,
                       stride, n)
    n = max(n, cover)
    smem = share(n)
    return RowPlan("cluster", 1, CTA_THREADS, smem, nrows * n, 0, smem, n)


def plan_cluster(nrows: int, parts: int, smem, scratch_bytes: int) -> RowPlan:
    """A thread-block cluster of n CTAs per row, CTA q taking parts
    [q * held, (q + 1) * held) of the row's ``parts`` with ``smem(held)``
    bytes of shared memory: n as large as covers the card's SMs with the
    launch's clusters (at least 2 and at most ``CLUSTER_MAX``, at most one
    CTA a part);
    each cluster with ``scratch_bytes`` of device scratch, as many
    clusters as ``SCRATCH_LIMIT`` holds, striding over the rows."""
    n = min(max(2, SMS // max(nrows, 1)), CLUSTER_MAX, parts)
    held = -(-parts // n)
    n = -(-parts // held)
    stride = align(scratch_bytes, 256)
    clusters = max(1, min(nrows, SCRATCH_LIMIT // stride))
    return RowPlan("cluster", 1, CTA_THREADS, smem(held), clusters * n, clusters * stride,
                   stride, n, held)
