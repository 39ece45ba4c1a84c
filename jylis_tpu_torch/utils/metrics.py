"""Merge-path metrics + opt-in torch.profiler tracing.

The port's copy of jylis_tpu/utils/metrics.py (:1-213), with the JAX
profiler replaced by torch.profiler behind the same switch. The
counters themselves live in a per-Database
:class:`~jylis_tpu_torch.obs.registry.MetricsRegistry`: every repo
carries a ``metrics`` attribute pointing at its Database's registry,
and registry-less direct drives (standalone repos) fall back to the
process-wide ``DEFAULT`` instance below. Two pieces stay here:

* every drain runs under `timed_drain`, accumulating per-type batch
  counts / batched-key counts / seconds AND a log2 latency histogram
  per type (``drain.<TYPE>`` in SYSTEM LATENCY);
* set ``JYLIS_PROFILE_DIR=/some/dir`` to record the node in one
  torch.profiler session from the moment it starts serving
  (``start_profiling``, called by main.serve) to its clean shutdown
  (``stop_profiling``, which writes the trace to that directory, for
  TensorBoard or chrome://tracing): CPU and, on a GPU, CUDA activity, on
  every thread, and the registry's spans (obs.SPANS: the repo locks'
  waits and holds, converge slices, frame decodes, the drains' phases,
  full collections) as profiler ranges of their names, a lock wait and
  the drain it triggers carrying one id as the range's input.
"""

from __future__ import annotations

import functools
import os
import time

from ..obs.registry import JOURNAL_KEYS as _JOURNAL_KEYS
from ..obs.registry import MetricsRegistry

_profiler = None


def start_profiling() -> None:
    """Start the ``JYLIS_PROFILE_DIR`` session, when that variable names
    a directory and none runs yet."""
    global _profiler
    out = os.environ.get("JYLIS_PROFILE_DIR", "")
    if not out or _profiler is not None:
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # every thread: the drains run in worker threads. Shapes recorded,
    # so a range's id (obs.registry.SPAN_ID) is in the trace
    _profiler = torch.profiler.profile(
        activities=acts, record_shapes=True,
        experimental_config=_ExperimentalConfig(profile_all_threads=True),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(out),
    )
    _profiler.start()


# The process-wide fallback registry for callers constructed without an
# explicit one (standalone repos in unit tests).
DEFAULT = MetricsRegistry()


def resolve_registry(obj) -> MetricsRegistry:
    """The registry ``obj`` carries (its owning Database's, wired as the
    ``metrics`` attribute), or the process DEFAULT for registry-less
    direct drives -- THE fallback policy, shared by every consumer
    (timed_drain, RepoSYSTEM) so it cannot drift."""
    return getattr(obj, "metrics", None) or DEFAULT


def timed_drain(name: str):
    """Decorator for repo drain() methods: per-batch counters and a log2
    latency histogram (``drain.<name>``). The drain returns the number
    of keys it drained (0: nothing was pending, and nothing is
    recorded); the decorated drain returns None. The registry resolves
    per call from the repo's ``metrics`` attribute (set by Database), so
    one decorated class serves any number of registry-carrying
    instances.

    The seconds recorded are the host's seconds of the drain call, as
    the JAX package's are: no ``torch.cuda.synchronize()`` is added, so
    on the card a drain whose results are not read back before it
    returns counts its launches, not their completion."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(self, *args, **kwargs):
            t0 = time.perf_counter()
            n = fn(self, *args, **kwargs)
            if n:
                reg = resolve_registry(self)
                if reg.enabled:
                    reg.note_drain(name, n, time.perf_counter() - t0)

        return inner

    return wrap


def kernel_wrappers() -> dict:
    """Every hand-written kernel's wrapper, by the kernel's name (each
    counts its launches where it launches: ``.launches`` and the per-card
    ``.by_card``, ops/_build.py; the plain versions count nothing)."""
    from ..ops import gcount, pncount, tensor, tlog, treg
    from ..ops import ujson_device, ujson_resident
    from ..parallel import replica_join

    return {
        "counter_drain_dense<1>": gcount.drain_dense,
        "counter_drain_dense<2>": pncount.drain_dense,
        "counter_drain_sparse<1>": gcount.drain_sparse,
        "counter_drain_sparse<2>": pncount.drain_sparse,
        "tensor_join_dense": tensor.join_dense,
        "tensor_converge_batch": tensor.converge_batch,
        "treg_drain_dense": treg.drain_dense,
        "treg_drain_sparse": treg.drain_sparse,
        "tlog_drain_dense": tlog.drain_dense,
        "tlog_drain_sparse": tlog.drain_sparse,
        "ujson_join": ujson_device.join_rows,
        "ujson_fold_flat": ujson_resident.fold_flat,
        "replica_join": replica_join,
    }


def kernel_launches() -> dict[str, int]:
    """This process's launches of each hand-written kernel so far, by
    the kernel's name. A node logs them at its clean shutdown, so a
    process of its own, a lane worker say, leaves its count behind."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def kernel_launches_by_card() -> dict[str, dict[int, int]]:
    """The same launches per card: kernel name -> {card index:
    launches}, a kernel that never launched as {}."""
    return {name: dict(fn.by_card) for name, fn in kernel_wrappers().items()}


def launches_since(before: dict, before_by_card: dict) -> tuple[dict, dict]:
    """(launches, launches by card) of each kernel that launched since
    ``before`` / ``before_by_card`` (earlier ``kernel_launches`` and
    ``kernel_launches_by_card`` reads); the cards as strings, as JSON
    writes them."""
    now, now_by_card = kernel_launches(), kernel_launches_by_card()
    total = {k: n - before.get(k, 0) for k, n in now.items() if n - before.get(k, 0)}
    by_card = {}
    for k, cards in now_by_card.items():
        was = before_by_card.get(k, {})
        diff = {str(c): n - was.get(c, 0) for c, n in sorted(cards.items())
                if n - was.get(c, 0)}
        if diff:
            by_card[k] = diff
    return total, by_card


def stop_profiling() -> None:
    """End the ``JYLIS_PROFILE_DIR`` session and write its trace (called
    at clean shutdown)."""
    global _profiler
    if _profiler is not None:
        _profiler.stop()
        _profiler = None


def metric_lines(
    served: dict[str, int] | None = None,
    serving: dict[str, int] | None = None,
    cluster: dict[str, int] | None = None,
    registry: MetricsRegistry | None = None,
    lane: dict[str, int] | None = None,
    session: dict[str, int] | None = None,
    overload: dict[str, int] | None = None,
) -> list[str]:
    """Flat `type counter value` lines -- the SYSTEM METRICS reply body,
    section for section the JAX package's. ``served`` is the node's
    per-type commands-served totals. ``serving`` is the native-vs-
    demoted split (native_cmds / demoted_cmds / demotions /
    busy_refusals), emitted with the live fallback_frac. ``cluster``,
    ``lane``, ``session`` and ``overload`` are the CLUSTER, LANE,
    SESSION and OVERLOAD sections (None: no section). ``registry`` is
    the node's MetricsRegistry (drain/journal counters + the latency
    histograms, emitted as `LATENCY <seam>.<stat>` lines); None falls
    back to the process DEFAULT. A counter type's drain lines carry the
    port's `<TYPE> converge_mapped` (keys converged from a generic
    mapping, not in place from the wire); a JAX node has none. The
    port's SPAN section ends the reply
    (`SPAN <name> <count|ms|items> <value>`, every declared span); a JAX
    node has none."""
    reg = registry if registry is not None else DEFAULT
    lines = [
        f"{name} cmds {n}" for name, n in sorted((served or {}).items()) if n
    ]
    if lane is not None:
        lines.insert(0, f"LANE count {lane.get('count', 0)}")
        lines.insert(0, f"LANE id {lane.get('id', 0)}")
    if serving and any(serving.values()):
        for k in ("native_cmds", "demoted_cmds", "demotions", "busy_refusals"):
            lines.append(f"SERVING {k} {serving.get(k, 0)}")
        total = serving.get("native_cmds", 0) + serving.get("demoted_cmds", 0)
        if total:
            frac = serving.get("demoted_cmds", 0) / total
            lines.append(f"SERVING fallback_frac {frac:.4f}")
    if session is not None and any(session.values()):
        lines.extend(
            f"SESSION {k} {v}" for k, v in sorted(session.items())
        )
    if overload is not None and overload.get("armed"):
        lines.extend(
            f"OVERLOAD {k} {v}"
            for k, v in overload.items()
            if k != "armed"
        )
    if cluster is not None:
        lines.extend(f"CLUSTER {k} {v}" for k, v in cluster.items())
    mapped = dict(reg.converge_mapped)
    for name, drains, keys, ms in reg.type_stats():
        lines.append(f"{name} drains {drains}")
        lines.append(f"{name} keys {keys}")
        lines.append(f"{name} device_ms {ms:.1f}")
        if name in mapped:
            lines.append(f"{name} converge_mapped {mapped.pop(name)}")
    lines.extend(f"{name} converge_mapped {n}" for name, n in sorted(mapped.items()))
    if reg.journal_enabled or any(reg.journal_counters.values()):
        for k in _JOURNAL_KEYS:
            lines.append(f"JOURNAL {k} {reg.journal_counters[k]}")
    for name, snap in reg.seam_stats():
        if snap["count"]:
            lines.append(f"LATENCY {name}.p50_us {snap['p50_s'] * 1e6:.0f}")
            lines.append(f"LATENCY {name}.p90_us {snap['p90_s'] * 1e6:.0f}")
            lines.append(f"LATENCY {name}.p99_us {snap['p99_s'] * 1e6:.0f}")
            lines.append(f"LATENCY {name}.max_us {snap['max_s'] * 1e6:.0f}")
            lines.append(f"LATENCY {name}.count {snap['count']}")
    for name, count, ms, items in reg.span_stats():
        lines.append(f"SPAN {name} count {count}")
        lines.append(f"SPAN {name} ms {ms:.1f}")
        lines.append(f"SPAN {name} items {items}")
    return lines
