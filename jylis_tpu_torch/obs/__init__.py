"""Node observability: latency histograms and a bounded trace ring.

The port's copy of what ``MetricsRegistry`` needs of jylis_tpu/obs/
(the JAX package's ``obs/__init__.py`` :1-104, ``hist.py``, ``trace.py``,
``registry.py`` and the ``SpanStats`` part of ``jtrace.py``), unchanged in
behaviour. The Prometheus endpoint (``prom.py``) and the span wire
format of ``jtrace.py`` come with the cluster.

* **Fixed-bucket log2 latency histograms** (`hist.Histogram`): 64
  power-of-two nanosecond buckets, record = one index computation + one
  list increment, cheap enough to stay armed on the serving path. The
  per-type drains record into them (utils/metrics.timed_drain).
* **A bounded structured trace ring** (`trace.TraceRing`), dumped by
  `SYSTEM TRACE [count]`.
* **Spans** (`MetricsRegistry.span`), the port's own: per name a count,
  host milliseconds and items (keys or bytes), shown in `SYSTEM
  METRICS`' SPAN section; under a recording torch profiler each span is
  also a profiler range of its name, on the device trace's clock.

Every histogram and gauge name is pre-registered below, the same
tuples as the JAX package's, so `SYSTEM LATENCY` shows the same seams
(with zero counts) from boot. Every span name is declared before it
records, the node-wide ones in ``SPANS`` and each repo's lock and
converge spans when the Database registers its manager, so the SPAN
section shows them all (zeros included) from boot.
"""

from __future__ import annotations

# Every latency histogram seam, pre-created in each MetricsRegistry so
# SYSTEM LATENCY shows the complete surface from boot (zero counts
# included); the JAX package's tuple, so both nodes list the same seams.
SEAMS = (
    "drain.TREG",
    "drain.TLOG",
    "drain.GCOUNT",
    "drain.PNCOUNT",
    "drain.TENSOR",
    "drain.MAP",
    "drain.BCOUNT",
    "server.native_burst",
    "server.py_dispatch",
    "journal.append",
    "journal.fsync",
    "cluster.rtt",
    "cluster.converge_lag",
    # the serving pipeline's per-stage timers (accept, read, parse,
    # classify, dispatch, reply_write)
    "pipeline.accept",
    "pipeline.read",
    "pipeline.parse",
    "pipeline.classify",
    "pipeline.dispatch",
    "pipeline.reply_write",
)

# Node-wide gauges, the JAX package's names (cluster convergence lag
# and backlog, range-repair debt, bridge role and relay depth, overload
# state and queued reply bytes).
GAUGES = (
    "cluster.converge_lag_ms",
    "cluster.backlog_ms",
    "cluster.interval_dirty_peers",
    "cluster.bridge_is_self",
    "cluster.relay_queue_bytes",
    "serving.overload",
    "serving.queued_bytes",
)

# the staged drains' types and the phases each drain is split into
DRAIN_TYPES = ("GCOUNT", "PNCOUNT", "TREG")
DRAIN_PHASES = ("collect", "fill", "launch", "wait", "finish")

# The node-wide span names, pre-created in each MetricsRegistry (SYSTEM
# METRICS' SPAN section lists them from boot; ``span()`` raises KeyError
# on an undeclared name):
#   decode.frame            one cluster frame's decode (items: its bytes)
#   drain.<TYPE>.<phase>    one drain phase (items: the batch's keys)
#   gc.full                 one full (generation 2) collection
# Each repo manager declares its own when the Database registers it
# (RepoManager.use_registry), for the callers that can take its lock:
#   lock_wait.<TYPE>.<who>  asking for the repo lock until holding it
#   lock_hold.<TYPE>.<who>  holding it until its release
#   converge.<TYPE>         one converge slice (items: its keys)
SPANS = (
    "decode.frame",
    *(f"drain.{t}.{p}" for t in DRAIN_TYPES for p in DRAIN_PHASES),
    "gc.full",
)
# the fields each span shows, one SYSTEM METRICS line each
SPAN_FIELDS = ("count", "ms", "items")
