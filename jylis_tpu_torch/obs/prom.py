"""Opt-in Prometheus text-exposition endpoint (``--metrics-port``).

The port's copy of jylis_tpu/obs/prom.py, whole: the same families,
labels and order, so a scrape of a port node and one of a JAX node
differ only in their numbers.

A scrape-friendly view of the same registry `SYSTEM METRICS` reads, so
the node is observable WITHOUT a Redis client: counters for commands
served / serving split / journal / cluster lifecycle, one summary per
latency seam (quantiles from the log2 histograms), and the node-wide
gauges. Format is the Prometheus text exposition (version 0.0.4);
`make ci`'s metrics-smoke step boots a node, scrapes this endpoint, and
validates both the grammar and that every histogram/gauge declared in
scripts/jlint/metrics_manifest.json is present from boot.

The server is a deliberately tiny asyncio HTTP responder (GET /metrics
only): a scrape every few seconds does not justify an HTTP framework
dependency, and the render itself is a pure function over the registry
(`render`), testable without sockets.
"""

from __future__ import annotations

import asyncio

from ..utils.net import ipv4_port
from .hist import N_BUCKETS, bucket_upper_seconds

# the `le` label per log2 bucket, precomputed once (bucket 0 is the
# exact-zero bucket; the last bucket is the clamp bucket and its upper
# bound is only nominal — +Inf carries the true total)
_LE_LABELS = tuple(
    f"{bucket_upper_seconds(i):.10g}" for i in range(N_BUCKETS)
)


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render(database) -> str:
    """The full exposition body for one node. ``database`` carries the
    registry plus the served/serving/cluster views RepoSYSTEM uses, so
    the scrape and SYSTEM METRICS can never disagree about sources."""
    reg = database.metrics
    system = database.system
    out: list[str] = []

    out.append("# HELP jylis_cmds_total Commands served per data type.")
    out.append("# TYPE jylis_cmds_total counter")
    served = system.served_fn() if system.served_fn else {}
    for name, n in sorted(served.items()):
        out.append(f'jylis_cmds_total{{type="{_esc(name)}"}} {n}')

    out.append("# TYPE jylis_serving_total counter")
    serving = system.serving_fn() if system.serving_fn else {}
    for key in ("native_cmds", "demoted_cmds", "demotions", "busy_refusals"):
        out.append(
            f'jylis_serving_total{{kind="{key}"}} {serving.get(key, 0)}'
        )

    overload = system.overload_fn() if system.overload_fn else {}
    if overload.get("armed"):
        # overload armor (admission.py): same split discipline as the
        # SESSION section — monotone transition/shed counters vs the
        # live state/pressure gauges — so rate() stays meaningful
        _OVERLOAD_GAUGES = ("state", "ewma_us", "inflight", "queued_bytes")
        out.append("# TYPE jylis_overload_total counter")
        for key, v in overload.items():
            if key not in _OVERLOAD_GAUGES and key != "armed":
                out.append(f'jylis_overload_total{{kind="{_esc(key)}"}} {v}')
        out.append("# TYPE jylis_overload gauge")
        for key in _OVERLOAD_GAUGES:
            if key in overload:
                out.append(f'jylis_overload{{key="{key}"}} {overload[key]}')

    session = system.session_fn() if system.session_fn else {}
    if session:
        # the section mixes monotone counters with two live gauges —
        # split the exposition so rate()/increase() stay meaningful
        _SESSION_GAUGES = ("origins", "parked_seqs")
        out.append("# TYPE jylis_session_total counter")
        for key, v in sorted(session.items()):
            if key not in _SESSION_GAUGES:
                out.append(f'jylis_session_total{{kind="{_esc(key)}"}} {v}')
        out.append("# TYPE jylis_session gauge")
        for key in _SESSION_GAUGES:
            if key in session:
                out.append(
                    f'jylis_session{{key="{_esc(key)}"}} {session[key]}'
                )

    out.append("# TYPE jylis_journal_total counter")
    for key, n in reg.journal_counters.items():
        out.append(f'jylis_journal_total{{kind="{key}"}} {n}')

    out.append("# TYPE jylis_drain_total counter")
    for name, drains, keys, ms in reg.type_stats():
        t = _esc(name)
        out.append(f'jylis_drain_total{{type="{t}",kind="batches"}} {drains}')
        out.append(f'jylis_drain_total{{type="{t}",kind="keys"}} {keys}')

    cluster = system.cluster_fn() if system.cluster_fn else {}
    if cluster:
        out.append("# TYPE jylis_cluster gauge")
        for key, v in cluster.items():
            out.append(f'jylis_cluster{{key="{_esc(key)}"}} {v}')

    out.append(
        "# HELP jylis_seam_latency_seconds Log2-bucket latency per "
        "instrumented seam."
    )
    out.append("# TYPE jylis_seam_latency_seconds summary")
    for name, snap in reg.seam_stats():
        seam = _esc(name)
        for q, key in (("0.5", "p50_s"), ("0.9", "p90_s"), ("0.99", "p99_s")):
            out.append(
                f'jylis_seam_latency_seconds{{seam="{seam}",quantile="{q}"}}'
                f" {snap[key]:.9f}"
            )
        out.append(
            f'jylis_seam_latency_seconds_count{{seam="{seam}"}} {snap["count"]}'
        )
        out.append(
            f'jylis_seam_latency_seconds_sum{{seam="{seam}"}} {snap["sum_s"]:.9f}'
        )

    # the same seams as REAL cumulative histograms (satellite of the
    # jtrace round): quantile gauges above are convenient but opaque to
    # PromQL — histogram_quantile()/Grafana need `_bucket` series, and
    # cumulative bucket counters sum correctly across lanes where a
    # quantile never does. Distinct family name: one family cannot be
    # both summary and histogram.
    out.append(
        "# HELP jylis_seam_latency_log2_seconds The same log2 seam "
        "histograms as cumulative Prometheus buckets."
    )
    out.append("# TYPE jylis_seam_latency_log2_seconds histogram")
    for name in reg.hists:
        seam = _esc(name)
        h = reg.hists[name]
        cum = 0
        for i, c in enumerate(h.buckets):
            cum += c
            out.append(
                f'jylis_seam_latency_log2_seconds_bucket{{seam="{seam}"'
                f',le="{_LE_LABELS[i]}"}} {cum}'
            )
        # +Inf and _count both use the bucket sum (not h.count) so the
        # family is self-consistent even mid-race with a recorder
        out.append(
            f'jylis_seam_latency_log2_seconds_bucket{{seam="{seam}"'
            f',le="+Inf"}} {cum}'
        )
        out.append(
            f'jylis_seam_latency_log2_seconds_count{{seam="{seam}"}} {cum}'
        )
        out.append(
            f'jylis_seam_latency_log2_seconds_sum{{seam="{seam}"}}'
            f" {h.total:.9f}"
        )

    # fleet convergence SLOs (obs/jtrace.py): the fraction of sampled
    # deltas fully applied within each --converge-slo-ms threshold,
    # plus the raw counters the lane aggregator re-derives node-wide
    # fractions from (fractions are not summable; counts are)
    out.append(
        "# HELP jylis_converge_slo Fraction of sampled deltas applied "
        "within le milliseconds end to end."
    )
    out.append("# TYPE jylis_converge_slo gauge")
    slo = reg.spans.slo_fracs()
    for ms, frac, _ in slo:
        out.append(f'jylis_converge_slo{{le="{ms}"}} {frac:.6f}')
    out.append("# TYPE jylis_converge_slo_total counter")
    out.append(
        f'jylis_converge_slo_total{{kind="sampled"}} {reg.spans.sampled}'
    )
    out.append(
        f'jylis_converge_slo_total{{kind="malformed"}} {reg.spans.malformed}'
    )
    for ms, _, ok in slo:
        out.append(f'jylis_converge_slo_total{{kind="ok_{ms}"}} {ok}')

    out.append("# HELP jylis_gauge Node-wide observability gauges.")
    out.append("# TYPE jylis_gauge gauge")
    for name, v in sorted(reg.gauges.items()):
        out.append(f'jylis_gauge{{name="{_esc(name)}"}} {v:.3f}')

    out.append(f"jylis_trace_events {len(reg.trace)}")
    # a scrape is a natural (rate-limited) deposit point for the
    # windowed-quantile marks SYSTEM LATENCY WINDOW subtracts against
    reg.window_deposit()
    return "\n".join(out) + "\n"


class MetricsHTTP:
    """GET /metrics on ``port`` (0 = ephemeral; the bound port is
    `.port`). Anything else is a 404; malformed requests just close.

    ``render_async`` swaps the body producer (an async () -> str): the
    lane supervisor's aggregated endpoint (lanes.py) reuses this whole
    responder — request parse, bounded header drain, status handling —
    with its own multi-lane render."""

    def __init__(self, database, port: int, log=None, render_async=None):
        self._database = database
        self._want_port = port
        self._log = log
        self._server: asyncio.base_events.Server | None = None
        self._render = render_async or self._render_default

    async def _render_default(self) -> str:
        return render(self._database)

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, host=None, port=self._want_port
        )

    @property
    def port(self) -> int:
        assert self._server is not None
        return ipv4_port(self._server)

    async def _handle(self, reader, writer) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=5.0)
            parts = line.split()
            # drain the (ignored) request headers so the client's write
            # half can complete cleanly before we respond — bounded, so
            # a client dripping header lines forever cannot hold this
            # handler task (and its socket) open indefinitely
            for _ in range(128):
                h = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if h in (b"\r\n", b"\n", b""):
                    break
            else:
                return  # header flood: just close
            if len(parts) >= 2 and parts[0] == b"GET" and (
                parts[1] == b"/metrics" or parts[1].startswith(b"/metrics?")
            ):
                body = (await self._render()).encode()
                head = (
                    b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: text/plain; version=0.0.4; charset=utf-8\r\n"
                    b"Content-Length: %d\r\nConnection: close\r\n\r\n"
                    % len(body)
                )
                writer.write(head + body)
            else:
                writer.write(
                    b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n"
                    b"Connection: close\r\n\r\n"
                )
            await writer.drain()
        except (
            OSError,
            ValueError,  # readline: line longer than the stream limit
            asyncio.TimeoutError,
            asyncio.CancelledError,
        ):
            pass
        finally:
            writer.close()

    async def dispose(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
