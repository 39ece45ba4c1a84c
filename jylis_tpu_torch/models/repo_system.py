"""SYSTEM repo: the replicated server log and the node's introspection.

The port's copy of jylis_tpu/models/repo_system.py (:1-310; reference
analog: repo_system.pony:13-64), every subcommand: GETLOG, METRICS,
LATENCY [WINDOW], OBSERVE, TRACE [count], TRACE SPANS, DIGEST [TYPES],
TOPOLOGY and VERSION. One TLog under the pseudo-key "_log"; GETLOG
[count] reads it; the server appends via inslog() with wall-clock
milliseconds and trims via trimlog(). deltas_size() is hard-wired to 1,
so the system-log delta ships on every heartbeat even when empty (a
reference quirk kept for parity).

A Cluster sets ``cluster_fn``, ``lag_fn`` and ``topology_fn`` (the
CLUSTER section of METRICS, the per-peer lag of LATENCY, TOPOLOGY's
peer lines); without one, TOPOLOGY answers with the cluster-less self
line. The Database sets ``session_fn`` and ``overload_fn`` (METRICS'
SESSION and OVERLOAD sections) and main.py sets ``lane_fn`` on a lane
worker (the LANE section: which lane a connection landed on, of how
many).

The log is tiny and host-resident by design.
"""

from __future__ import annotations

import time

from ..ops import hostref
from .base import ParseError, need, parse_opt_count
from .help import LeafHelp

SYSTEM_HELP = LeafHelp(
    "The following are valid SYSTEM commands:\n"
    "  SYSTEM GETLOG [count]\n"
    "  SYSTEM METRICS\n"
    "  SYSTEM LATENCY [WINDOW seconds]\n"
    "  SYSTEM OBSERVE\n"
    "  SYSTEM TRACE [count]\n"
    "  SYSTEM TRACE SPANS\n"
    "  SYSTEM DIGEST [TYPES]\n"
    "  SYSTEM TOPOLOGY\n"
    "  SYSTEM VERSION"
)


def _now_millis() -> int:
    return time.time_ns() // 1_000_000


class RepoSYSTEM:
    name = "SYSTEM"
    help = SYSTEM_HELP

    def __init__(self, identity: int):
        self._identity = identity
        self._log = hostref.TLog()
        self._delta = hostref.TLog()
        # Database wires these to its commands-served totals (METRICS'
        # "cmds" lines) and to the serving split (the SERVING lines)
        self.served_fn = None
        self.serving_fn = None
        # the CLUSTER, SESSION, LANE and OVERLOAD sections, the per-peer
        # convergence lag of LATENCY and the TOPOLOGY view: hooks the
        # cluster (cluster_fn, lag_fn, topology_fn), sessions, lanes and
        # admission set; None means no section
        self.cluster_fn = None
        self.session_fn = None
        self.lag_fn = None
        self.lane_fn = None
        self.overload_fn = None
        self.topology_fn = None
        # the owning Database's MetricsRegistry (obs/registry.py), wired
        # as `metrics` like every repo; None (a standalone RepoSYSTEM)
        # reads the process DEFAULT via resolve_registry
        self.metrics = None
        # the owning Database wires these to its single-threaded digest
        # computation, combined and per type (the async serving path
        # intercepts SYSTEM DIGEST [TYPES] in Database.apply_async
        # instead: it must await the repo locks)
        self.digest_fn = None
        self.digest_types_fn = None

    def apply(self, resp, args: list[bytes]) -> bool:
        op = need(args, 0)
        if op == b"GETLOG":
            count = parse_opt_count(args, 1)
            n = min(count, self._log.size())
            resp.array_start(n)
            for value, ts in self._log.latest(n):
                resp.array_start(2)
                resp.string(value)
                resp.u64(ts)
            return False
        if op == b"METRICS":
            # live serving + merge-path metrics (extension — the
            # reference has no metrics surface at all): one "name key
            # value" line per counter, flat and greppable from any Redis
            # client. "cmds" counts commands served on BOTH paths
            # (native engine + Python); drains/keys/device_ms cover the
            # device merge path
            from ..utils.metrics import metric_lines

            lines = metric_lines(
                self.served_fn() if self.served_fn else None,
                self.serving_fn() if self.serving_fn else None,
                self.cluster_fn() if self.cluster_fn else None,
                registry=self.metrics,
                lane=self.lane_fn() if self.lane_fn else None,
                session=self.session_fn() if self.session_fn else None,
                overload=self.overload_fn() if self.overload_fn else None,
            )
            resp.array_start(len(lines))
            for line in lines:
                resp.string(line)
            return False
        if op == b"LATENCY" and len(args) > 1 and args[1] == b"WINDOW":
            # windowed quantiles: subtract the deposited mark closest to
            # <seconds> ago from the live buckets, so a fresh regression
            # on a long-running node is not drowned by since-boot
            # history. Marks deposit opportunistically on every scrape /
            # LATENCY call (rate-limited in the registry) — the first
            # WINDOW query after boot may report "no window yet".
            try:
                want_s = float(need(args, 2))
            except ValueError:
                raise ParseError() from None
            if want_s <= 0:
                raise ParseError()
            reg = self._registry()
            reg.window_deposit()
            achieved, stats = reg.window_stats(want_s)
            if stats is None:
                resp.array_start(1)
                resp.string(b"no window yet (no mark deposited)")
                return False
            lines = [f"window_s {achieved:.1f}"]
            for name, snap in stats:
                lines.append(
                    f"{name} count {snap['count']}"
                    f" p50_us {snap['p50_s'] * 1e6:.0f}"
                    f" p90_us {snap['p90_s'] * 1e6:.0f}"
                    f" p99_us {snap['p99_s'] * 1e6:.0f}"
                )
            resp.array_start(len(lines))
            for line in lines:
                resp.string(line)
            return False
        if op == b"LATENCY":
            # the latency histograms as one line per seam (count + p50/
            # p90/p99/max in µs), ALL declared seams — a zero count means
            # the seam exists but has not fired, which is itself signal —
            # plus one line per peer with the convergence-lag EWMA
            self._registry().window_deposit()  # feed LATENCY WINDOW
            lines = []
            for name, snap in self._registry().seam_stats():
                lines.append(
                    f"{name} count {snap['count']}"
                    f" p50_us {snap['p50_s'] * 1e6:.0f}"
                    f" p90_us {snap['p90_s'] * 1e6:.0f}"
                    f" p99_us {snap['p99_s'] * 1e6:.0f}"
                    f" max_us {snap['max_s'] * 1e6:.0f}"
                )
            if self.lag_fn is not None:
                for peer, ms in sorted(self.lag_fn().items()):
                    lines.append(f"converge_lag_ms peer {peer} {ms:.1f}")
            resp.array_start(len(lines))
            for line in lines:
                resp.string(line)
            return False
        if op == b"OBSERVE":
            # fleet-convergence + placement telemetry in one greppable
            # view: the --converge-slo-ms attainment fractions (from
            # sampled provenance spans, obs/jtrace.py) and the per-type
            # digest-tree write-heat concentration (manager.py _emit) —
            # which tree buckets absorb the write load, the signal a
            # future placement policy keys on
            reg = self._registry()
            lines = [
                f"converge sampled {reg.spans.sampled}"
                f" malformed {reg.spans.malformed}"
            ]
            for ms, frac, ok in reg.spans.slo_fracs():
                lines.append(f"converge_slo ms {ms} frac {frac:.4f} ok {ok}")
            for name in sorted(reg.write_heat):
                heat = reg.write_heat[name]
                total = sum(heat)
                top = sorted(
                    range(len(heat)), key=heat.__getitem__, reverse=True
                )[:4]
                hot = " ".join(f"{b}:{heat[b]}" for b in top if heat[b])
                lines.append(
                    f"write_heat {name} total {total} top {hot or '-'}"
                )
            resp.array_start(len(lines))
            for line in lines:
                resp.string(line)
            return False
        if op == b"TRACE" and len(args) > 1 and args[1] == b"SPANS":
            # the folded provenance-span view: sampled/malformed totals,
            # per-hop-transition and per-region-pair convergence-latency
            # quantiles, SLO attainment, and the worst-trace exemplar
            # chains (origin -> relay hops -> apply with per-hop offsets)
            lines = self._registry().spans.report_lines()
            resp.array_start(len(lines))
            for line in lines:
                resp.string(line)
            return False
        if op == b"TRACE":
            count = parse_opt_count(args, 1)
            entries = self._registry().trace.dump(count)
            resp.array_start(len(entries))
            from ..obs.trace import TraceRing

            for entry in entries:
                resp.string(TraceRing.format(entry))
            return False
        if op == b"DIGEST":
            # single-threaded path only (warmup/tests/direct drives):
            # the serving path's SYSTEM DIGEST [TYPES] is intercepted by
            # Database.apply_async, which awaits the repo locks
            if len(args) > 1 and args[1] == b"TYPES":
                if self.digest_types_fn is None:
                    raise ParseError()
                rows = self.digest_types_fn()
                resp.array_start(len(rows))
                for name, digest in rows:
                    resp.string(f"{name} {digest.hex()}".encode())
                return False
            if self.digest_fn is None:
                raise ParseError()
            resp.string(self.digest_fn().hex().encode())
            return False
        if op == b"TOPOLOGY":
            # the cluster-aware client's discovery surface: one line for
            # this node (advertised addr, region, bridge role, RESP
            # port) then one per known peer address with the observer's
            # own liveness evidence — enough to route to the nearest
            # replica and to notice a node leaving. Region-less /
            # cluster-less nodes report just themselves.
            if self.topology_fn is None:
                resp.array_start(1)
                resp.string(b"self - region - bridge 0 resp_port 0")
                return False
            lines = self.topology_fn()
            resp.array_start(len(lines))
            for line in lines:
                resp.string(line)
            return False
        if op == b"VERSION":
            from .. import __version__

            resp.string(f"jylis-tpu {__version__}".encode())
            return False
        raise ParseError()

    def _registry(self):
        from ..utils.metrics import resolve_registry

        return resolve_registry(self)

    # -- server-internal (repo_system.pony:56-64) --------------------------

    def inslog(self, line: str) -> None:
        ts = _now_millis()
        value = line.encode()
        self._log.insert(value, ts)
        self._delta.insert(value, ts)

    def trimlog(self, count: int) -> None:
        self._log.trim(count)

    # -- lattice plumbing ---------------------------------------------------

    def deltas_size(self) -> int:
        return 1  # quirk: always ship (repo_system.pony:21)

    def flush_deltas(self):
        out = [(b"_log", (self._delta.latest(), self._delta.cutoff))]
        self._delta = hostref.TLog()
        return out

    def converge(self, key: bytes, delta: tuple) -> None:
        if key != b"_log":
            return
        entries, cutoff = delta
        other = hostref.TLog(entries=list(entries), cutoff=cutoff)
        self._log.converge(other)

    # -- snapshot (persist.py): full state in the wire-delta shape ----------

    def dump_state(self):
        return [(b"_log", (self._log.latest(), self._log.cutoff))]

    def load_state(self, batch) -> None:
        for key, delta in batch:
            self.converge(key, delta)

    def drain(self) -> None:
        pass
