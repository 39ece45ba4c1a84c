"""Multi-lane serving: shard the node across host cores.

The port's copy of jylis_tpu/lanes.py. Two things differ. A lane child
gets the parent's ``--device`` verbatim (``Supervisor._child_argv``),
where the JAX supervisor passes its JAX platform through the
environment; each lane resolves it as a single node does
(models/database.py ``resolve_device``, parallel/mesh.py
``resolve_mesh``), so a lane asked for ``cuda`` on a host without a card
exits non-zero and none falls back to the CPU. And on a card every lane
is a full replica with its own CUDA context and its own planes on the
device, so N lanes hold N copies of the state there. The supervisor
itself never touches the device: it only spawns, watches, restarts and
aggregates, and holds no state. ``snapshot_name`` and
``list_snapshots`` live in persist.py.

One asyncio loop plus the GIL is the hard ceiling behind the recorded
``vs_one_conn = 1.01`` (BENCH_full.json ``concurrent``: 64 connections
served no faster than one). This module runs a node as N serving
**lanes** — worker processes, each owning a complete serving stack
(ServeEngine, Database, journal segment, MetricsRegistry — the
per-Database registry refactor exists precisely so N databases coexist
cleanly) — sharing the RESP port via ``SO_REUSEPORT`` so the kernel
shards accepted connections across lanes with no userspace acceptor.

Convergence across lanes is the paper's own masterless-replica argument
applied across cores within one node: each lane is a delta-CRDT replica
(its OWN replica identity, derived from its bus address), and lanes
converge over a loopback **delta bus** that is literally the existing
cluster engine (``cluster/Cluster``) on ephemeral loopback ports — wire
framing, CRC, delta broadcast, digest-checked sync-on-rejoin, dial
backoff, all inherited. A command lands on whatever lane the kernel
picked; a key "owned" by another lane (``lane_of``) applies locally
(the client's ack never waits on a cross-lane hop) and the delta rides
the bus to every sibling, so reads serve-after-converge on any lane
within the proactive-flush cadence. CRDT join makes all of this
coordination-free: no lane ever blocks on another.

**One cluster identity.** Externally the node is still ONE member: lane
0 runs the ordinary external Cluster on ``config.addr`` alongside its
bus instance, and bridges the two meshes — database flushes tee to
both, inbound external deltas relay onto the bus, inbound lane deltas
relay out to external peers (converge never re-exports, so the relay
cannot echo). Remote nodes see one address and a digest-complete
replica; the lane topology is invisible on the wire.

**Durability.** Each lane journals the batches ITS serving path flushed
into its own segment (``journal.lane<k>.jylis``) — segments are
disjoint by acceptance and their union is the node's journaled state.
Boot replays all segments (merge replay; see ``journal.recover_all``
for the live-sibling safety rules) and lane-restart gaps heal over the
bus sync exactly like a node rejoining a cluster.

The **supervisor** (the ``--lanes N`` process) spawns and monitors the
lane workers, restarts crashed lanes with a bounded backoff, forwards
signals, records ``lanes.json`` (pids and ports — what the drill
matrix SIGKILLs), and — when ``--metrics-port`` is set — serves an
aggregated Prometheus endpoint that scrapes every lane, re-labels
samples with ``lane="k"``, and emits summed aggregate series for the
counter families.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import signal
import subprocess
import sys

from .obs import jtrace
from .obs.prom import MetricsHTTP
from .utils.address import Address, fnv1a64
from .utils.net import free_port, listen_port

# env var: "<lane>:<failpoint spec>;<lane>:<spec>" — the supervisor
# merges each lane's spec into that CHILD's JYLIS_FAILPOINTS env (the
# drill matrix arms a crash in exactly one lane this way); the
# supervisor's own JYLIS_FAILPOINTS still propagates to every lane.
LANE_FAILPOINTS_ENV = "JYLIS_LANE_FAILPOINTS"

MANIFEST_NAME = "lanes.json"

# lane respawn backoff: first restart is quick (a drill kill should
# heal in ~a second), a crash-looping lane is bounded at the cap
RESTART_BACKOFF_S = 0.5
RESTART_BACKOFF_CAP_S = 10.0


def lane_of(key: bytes, n_lanes: int) -> int:
    """The lane whose keyspace slice ``key`` hashes into — stable
    FNV-1a, so every lane (and every client library that wants
    lane-affine connections) computes the same owner."""
    if n_lanes <= 1:
        return 0
    return fnv1a64(key) % n_lanes


def bus_address(config, lane_id: int) -> Address:
    """Lane ``lane_id``'s bus address: loopback, its assigned bus
    port, and a ``name#laneK`` suffix on the node's advertised name.
    Transport only — the lane's CRDT replica identity is
    ``lane_identity`` below, which must NOT involve the (ephemeral)
    bus port."""
    return Address(
        "127.0.0.1",
        str(config.lane_bus[lane_id]),
        f"{config.addr.name}#lane{lane_id}",
    )


def lane_identity(config, lane_id: int) -> int:
    """The lane's CRDT replica identity: the node's STABLE advertised
    address plus the lane ordinal. Every lane must be a distinct
    replica (two lanes sharing an identity would clobber each other's
    counter columns on converge), and the identity must be stable
    across restarts — deriving it from the ephemeral bus port would
    mint N brand-new replica ids per reboot, growing every counter's
    replica columns (and the wire/journal/device footprint) forever."""
    return Address(
        config.addr.host, config.addr.port,
        f"{config.addr.name}#lane{lane_id}",
    ).hash64()


def bus_config(config, lane_id: int):
    """The derived Config the lane's bus Cluster runs on: bus address,
    the sibling lanes as seeds, and the (fast) bus heartbeat."""
    from .utils.config import Config

    cfg = Config()
    cfg.port = config.port
    cfg.addr = bus_address(config, lane_id)
    cfg.seed_addrs = [
        bus_address(config, j)
        for j in range(config.lanes)
        if j != lane_id
    ]
    cfg.heartbeat_time = config.lane_bus_heartbeat
    cfg.system_log_trim = config.system_log_trim
    cfg.dial_timeout = config.dial_timeout
    cfg.dial_backoff_cap = config.dial_backoff_cap
    # the bus instance MINTS session tokens (it is the driving cluster
    # that binds the lane's SessionIndex), so it needs the boot-epoch
    # sidecar floor too: the supervisor reuses bus ports across lane
    # respawns, and without the floor a backwards clock step across a
    # respawn could re-mint a used epoch and alias the old stream
    # (review find). Across SUPERVISOR restarts the ports (and so the
    # rids) change anyway, which is safe by construction.
    cfg.data_dir = config.data_dir
    # the bus is where a lane's sequenced flushes originate, so the
    # operator's provenance sample rate must reach it (a fresh Config
    # would silently reset it to the default)
    cfg.trace_sample = config.trace_sample
    cfg.log = config.log
    return cfg


def wire_bridge(bus, external) -> None:
    """Lane 0's two-mesh bridge. The bus instance drives the one
    database flush and tees it to both meshes; each mesh relays the
    first-sight pushes it converged onto the other. Relay cannot echo:
    the session index's first-sight check dedupes per (origin, seq),
    and only lane 0 relays.

    Schema v10: relays preserve ORIGIN attribution (MsgRelayPush). The
    tee ships the lane's own flush into the external mesh under its bus
    rid + bus seq — so an external peer's applied vector tracks the
    exact stream a token minted on this lane references — and each
    mesh's converged sequenced pushes cross over with their origin
    rid/seq intact. Unsequenced sync data (origin None) still crosses
    as a plain broadcast: it advances no session watermark, but keeps
    rejoin heals flowing between the meshes at the old cadence."""

    def tee(deltas) -> None:
        origin, oseq = bus.broadcast_deltas(deltas)
        if origin is not None:
            # carry the bus flush's sampled span (schema v11) onto the
            # external leg: last_span is set synchronously by the
            # broadcast above, so the SAME chain crosses both meshes
            external.relay_deltas(origin, oseq, deltas, bus.last_span)
        else:
            # content-free keepalives: the broadcast path's own
            # unsequenced branch handles them
            external.broadcast_deltas(deltas)

    def relay_to(other):
        def relay(origin, oseq, name, batch, span=b"") -> None:
            if origin is not None:
                other.relay_deltas(origin, oseq, (name, batch), span)
            else:
                # relayed SYNC data (rejoin heals, range repairs):
                # UNSEQUENCED on purpose — re-originating it as
                # `other`'s own stream would consume own-content
                # ordinals that the far side of the bridge can never
                # observe, stranding tokens that reference them
                other.push_unsequenced((name, batch))

        return relay

    bus.flush_sink = tee
    bus.on_push = relay_to(external)
    external.on_push = relay_to(bus)
    # hop-tag the two legs so a chain reads origin -> bus -> cluster
    # (obs/jtrace.py): the bus instance's relays are the intra-node
    # lane fan-out, the external instance's are the WAN leg
    bus.relay_hop = jtrace.HOP_BUS
    external.relay_hop = jtrace.HOP_CLUSTER


class LaneClusters:
    """The lane worker's cluster handle for Dispose: one dispose() over
    the bus instance and (on lane 0) the external instance."""

    def __init__(self, *clusters):
        self.clusters = [c for c in clusters if c is not None]

    async def start(self) -> None:
        for c in self.clusters:
            await c.start()

    def dispose(self) -> None:
        for c in self.clusters:
            c.dispose()


# ---- the supervisor ---------------------------------------------------------


def _parse_lane_failpoints(spec: str) -> dict[int, str]:
    out: dict[int, str] = {}
    for item in spec.split(";"):
        item = item.strip()
        if not item or ":" not in item:
            continue
        lane, fspec = item.split(":", 1)
        try:
            out[int(lane)] = fspec
        except ValueError:
            continue
    return out


class Supervisor:
    def __init__(self, config, argv: list[str] | None):
        self.config = config
        self.argv = list(argv or [])
        self.log = config.log
        self.n = config.lanes
        self.resp_port = int(config.port) or free_port()
        # a lane binds its bus and metrics ports again when it respawns:
        # ports below the ephemeral range, which no outgoing connection
        # can take while the lane is down
        taken: list[int] = []
        for _ in range(self.n * (2 if config.metrics_port else 1)):
            taken.append(listen_port(taken))
        self.bus_ports = taken[:self.n]
        self.metrics_ports = taken[self.n:] or [0] * self.n
        self.procs: list[subprocess.Popen | None] = [None] * self.n
        self.restarts = [0] * self.n
        self._lane_failpoints = _parse_lane_failpoints(
            os.environ.get(LANE_FAILPOINTS_ENV, "")
        )
        self._shutdown = False
        self._manifest_lock = asyncio.Lock()
        self.done = asyncio.Event()

    # ---- spawning ---------------------------------------------------------

    def _child_argv(self, lane_id: int) -> list[str]:
        # later occurrences override earlier ones under argparse, so the
        # original argv rides along verbatim and the lane overrides
        # append — the child reparses the exact operator intent plus
        # the supervisor's resolved ports, the (possibly generated)
        # node name and the parent's device, verbatim: each lane resolves
        # it as a single node does, and none falls back to the CPU
        return [
            sys.executable, "-m", "jylis_tpu_torch", *self.argv,
            "--lanes", str(self.n),
            "--lane-id", str(lane_id),
            "--lane-bus", ",".join(str(p) for p in self.bus_ports),
            "--port", str(self.resp_port),
            "--addr", str(self.config.addr),
            "--metrics-port", str(self.metrics_ports[lane_id]),
            "--device", str(self.config.device),
        ]

    def _child_env(self, lane_id: int) -> dict:
        env = dict(os.environ)
        extra = self._lane_failpoints.get(lane_id)
        if extra:
            base = env.get("JYLIS_FAILPOINTS", "")
            env["JYLIS_FAILPOINTS"] = f"{base},{extra}" if base else extra
        return env

    def _spawn(self, lane_id: int) -> None:
        self.procs[lane_id] = subprocess.Popen(
            self._child_argv(lane_id), env=self._child_env(lane_id)
        )
        self.log.info() and self.log.i(
            f"lane {lane_id} pid {self.procs[lane_id].pid} "
            f"(bus :{self.bus_ports[lane_id]})"
        )

    def write_manifest(self) -> None:
        """``DIR/lanes.json``: who serves which lane right now — the
        drill matrix (and operators) SIGKILL by these pids."""
        if not self.config.data_dir:
            return
        manifest = {
            "port": self.resp_port,
            "metrics_port": self.config.metrics_port,
            "supervisor_pid": os.getpid(),
            "lanes": [
                {
                    "id": k,
                    "pid": p.pid if p is not None else None,
                    "bus_port": self.bus_ports[k],
                    "metrics_port": self.metrics_ports[k],
                }
                for k, p in enumerate(self.procs)
            ],
        }
        path = os.path.join(self.config.data_dir, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, path)

    async def write_manifest_async(self) -> None:
        """The supervisor-loop entry: the write-then-rename runs in a
        worker thread. The loop this method runs on carries every
        lane's death-watcher, signal handling, and the aggregated
        metrics endpoint — jlint's interprocedural JL101 caught the
        previous direct call: a contended disk during a crash-respawn
        storm stalled all three behind the manifest write. The lock
        restores what the on-loop call had implicitly: two lanes dying
        near-simultaneously must not interleave writes on the one
        fixed ``lanes.json.tmp`` path."""
        async with self._manifest_lock:
            await asyncio.to_thread(self.write_manifest)

    # ---- lifecycle --------------------------------------------------------

    async def run(self) -> None:
        if self.config.data_dir:
            # jlint: blocking-ok — startup, before any lane or client exists
            os.makedirs(self.config.data_dir, exist_ok=True)
        for k in range(self.n):
            self._spawn(k)
        await self.write_manifest_async()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, self._on_signal)
        aggregator = None
        if self.config.metrics_port:
            aggregator = LaneMetricsAggregator(
                max(self.config.metrics_port, 0), self.metrics_ports, self.log
            )
            await aggregator.start()
            self.log.info() and self.log.i(
                f"aggregated metrics endpoint on port: {aggregator.port}"
            )
        self.log.info() and self.log.i(
            f"serving {self.n} lanes on port: {self.resp_port}"
        )
        stop_waiter = asyncio.ensure_future(self.done.wait())
        waiters = {
            k: asyncio.ensure_future(self._wait_lane(k))
            for k in range(self.n)
        }
        try:
            while not self._shutdown:
                await asyncio.wait(
                    set(waiters.values()) | {stop_waiter},
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if self._shutdown:
                    break
                for k in list(waiters):
                    if waiters[k].done():
                        # backoff + respawn runs INSIDE the lane's own
                        # waiter chain: one crash-looping lane's 10 s
                        # backoff must not delay observing another
                        # lane's death (or a shutdown signal)
                        waiters[k] = asyncio.ensure_future(
                            self._respawn_then_wait(k)
                        )
        finally:
            stop_waiter.cancel()
            for t in waiters.values():
                t.cancel()
            if aggregator is not None:
                await aggregator.dispose()
            await self._stop_all()

    async def _wait_lane(self, lane_id: int) -> int:
        proc = self.procs[lane_id]
        assert proc is not None
        return await asyncio.to_thread(proc.wait)

    async def _respawn_then_wait(self, lane_id: int) -> int:
        await self._lane_died(lane_id)
        if self._shutdown:
            return 0
        return await self._wait_lane(lane_id)

    async def _lane_died(self, lane_id: int) -> None:
        proc = self.procs[lane_id]
        rc = proc.returncode if proc is not None else None
        if rc == 86 and lane_id in self._lane_failpoints:
            # faults.CRASH_EXIT_CODE: the lane died to ITS injected
            # failpoint. Env arming re-reads at import, so respawning
            # with the spec intact would re-arm it and crash-loop the
            # lane by construction — per-lane injected specs are
            # one-shot: the respawn comes up clean (the drill's heal).
            del self._lane_failpoints[lane_id]
            self.log.info() and self.log.i(
                f"lane {lane_id}: injected failpoint spec cleared after crash"
            )
        self.restarts[lane_id] += 1
        backoff = min(
            RESTART_BACKOFF_S * (2 ** (self.restarts[lane_id] - 1)),
            RESTART_BACKOFF_CAP_S,
        )
        self.log.warn() and self.log.w(
            f"lane {lane_id} died (rc {rc}); respawning in {backoff:.1f}s"
        )
        await asyncio.sleep(backoff)
        if self._shutdown:
            return
        self._spawn(lane_id)
        await self.write_manifest_async()

    def _on_signal(self) -> None:
        self._shutdown = True
        self.done.set()

    async def _stop_all(self) -> None:
        for proc in self.procs:
            if proc is not None and proc.poll() is None:
                try:
                    proc.terminate()
                except OSError:
                    pass
        for proc in self.procs:
            if proc is None:
                continue
            try:
                await asyncio.wait_for(asyncio.to_thread(proc.wait), 60.0)
            except asyncio.TimeoutError:
                proc.kill()
                await asyncio.to_thread(proc.wait)


async def run_supervisor(config, argv: list[str] | None) -> None:
    await Supervisor(config, argv).run()


# ---- aggregated Prometheus endpoint ----------------------------------------

# one exposition sample: name, optional {labels}, value
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (-?[0-9.eE+-]+)$"
)

# families whose samples are counters and therefore sum across lanes
# into the aggregate (no lane label) series; quantile summaries and
# gauges stay per-lane only — summing a p99 is not a p99. Cumulative
# histogram buckets (`_bucket`) SUM correctly by definition — that is
# the whole point of exporting them — so the aggregate scrape carries
# a real fleet-level histogram per seam.
_SUMMABLE = re.compile(
    r"(_total$|_count$|_sum$|_bucket$|^jylis_trace_events$)"
)

_SLO_OK_RE = re.compile(r'kind="ok_(\d+)"')


def aggregate_expositions(bodies: dict[int, str | None]) -> str:
    """Merge per-lane scrape bodies: every sample re-labeled with
    ``lane="k"``, counter families additionally summed into aggregate
    (lane-less) series, and a ``jylis_lane_up`` gauge per lane (0 for a
    lane whose scrape failed — mid-restart, typically)."""
    out: list[str] = []
    sums: dict[tuple[str, str], float] = {}
    meta_done: set[str] = set()
    for lane_id in sorted(bodies):
        body = bodies[lane_id]
        if body is None:
            continue
        for line in body.splitlines():
            if not line:
                continue
            if line.startswith("#"):
                # HELP/TYPE once, from the first live lane that has it
                key = " ".join(line.split()[:3])
                if key not in meta_done:
                    meta_done.add(key)
                    out.append(line)
                continue
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue  # defensive: never re-emit an invalid line
            name, labels, value = m.group(1), m.group(2) or "", m.group(3)
            if labels:
                relabeled = f'{name}{{lane="{lane_id}",{labels[1:]}'
            else:
                relabeled = f'{name}{{lane="{lane_id}"}}'
            out.append(f"{relabeled} {value}")
            if _SUMMABLE.search(name):
                try:
                    sums[(name, labels)] = sums.get((name, labels), 0.0) + float(value)
                except ValueError:
                    pass
    for (name, labels), v in sorted(sums.items()):
        text = f"{v:.9f}".rstrip("0").rstrip(".") if "." in f"{v:.9f}" else str(v)
        out.append(f"{name}{labels} {text}")
    # fleet-level convergence SLO: the per-lane jylis_converge_slo
    # gauges are fractions (not summable), but their ok/sampled
    # NUMERATORS are counters we just summed — recompute the node-wide
    # fraction from the aggregate counts, which weights lanes by their
    # actual sample volume instead of averaging ratios
    sampled = sums.get(("jylis_converge_slo_total", '{kind="sampled"}'), 0.0)
    for (name, labels), v in sorted(sums.items()):
        if name != "jylis_converge_slo_total":
            continue
        m = _SLO_OK_RE.search(labels)
        if m is not None:
            frac = v / sampled if sampled > 0 else 0.0
            out.append(
                f'jylis_converge_slo{{le="{m.group(1)}"}} {frac:.6f}'
            )
    out.append("# TYPE jylis_lane_up gauge")
    for lane_id in sorted(bodies):
        up = 1 if bodies[lane_id] is not None else 0
        out.append(f'jylis_lane_up{{lane="{lane_id}"}} {up}')
    return "\n".join(out) + "\n"


class LaneMetricsAggregator(MetricsHTTP):
    """GET /metrics on the supervisor's port: scrape every lane's own
    endpoint, merge per ``aggregate_expositions``. A lane that fails to
    answer (crashed, restarting) shows up as ``jylis_lane_up 0`` rather
    than failing the whole scrape. The HTTP responder itself is
    obs/prom.py's MetricsHTTP with this class's render swapped in."""

    def __init__(self, port: int, lane_ports: list[int], log=None):
        super().__init__(None, port, log, render_async=self.render)
        self._lane_ports = lane_ports

    async def _fetch(self, port: int) -> str | None:
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection("127.0.0.1", port), 5.0
            )
        except (OSError, asyncio.TimeoutError):
            return None
        try:
            writer.write(
                b"GET /metrics HTTP/1.1\r\nHost: lane\r\n"
                b"Connection: close\r\n\r\n"
            )
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), 10.0)
        except (OSError, asyncio.TimeoutError):
            return None
        finally:
            writer.close()
        head, sep, body = raw.partition(b"\r\n\r\n")
        if not sep or b" 200 " not in head.split(b"\r\n", 1)[0]:
            return None
        return body.decode(errors="replace")

    async def render(self) -> str:
        bodies = dict(
            zip(
                range(len(self._lane_ports)),
                await asyncio.gather(
                    *(self._fetch(p) for p in self._lane_ports)
                ),
            )
        )
        return aggregate_expositions(bodies)
