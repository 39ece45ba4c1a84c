"""Config and CLI flag parsing for the serving node.

A reduced copy of jylis_tpu/utils/config.py (itself after the
reference's config.pony:5-97). The flags keep the JAX package's names
and defaults: --port/-p, --addr/-a, --seed-addrs/-s, --heartbeat-time/-T,
--system-log-trim, --log-level/-L, and the cluster's --dial-timeout,
--dial-backoff-cap, --delta-log-cap, --range-budget, --region,
--bridge-demote-ticks, --trace-sample, --converge-slo-ms and
--failpoints, and persistence's --data-dir, --snapshot-interval,
--no-journal, --journal-fsync, --journal-fsync-interval and
--journal-max-bytes. --device picks where the repos' state lives. The
address's 64-bit hash is the node's replica identity; an empty address
name gets a random one, as on a JAX node. The process glue's flags are
the JAX package's too: --session-wait-ms, --admission-cap,
--admission-policy (validated here), --admission-queue-bytes,
--metrics-port, and the lanes' --lanes (an integer or ``auto``),
--lane-id, --lane-bus and --lane-bus-heartbeat; the supervisor passes
each lane the parent's --device verbatim.
"""

from __future__ import annotations

import argparse
import random
import sys
import time
from dataclasses import dataclass, field

from .address import Address
from .log import Log
from .namegen import generate_name


@dataclass
class Config:
    port: str = "6379"
    addr: Address = field(default_factory=lambda: Address.from_string("127.0.0.1:9999:"))
    seed_addrs: list[Address] = field(default_factory=list)
    heartbeat_time: float = 10.0
    system_log_trim: int = 200
    data_dir: str = ""  # snapshot/restore (persist.py)
    snapshot_interval: float = 0.0  # online snapshot cadence
    # delta write-ahead journal (journal/journal.py): on by default
    # whenever data_dir is set; the flags below tune it
    journal: bool = True
    journal_fsync: str = "interval"
    journal_fsync_interval: float = 0.2
    journal_max_bytes: int = 64 << 20
    # peer dial lifecycle (cluster.py): connect timeout in seconds and
    # the exponential-backoff ceiling in heartbeat ticks
    dial_timeout: float = 5.0
    dial_backoff_cap: int = 32
    # anti-entropy tuning (cluster.py): the retransmit window (sequenced
    # delta batches kept for per-peer ack-gap replay) and the
    # range-repair budget (digest-tree buckets pulled per round)
    delta_log_cap: int = 1024
    range_budget: int = 64
    # region-aware WAN peering (cluster.py): empty keeps the full mesh
    region: str = ""
    # heartbeat ticks of received-frame silence after which an observer
    # demotes an address from bridge election
    bridge_demote_ticks: int = 12
    # session guarantees (sessions.py): how long a SESSION READ may
    # wait for its token to be covered before the typed STALE refusal
    session_wait_ms: int = 500
    # per-command-class admission control (models/manager.py): commands
    # of one data type queued behind its repo lock past this cap get a
    # typed BUSY refusal; 0 (default) disables
    admission_cap: int = 0
    # overload armor (admission.py): priority order + the pressure
    # thresholds for node-wide shedding; empty (default) disables
    # shedding (the queued-bytes bound below still applies)
    admission_policy: str = ""
    # hard bound on total un-drained reply bytes across connections: a
    # slow-consumer burst past it gets BUSY on every class; 0 disables
    admission_queue_bytes: int = 256 << 20
    # deterministic fault injection (faults.py), armed at startup
    failpoints: str = ""
    # Prometheus text-exposition endpoint (obs/prom.py); 0 disables, -1
    # asks for an ephemeral port (logged at boot)
    metrics_port: int = 0
    # delta provenance tracing (obs/jtrace.py): one sequenced delta
    # frame in N carries a hop-stamped span; 0 disables minting
    trace_sample: int = 16
    # the fleet-convergence SLO thresholds of the span folds
    converge_slo_ms: str = "50,250,1000"
    # multi-lane serving (lanes.py): N worker processes sharing the RESP
    # port via SO_REUSEPORT, converging over a loopback delta bus.
    # lanes=1 is the single-process node; lane_id is set only in spawned
    # lane workers (None = supervisor / single-lane); lane_bus is every
    # lane's bus port
    lanes: int = 1
    lane_id: int | None = None
    lane_bus: list[int] = field(default_factory=list)
    lane_bus_heartbeat: float = 0.25
    device: str = "cuda"
    log: Log = field(default_factory=Log.create_none)

    def normalize(self) -> None:
        if not self.addr.name:
            rng = random.Random(time.time_ns())
            self.addr = Address(self.addr.host, self.addr.port, generate_name(rng))


def resolve_auto_lanes(cpus: int | None = None) -> int:
    """``--lanes auto``: 1 below 4 host cores (a lane split would just
    contend), else the core count capped at 8."""
    import os

    n = cpus if cpus is not None else (os.cpu_count() or 1)
    return 1 if n < 4 else min(n, 8)


def config_from_cli(
    argv: list[str] | None = None, log_out=None, served_types=()
) -> Config:
    """Parse the node's flags; ``--help`` names ``served_types``."""
    served = f" ({', '.join(served_types)})" if served_types else ""
    parser = argparse.ArgumentParser(
        prog="jylis-tpu-torch",
        description=f"CRDT database on PyTorch and CUDA{served}",
    )
    parser.add_argument(
        "-a", "--addr", default="127.0.0.1:9999:",
        help="The host:port:name to be advertised to other clustering "
        "nodes; its hash is the node's replica identity.",
    )
    parser.add_argument(
        "-p", "--port", default="6379",
        help="The port for accepting commands over RESP-protocol connections.",
    )
    parser.add_argument(
        "-s", "--seed-addrs", default="",
        help="A space-separated list of the host:port:name for other known nodes.",
    )
    parser.add_argument(
        "-T", "--heartbeat-time", type=float, default=10.0,
        help="The number of seconds between heartbeats in the clustering protocol.",
    )
    parser.add_argument(
        "--system-log-trim", type=int, default=200,
        help="The number of entries to retain in the distributed `SYSTEM GETLOG`.",
    )
    parser.add_argument(
        "--data-dir", default="",
        help="Directory for state snapshots: restored on boot, written on "
        "clean shutdown. Empty (default) disables persistence, like the "
        "reference.",
    )
    parser.add_argument(
        "--snapshot-interval", type=float, default=0.0,
        help="Seconds between ONLINE snapshots while serving (requires "
        "--data-dir). 0 (default) snapshots only at clean shutdown; a "
        "crash then loses everything since boot, so long-lived nodes "
        "should set an interval (writes are atomic; each type dumps "
        "under its own lock, so serving never pauses globally).",
    )
    parser.add_argument(
        "--no-journal", action="store_true",
        help="Disable the delta write-ahead journal. With --data-dir the "
        "journal is ON by default: every flushed delta batch appends to "
        "DIR/journal.jylis and is converged back on boot, closing the "
        "crash-loss window between snapshots (docs/durability.md).",
    )
    parser.add_argument(
        "--journal-fsync", choices=("always", "interval", "off"),
        default="interval",
        help="Journal fsync policy: 'always' fsyncs every append, "
        "'interval' fsyncs at most once per --journal-fsync-interval "
        "seconds (bounded power-loss window; a plain process crash loses "
        "nothing under any policy), 'off' leaves syncing to the OS.",
    )
    parser.add_argument(
        "--journal-fsync-interval", type=float, default=0.2,
        help="Seconds between journal fsyncs under --journal-fsync "
        "interval (the power-loss data-at-risk window).",
    )
    parser.add_argument(
        "--journal-max-bytes", type=int, default=64 << 20,
        help="Journal size that triggers compaction: a fresh snapshot is "
        "cut and the old journal segment retired (docs/durability.md).",
    )
    parser.add_argument(
        "--dial-timeout", type=float, default=Config.dial_timeout,
        help="Seconds before an outbound cluster dial attempt is "
        "abandoned. Failed dials back off exponentially up to "
        "--dial-backoff-cap heartbeat ticks.",
    )
    parser.add_argument(
        "--dial-backoff-cap", type=int, default=Config.dial_backoff_cap,
        help="Ceiling, in heartbeat ticks, for the exponential re-dial "
        "backoff to an unreachable peer. Inbound contact from the "
        "address resets its backoff immediately.",
    )
    parser.add_argument(
        "--delta-log-cap", type=int, default=Config.delta_log_cap,
        help="Sequenced delta batches kept in the retransmit window for "
        "per-peer ack-gap replay. A peer whose unacked gap falls off the "
        "window is demoted to digest-tree range repair, never a "
        "whole-state dump.",
    )
    parser.add_argument(
        "--range-budget", type=int, default=Config.range_budget,
        help="Digest-tree buckets (of 256) pulled per range-repair "
        "round: smaller values spread a big heal over more rounds.",
    )
    parser.add_argument(
        "--region", default="",
        help="This node's region name for WAN-aware peering: nodes of "
        "one region keep a full mesh; one deterministic bridge per "
        "region (the smallest live advertised address) dials the other "
        "regions' bridges and relays with origin attribution preserved. "
        "Empty (default) keeps the classic full mesh.",
    )
    parser.add_argument(
        "--bridge-demote-ticks", type=int,
        default=Config.bridge_demote_ticks,
        help="Heartbeat ticks of received-frame silence after which a "
        "node demotes an address from bridge election (regions only).",
    )
    parser.add_argument(
        "--session-wait-ms", type=int, default=Config.session_wait_ms,
        help="Bounded wait for SESSION READ: how long a read holding a "
        "session token may wait for this replica's applied-interval "
        "vector to cover it before the typed STALE refusal.",
    )
    parser.add_argument(
        "--admission-cap", type=int, default=Config.admission_cap,
        help="Per-command-class admission control: commands of one data "
        "type queued behind its repo lock past this cap are refused "
        "with a typed BUSY error. 0 (default) disables.",
    )
    parser.add_argument(
        "--admission-policy", default=Config.admission_policy,
        help="Overload armor: the priority order for node-wide shedding "
        "plus optional pressure thresholds, e.g. "
        "'control>read>write>bulk,lat=25,depth=128,protect=2'. While the "
        "node's declared OVERLOAD state is on, classes below the top "
        "'protect' ranks are refused with a typed BUSY carrying a "
        "retry-after hint. SESSION WRAP/READ classify as their inner "
        "command. Empty (default) disables shedding.",
    )
    parser.add_argument(
        "--admission-queue-bytes", type=int,
        default=Config.admission_queue_bytes,
        help="Hard bound on total un-drained reply bytes across client "
        "connections: past it every command class is refused BUSY until "
        "consumers drain. 0 disables.",
    )
    parser.add_argument(
        "--failpoints", default="",
        help="Deterministic fault injection spec, e.g. "
        "'cluster.dial=error:3' (name=action[:arg[:budget]], "
        "comma-separated; actions: error, sleep, corrupt, crash, drop). "
        "Also read from the JYLIS_FAILPOINTS environment variable. "
        "Empty (default) injects nothing.",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=0,
        help="Serve Prometheus text exposition on this HTTP port "
        "(GET /metrics): the SYSTEM METRICS surface, scrapeable without "
        "a Redis client. -1 binds an ephemeral port (logged at boot); 0 "
        "(default) disables.",
    )
    parser.add_argument(
        "--trace-sample", type=int, default=Config.trace_sample,
        help="Delta provenance tracing: one sequenced delta frame in N "
        "carries a trace span stamped at every hop; the applying node "
        "folds it into convergence-latency histograms (SYSTEM TRACE "
        "SPANS). 0 disables minting (received spans still fold).",
    )
    parser.add_argument(
        "--converge-slo-ms", default=Config.converge_slo_ms,
        help="Comma-separated millisecond thresholds for the "
        "fleet-convergence SLO gauges (SYSTEM OBSERVE).",
    )
    parser.add_argument(
        "--lanes", default="1",
        help="Serving lanes: N worker processes, each a full replica with "
        "its own serving engine, Database, state on --device, journal "
        "segment and metrics, sharing the RESP port via SO_REUSEPORT and "
        "converging over a loopback delta bus. 'auto' picks from the host "
        "core count (1 below 4 cores, else cores capped at 8); 1 "
        "(default) is the single-process node.",
    )
    parser.add_argument(
        "--lane-id", type=int, default=None, help=argparse.SUPPRESS,
    )  # set by the lane supervisor on spawned workers
    parser.add_argument(
        "--lane-bus", default="", help=argparse.SUPPRESS,
    )  # comma-joined bus ports, one per lane, supervisor-set
    parser.add_argument(
        "--lane-bus-heartbeat", type=float, default=0.25,
        help="Heartbeat seconds for the intra-node lane bus (cross-lane "
        "convergence cadence). Only meaningful with --lanes > 1.",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="Torch device that holds the keyspace state (default cuda; "
        "cpu runs the kernels' plain versions).",
    )
    parser.add_argument(
        "-L", "--log-level", default="info",
        help="Maximum level of detail for logging (error, warn, info, or debug).",
    )
    from .. import __version__

    parser.add_argument(
        "--version", action="version", version=f"jylis-tpu-torch {__version__}",
    )
    args = parser.parse_args(argv)
    if args.snapshot_interval > 0 and not args.data_dir:
        parser.error("--snapshot-interval requires --data-dir")

    config = Config()
    config.port = args.port
    config.addr = Address.from_string(args.addr)
    config.seed_addrs = [
        Address.from_string(s) for s in args.seed_addrs.split(" ") if s
    ]
    config.heartbeat_time = args.heartbeat_time
    config.system_log_trim = args.system_log_trim
    config.data_dir = args.data_dir
    config.snapshot_interval = args.snapshot_interval
    config.journal = not args.no_journal
    config.journal_fsync = args.journal_fsync
    config.journal_fsync_interval = args.journal_fsync_interval
    config.journal_max_bytes = args.journal_max_bytes
    config.dial_timeout = args.dial_timeout
    config.dial_backoff_cap = args.dial_backoff_cap
    config.delta_log_cap = args.delta_log_cap
    config.range_budget = args.range_budget
    config.region = args.region
    config.bridge_demote_ticks = args.bridge_demote_ticks
    config.session_wait_ms = args.session_wait_ms
    config.admission_cap = args.admission_cap
    config.admission_policy = args.admission_policy
    if config.admission_policy:
        from ..admission import PolicySpecError, parse_policy

        try:
            parse_policy(config.admission_policy)
        except PolicySpecError as e:
            parser.error(f"--admission-policy: {e}")
    config.admission_queue_bytes = args.admission_queue_bytes
    config.failpoints = args.failpoints
    config.metrics_port = args.metrics_port
    if args.trace_sample < 0:
        parser.error("--trace-sample must be >= 0")
    config.trace_sample = args.trace_sample
    try:
        slo = [int(s) for s in args.converge_slo_ms.split(",") if s.strip()]
    except ValueError:
        slo = None
    if not slo or any(ms <= 0 for ms in slo):
        parser.error(
            "--converge-slo-ms must be comma-separated positive "
            f"milliseconds: {args.converge_slo_ms!r}"
        )
    config.converge_slo_ms = args.converge_slo_ms
    if args.lanes == "auto":
        config.lanes = resolve_auto_lanes()
    else:
        try:
            config.lanes = int(args.lanes)
        except ValueError:
            parser.error(f"--lanes must be an integer or 'auto': {args.lanes}")
        if config.lanes < 1:
            parser.error("--lanes must be >= 1")
    config.lane_id = args.lane_id
    config.lane_bus = [int(p) for p in args.lane_bus.split(",") if p]
    config.lane_bus_heartbeat = args.lane_bus_heartbeat
    if config.lane_id is not None and len(config.lane_bus) != config.lanes:
        parser.error("--lane-id requires --lane-bus with one port per lane")
    config.device = args.device
    level = {"error": "err", "warn": "warn", "info": "info", "debug": "debug"}.get(
        args.log_level
    )
    if level is None:
        print(f"Unknown log-level: {args.log_level}")
        sys.exit(1)
    config.log = Log(level, log_out)

    config.normalize()
    return config
