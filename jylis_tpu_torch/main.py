"""Process entry point: ``python -m jylis_tpu_torch --port P``.

Wires the node in the JAX package's order (jylis_tpu/main.py, after the
reference's main.pony): Config -> failpoints (``--failpoints``) ->
System (the log's dual sink into the SYSTEM log) -> ``warmup`` (every
serving kernel and the native library built, and the serving paths
launched once on the node's device) -> Database (the native serving
engine, which settles RESP bursts in C++; the eight types of
``models.database.DATA_REPO_CLASSES`` and SYSTEM, on ``--device``,
default cuda; keys-sharded over every card when the device names no card
and the host has more than one) -> RESP Server -> Cluster (gossip
membership and anti-entropy with the peers of ``--seed-addrs``, JAX
nodes included). With ``--data-dir`` the node restores every snapshot
there and replays its journal (persist.py, journal/) on its device
between the Database and the Server, so nothing listens before recovery
ends; the journal then takes every flushed delta batch, and
``_snapshot_loop`` writes online snapshots (``--snapshot-interval``) and
compacts the journal when it outgrows ``--journal-max-bytes``. On
SIGINT/SIGTERM ``Dispose`` stops intake, makes the final flush to peers
under the repo locks, writes the shutdown snapshot and retires the
journal, ends the profiler's session (``JYLIS_PROFILE_DIR``: from
``serve`` on, the node's CPU and CUDA activity with the registry's spans
as ranges, utils/metrics.py), closes the journal and stops the cluster
and the listener (after dispose.pony). ``build_node`` hooks the node's
registry into ``gc.callbacks`` (its ``gc.full`` span) and ``Dispose``
unhooks it. ``build_node`` does the wiring and the recovery and
``serve`` starts the listeners and the snapshot loop; ``run`` is the two
with the signal handlers, and other drivers (chip_smoke.py's cluster and
persistence phases) call the same two.

The process glue (jylis_tpu/main.py:146-388): the Database takes
``--session-wait-ms``, ``--admission-cap`` and the overload armor
(``--admission-policy``, ``--admission-queue-bytes``);
``--metrics-port`` serves the Prometheus exposition (obs/prom.py). With
``--lanes N`` (N > 1) this process becomes the lane supervisor
(lanes.py): it prints the logo, spawns N lane workers of this module,
each with the parent's ``--device``, restarts a lane that dies and
aggregates their metrics endpoints; it never touches the device. A lane
worker (``--lane-id``) is a full replica with its own identity
(``lanes.lane_identity``), its own snapshot and journal segment
(``snapshot.lane<k>.jylis``, ``journal.lane<k>.jylis``; boot restores
every lane's files), the lane bus (a Cluster on loopback with its
sibling lanes) and, on lane 0, the node's one external cluster identity
bridged to the bus; its SYSTEM METRICS has a LANE section, and the
``lane.tick`` failpoint fires in it every 0.25 s. On an unclean exit the
trace ring goes to stderr (``_dump_trace``).
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import signal
import sys

from . import faults
from . import journal as journal_mod
from . import lanes as lanes_mod
from . import persist
from .cluster import Cluster
from .models import database as database_mod
from .models.database import SERVED_TYPES, Database
from .server.server import Server
from .system import System
from .utils import metrics
from .utils.config import config_from_cli
from .utils.logo import LOGO


class Dispose:
    """Idempotent clean shutdown (dispose.pony:12-19): first drain
    every repo's remaining deltas to peers, snapshot if configured, then
    stop the listeners."""

    def __init__(self, database: Database, server: Server, cluster: Cluster,
                 snapshot_path: str = "", log=None, journal=None, launched=None):
        self._database = database
        # the kernel launch counts, in all and by card, the shutdown log
        # line counts from (the warmup's launches are not the node's)
        self._launched = launched or ({}, {})
        self._server = server
        self._cluster = cluster
        self._snapshot_path = snapshot_path
        self._log = log
        self._journal = journal
        self._disposing = False
        self._shutdown_task: asyncio.Task | None = None
        self.snapshot_task: asyncio.Task | None = None  # online snapshot loop
        # the loop's in-flight write future: cancelling the task does not
        # stop a to_thread worker, so shutdown awaits this too
        self.snapshot_inflight: dict = {"write": None}
        # the registry's gc.callbacks hook that build_node added (serve)
        self.gc_hook = None
        self.done = asyncio.Event()

    def on_signal(self) -> None:
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, self.dispose)

    def dispose(self) -> None:
        if self._disposing:
            return
        self._disposing = True
        # signal callback: stop intake now, then run the lock-holding
        # shutdown as a task (the loop keeps only a weak ref to tasks)
        self._database.stop_intake()
        self._shutdown_task = asyncio.get_running_loop().create_task(
            self._shutdown()
        )

    async def _shutdown(self) -> None:
        # a drain can raise at shutdown; the listeners must still stop
        # and `done` must still be set
        try:
            # the online snapshot loop must be fully stopped before the
            # shutdown snapshot runs (both write path.tmp): cancel the
            # task, then await any write worker it had in flight
            if self.snapshot_task is not None:
                self.snapshot_task.cancel()
                try:
                    await self.snapshot_task
                except asyncio.CancelledError:
                    pass
                inflight = self.snapshot_inflight.get("write")
                if inflight is not None:
                    await asyncio.wait([inflight])
            # the final flush rides broadcast_deltas; per-repo locks wait
            # out threaded drains and fence off late-queued commands
            await self._database.clean_shutdown_async()
            if self._snapshot_path:
                try:
                    async with self._database.all_locks():
                        await asyncio.to_thread(
                            persist.save_snapshot, self._database,
                            self._snapshot_path,
                        )
                    if self._journal is not None:
                        # the shutdown snapshot (final flush included)
                        # supersedes the whole journal: retire it, so the
                        # next boot replays nothing. On a failed snapshot
                        # the journal stays, the only copy of its deltas
                        await asyncio.to_thread(self._journal.rotate_begin)
                        await asyncio.to_thread(self._journal.rotate_commit)
                except Exception as e:  # a dump's drain can raise
                    # anything; it is logged and the listeners still stop
                    if self._log is not None:
                        self._log.err() and self._log.e(f"snapshot failed: {e}")
            if self._log is not None:
                self._log.info() and self._log.i(
                    f"merge metrics: {self._database.metrics.report()}"
                )
                launched, by_card = metrics.launches_since(*self._launched)
                self._log.info() and self._log.i(
                    f"kernel launches since warmup (pid {os.getpid()}): "
                    f"{json.dumps(launched)}; by card: {json.dumps(by_card)}"
                )
            metrics.stop_profiling()
        finally:
            if self.gc_hook in gc.callbacks:
                gc.callbacks.remove(self.gc_hook)
            if self._journal is not None:
                # close() joins the writer thread and fsyncs: off the
                # loop. A full disk can make it raise; the listeners
                # must still stop and `done` must still be set
                try:
                    await asyncio.to_thread(self._journal.close)
                except OSError as e:
                    if self._log is not None:
                        self._log.err() and self._log.e(
                            f"journal close failed: {e}"
                        )
            self._cluster.dispose()
            await self._server.dispose()
            self.done.set()


class NodeStack:
    """One node's parts, wired by ``build_node`` and not yet listening."""

    def __init__(self, config, system, database, server, cluster,
                 snapshot_path: str = "", journal=None, warmup_launches=None):
        self.config = config
        self.system = system
        self.database = database
        self.server = server
        self.cluster = cluster
        self.snapshot_path = snapshot_path  # "" without --data-dir
        self.journal = journal  # None without --data-dir or with --no-journal
        # each kernel's launches, in all and by card, by the end of warmup
        # (the shutdown log line counts the node's own from there:
        # recovery's and serving's)
        self.warmup_launches = warmup_launches or ({}, {})
        # set by serve: the Prometheus listener (--metrics-port) and a
        # lane's lane.tick failpoint task
        self.metrics_http = None
        self.lane_tick_task = None


def build_node(config) -> NodeStack:
    """Wire a node (or one lane worker) in the JAX package's order:
    Config -> failpoints -> System -> ``warmup`` (every serving kernel and
    the native library built, and the serving paths launched once on the
    node's device, before anything listens) -> Database (with the native
    serving engine, the session and admission knobs) -> recovery from
    ``--data-dir`` (``recover``) -> Server -> Cluster; on a lane, the lane
    bus and, on lane 0, the external Cluster bridged to it."""
    if config.failpoints:
        faults.arm_spec(config.failpoints)
    lane_id = config.lane_id
    if lane_id is not None:
        # each lane is a distinct replica with a restart-stable identity
        # (the advertised address + the lane ordinal)
        identity = lanes_mod.lane_identity(config, lane_id)
    else:
        identity = config.addr.hash64()
    system = System(config)
    database_mod.warmup(config.device, engine="auto")
    warmup_launches = (metrics.kernel_launches(), metrics.kernel_launches_by_card())
    database = Database(
        identity=identity, device=config.device,
        system_repo=system.repo, engine="auto",
    )
    database.session_wait_ms = config.session_wait_ms
    database.set_admission_cap(config.admission_cap)
    database.set_admission(config.admission_policy, config.admission_queue_bytes)
    database.metrics.spans.set_slo_ms(
        int(s) for s in config.converge_slo_ms.split(",") if s.strip()
    )
    # each full collection is a gc.full span of this node's registry
    gc.callbacks.append(database.metrics.gc_callback)
    if lane_id is not None:
        # SYSTEM METRICS' LANE section: which lane this connection landed
        # on, out of how many
        system.repo.lane_fn = lambda: {"id": lane_id, "count": config.lanes}
    snapshot_path, journal = recover(config, database)
    server = Server(config, database)
    if lane_id is None:
        cluster = Cluster(config, database)
    else:
        # the lane bus: the cluster engine on loopback with the sibling
        # lanes; lane 0 also runs the node's one external cluster
        # identity and bridges the two meshes
        bus = Cluster(lanes_mod.bus_config(config, lane_id), database,
                      register_system=(lane_id != 0))
        external = None
        if lane_id == 0:
            external = Cluster(config, database, drive_flush=False)
            lanes_mod.wire_bridge(bus, external)
        cluster = lanes_mod.LaneClusters(bus, external)
    return NodeStack(config, system, database, server, cluster,
                     snapshot_path, journal, warmup_launches)


def recover(config, database) -> tuple[str, object]:
    """Boot recovery (jylis_tpu/main.py:212-274): restore every snapshot
    in ``config.data_dir`` (every lane's) and replay every journal
    segment on the node's device, then open the node's own segment
    (``journal.lane<k>.jylis`` on lane k) and attach it. Returns the
    snapshot path ("" without a data dir) and the journal (None without
    a data dir or with ``--no-journal``). Runs before anything listens,
    so its disk reads and drains stall no client. A snapshot or segment
    that will not load is logged and moved aside as ``.unreadable``;
    a drain that fails on the card raises."""
    if not config.data_dir:
        return "", None
    log = config.log
    os.makedirs(config.data_dir, exist_ok=True)
    snapshot_path = os.path.join(config.data_dir,
                                 persist.snapshot_name(config.lane_id))
    # every snapshot present, every lane's: restore is lattice
    # convergence, so overlap is a no-op and a changed --lanes strands
    # nothing. Only the node's own file is moved aside when unreadable (a
    # sibling lane may be alive and writing its own)
    for spath in persist.list_snapshots(config.data_dir):
        try:
            n = persist.load_snapshot(database, spath)
            log.info() and log.i(f"snapshot restored ({n} type batches, {spath})")
        except persist.SnapshotError as e:
            log.err() and log.e(f"snapshot not restored: {e}")
            if spath != snapshot_path:
                continue
            # the next clean shutdown writes snapshot_path fresh: keep
            # the only copy of the un-restored data
            aside = spath + ".unreadable"
            try:
                os.replace(spath, aside)
                log.err() and log.e(f"moved aside to {aside}")
            except OSError:
                pass
    if not config.journal:
        return snapshot_path, None
    # snapshot first, then the journal tail (overlap converges to the
    # same state); every lane segment replays, live siblings' read-only
    journal_path = os.path.join(config.data_dir,
                                journal_mod.segment_name(config.lane_id))
    n = journal_mod.recover_all(database, config.data_dir, journal_path, log)
    if n:
        log.info() and log.i(f"journal replayed ({n} delta batches)")
    journal = journal_mod.Journal(
        journal_path,
        fsync=config.journal_fsync,
        fsync_interval=config.journal_fsync_interval,
        max_bytes=config.journal_max_bytes,
        registry=database.metrics,
    )
    journal.open()
    database.set_journal(journal)
    return snapshot_path, journal


async def serve(node: NodeStack) -> Dispose:
    """Start a built node's listeners, the RESP server first (the
    cluster advertises its port), then the cluster (or the lane bus and
    lane 0's external identity), the Prometheus endpoint with
    ``--metrics-port``, the online snapshot loop when it has work (an
    interval, or a journal to compact) and a lane's ``lane.tick`` task;
    return its ``Dispose``. With ``JYLIS_PROFILE_DIR`` set, the
    profiler's session starts here."""
    metrics.start_profiling()
    await node.server.start()
    for sub in getattr(node.cluster, "clusters", [node.cluster]):
        sub.resp_port = int(node.server.port)
    await node.cluster.start()
    config = node.config
    if config.metrics_port:
        from .obs.prom import MetricsHTTP

        node.metrics_http = MetricsHTTP(
            node.database, max(config.metrics_port, 0), config.log
        )
        await node.metrics_http.start()
    if config.lane_id is not None:
        node.lane_tick_task = asyncio.create_task(_lane_tick(config.log))
    dispose = Dispose(node.database, node.server, node.cluster,
                      node.snapshot_path, config.log, node.journal,
                      node.warmup_launches)
    dispose.gc_hook = node.database.metrics.gc_callback
    if node.snapshot_path and (config.snapshot_interval > 0
                               or node.journal is not None):
        dispose.snapshot_task = asyncio.create_task(_snapshot_loop(
            node.database, node.snapshot_path, config.snapshot_interval,
            config.log, dispose.snapshot_inflight, node.journal,
        ))
    return dispose


async def _lane_tick(log) -> None:
    """The lane-crash drill's seam: arming ``lane.tick=crash`` in one
    lane's environment (the supervisor's JYLIS_LANE_FAILPOINTS="1:
    lane.tick=crash:1") kills that worker mid-traffic; error degrades to
    a log line, sleep delays the tick."""
    while True:
        await asyncio.sleep(0.25)
        try:
            await faults.async_point("lane.tick")
        except faults.FaultError:
            log.warn() and log.w("lane.tick failpoint fired")


def _dump_trace(database, log) -> None:
    """The trace ring to stderr on an unclean exit: the node's own
    account of its last seconds, which SYSTEM TRACE can no longer
    serve."""
    try:
        entries = database.metrics.trace.dump()
        if entries:
            from .obs.trace import TraceRing

            print(f"--- trace ring ({len(entries)} events) ---", file=sys.stderr)
            for entry in entries:
                print(TraceRing.format(entry), file=sys.stderr)
    except Exception as e:  # best-effort post-mortem output: it must
        # not mask the exception that ended the node
        log.err() and log.e(f"trace dump failed: {e!r}")


def device_name(device) -> str:
    """The torch device a node's state lives on, with its index
    (``cuda:0``, not ``cuda``) when it is a card."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(dev)


async def _snapshot_loop(
    database, path: str, interval: float, log, inflight: dict, journal=None
) -> None:
    """Online snapshots while serving (jylis_tpu/main.py:389-460). Each
    type dumps under its own repo lock in a worker thread on the node's
    device (Database.dump_state_async), so serving never pauses
    globally; cross-type skew is safe because restore is lattice
    convergence. The write is atomic, so a crash mid-snapshot keeps the
    previous file.

    With a journal this loop is also the compaction driver: it wakes
    early when the journal crosses its size threshold (the
    rotate_notify hook), rotates the active segment aside first -- so
    every delta flushed after the cut lands in the fresh segment and the
    snapshot dumped below covers everything before it -- and retires the
    old segment only after the snapshot is written. A failure or crash
    in between leaves the ``.retiring`` segment for boot recovery. With
    ``--snapshot-interval 0`` it snapshots only on compaction.

    The write future sits in ``inflight["write"]`` until it completes:
    Dispose awaits it before the shutdown snapshot touches the same tmp
    file."""
    rotate_event = asyncio.Event()
    if journal is not None:
        loop = asyncio.get_running_loop()
        journal.rotate_notify = lambda: loop.call_soon_threadsafe(
            rotate_event.set
        )
        # a segment already oversized at boot never re-asks: check once
        if journal.needs_rotation():
            rotate_event.set()
    while True:
        if journal is None:
            await asyncio.sleep(interval)
        else:
            try:
                await asyncio.wait_for(
                    rotate_event.wait(),
                    timeout=interval if interval > 0 else None,
                )
            except asyncio.TimeoutError:
                pass
            rotate_event.clear()
        try:
            if journal is not None:
                await asyncio.to_thread(journal.rotate_begin)
            batches = await database.dump_state_async()
            fut = asyncio.ensure_future(
                asyncio.to_thread(persist.write_snapshot, batches, path)
            )
            inflight["write"] = fut
            fut.add_done_callback(
                lambda f: inflight.__setitem__("write", None)
                if inflight.get("write") is f
                else None
            )
            await asyncio.shield(fut)
            if journal is not None:
                await asyncio.to_thread(journal.rotate_commit)
            log.debug() and log.d(f"online snapshot written: {path}")
        except asyncio.CancelledError:
            raise
        except Exception as e:  # one failed online snapshot (full disk,
            # a drain raising mid-dump) must not kill the loop; the
            # journal keeps the unsnapshotted deltas either way
            log.err() and log.e(f"online snapshot failed: {e}")


async def run(argv: list[str] | None = None) -> None:
    config = config_from_cli(argv, served_types=SERVED_TYPES)
    log = config.log
    if config.lanes > 1 and config.lane_id is None:
        # this process becomes the lane supervisor: it spawns one worker
        # per lane from the same flags (argv None means sys.argv, as
        # argparse saw it), restarts crashed lanes and aggregates their
        # metrics endpoints; it never touches the device
        print(LOGO)
        await lanes_mod.run_supervisor(
            config, sys.argv[1:] if argv is None else argv
        )
        return
    node = build_node(config)
    dispose = await serve(node)
    dispose.on_signal()
    if config.lane_id is None:
        print(LOGO)  # one logo per node, none per lane
    from . import __version__

    log.info() and log.i(f"jylis-tpu-torch version: {__version__}")
    log.info() and log.i(f"cluster address: {config.addr}")
    database = node.database
    lane = (f"lane {config.lane_id}/{config.lanes} (pid {os.getpid()}) "
            if config.lane_id is not None else "")
    log.info() and log.i(
        f"serving {lane}{'/'.join(SERVED_TYPES)} on port {node.server.port}, "
        f"device {device_name(database.device)}"
        + (f", {database.mesh}" if database.mesh else "")
    )
    if node.metrics_http is not None:
        log.info() and log.i(f"metrics endpoint on port: {node.metrics_http.port}")
    try:
        await dispose.done.wait()
    except BaseException:  # re-raised at once: an unclean shutdown
        # leaves the trace ring on stderr first
        _dump_trace(database, log)
        raise
    finally:
        if node.lane_tick_task is not None:
            node.lane_tick_task.cancel()
        if node.metrics_http is not None:
            await node.metrics_http.dispose()


def main(argv: list[str] | None = None) -> None:
    try:
        asyncio.run(run(argv))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])
