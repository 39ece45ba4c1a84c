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
nodes included). On SIGINT/SIGTERM ``Dispose`` stops intake, makes the
final flush to peers under the repo locks, ends the drain profiler's
session (``JYLIS_PROFILE_DIR``) and stops the cluster and the listener
(after dispose.pony). ``build_node`` does the wiring and ``serve``
starts the listeners; ``run`` is the two with the signal handlers, and
other drivers (chip_smoke.py's cluster phase) call the same two.
Snapshots and the journal come with persistence.
"""

from __future__ import annotations

import asyncio
import signal
import sys

from . import faults
from .cluster import Cluster
from .models import database as database_mod
from .models.database import SERVED_TYPES, Database
from .server.server import Server
from .system import System
from .utils import metrics
from .utils.config import config_from_cli


class Dispose:
    """Idempotent clean shutdown (dispose.pony:12-19): first drain
    every repo's remaining deltas to peers, then stop the listeners."""

    def __init__(self, database: Database, server: Server, cluster: Cluster,
                 log=None):
        self._database = database
        self._server = server
        self._cluster = cluster
        self._log = log
        self._disposing = False
        self._shutdown_task: asyncio.Task | None = None
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
            # the final flush rides broadcast_deltas; per-repo locks wait
            # out threaded drains and fence off late-queued commands
            await self._database.clean_shutdown_async()
            if self._log is not None:
                self._log.info() and self._log.i(
                    f"merge metrics: {self._database.metrics.report()}"
                )
            metrics.stop_profiling()
        finally:
            self._cluster.dispose()
            await self._server.dispose()
            self.done.set()


class NodeStack:
    """One node's parts, wired by ``build_node`` and not yet listening."""

    def __init__(self, config, system, database, server, cluster):
        self.config = config
        self.system = system
        self.database = database
        self.server = server
        self.cluster = cluster


def build_node(config) -> NodeStack:
    """Wire a node in the JAX package's order: Config -> failpoints ->
    System -> ``warmup`` (every serving kernel and the native library
    built, and the serving paths launched once on the node's device,
    before anything listens) -> Database (with the native serving engine)
    -> Server -> Cluster."""
    if config.failpoints:
        faults.arm_spec(config.failpoints)
    system = System(config)
    database_mod.warmup(config.device, engine="auto")
    database = Database(
        identity=config.addr.hash64(), device=config.device,
        system_repo=system.repo, engine="auto",
    )
    database.metrics.spans.set_slo_ms(
        int(s) for s in config.converge_slo_ms.split(",") if s.strip()
    )
    server = Server(config, database)
    cluster = Cluster(config, database)
    return NodeStack(config, system, database, server, cluster)


async def serve(node: NodeStack) -> Dispose:
    """Start a built node's listeners, the RESP server first (the
    cluster advertises its port), and return its ``Dispose``."""
    await node.server.start()
    node.cluster.resp_port = int(node.server.port)
    await node.cluster.start()
    return Dispose(node.database, node.server, node.cluster, node.config.log)


async def run(argv: list[str] | None = None) -> None:
    config = config_from_cli(argv, served_types=SERVED_TYPES)
    log = config.log
    node = build_node(config)
    dispose = await serve(node)
    dispose.on_signal()
    from . import __version__

    log.info() and log.i(f"jylis-tpu-torch version: {__version__}")
    log.info() and log.i(f"cluster address: {config.addr}")
    database = node.database
    log.info() and log.i(
        f"serving {'/'.join(SERVED_TYPES)} on port {node.server.port}, device "
        f"{database.device}" + (f", {database.mesh}" if database.mesh else "")
    )
    await dispose.done.wait()


def main(argv: list[str] | None = None) -> None:
    try:
        asyncio.run(run(argv))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])
