"""Process entry point: ``python -m jylis_tpu_torch --port P``.

Builds the Database (the eight types of
``models.database.DATA_REPO_CLASSES`` and SYSTEM, on ``--device``,
default cuda; keys-sharded over every card when the device names no card
and the host has more than one) and the RESP Server, serves until
SIGINT/SIGTERM, then stops intake, waits out any in-flight drain, ends
the drain profiler's session (``JYLIS_PROFILE_DIR``) and closes the
listener (after the reference's main.pony and dispose.pony). There is no
cluster yet, so nothing is flushed to peers; ``SYSTEM DIGEST`` answers
with the bytes a JAX node holding the same data gives.
"""

from __future__ import annotations

import asyncio
import signal
import sys

from .models.database import SERVED_TYPES, Database
from .server.server import Server
from .utils import metrics
from .utils.config import config_from_cli


async def run(argv: list[str] | None = None) -> None:
    config = config_from_cli(argv)
    log = config.log
    database = Database(identity=config.addr.hash64(), device=config.device)
    server = Server(config, database)
    await server.start()
    log.info() and log.i(
        f"serving {'/'.join(SERVED_TYPES)} on port {server.port}, device "
        f"{database.device}" + (f", {database.mesh}" if database.mesh else "")
    )
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    database.stop_intake()
    try:
        await database.clean_shutdown_async()
    finally:
        metrics.stop_profiling()
        await server.dispose()


def main(argv: list[str] | None = None) -> None:
    try:
        asyncio.run(run(argv))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])
