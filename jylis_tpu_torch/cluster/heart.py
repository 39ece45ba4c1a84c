"""Heartbeat timer driving the cluster's periodic work.

The port's copy of jylis_tpu/cluster/heart.py, whole.

Reference analog: heart.pony:6-19 — a timer firing ``target._heartbeat()``
every ``heartbeat_time`` seconds (default 10 s, config.pony:9). Here the
Pony timer becomes an asyncio task; the target contract stays the same
(anything with a ``_heartbeat()`` method, _HeartbeatableActor analog).
"""

from __future__ import annotations

import asyncio


class Heart:
    def __init__(self, target, interval_s: float):
        self._target = target
        self._interval = interval_s
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        try:
            while True:
                await asyncio.sleep(self._interval)
                try:
                    self._target._heartbeat()
                except Exception as e:  # noqa: BLE001  jlint: broad-ok
                    # a transient tick failure must not kill the heart: a
                    # dead heart means no dialing, no eviction, and no
                    # anti-entropy while the node keeps serving clients
                    log = getattr(self._target, "_log", None)
                    if log is not None:
                        log.err() and log.e(f"heartbeat tick failed: {e!r}")
        except asyncio.CancelledError:
            pass

    def dispose(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
