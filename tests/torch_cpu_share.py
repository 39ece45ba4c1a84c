"""CPU priority for the port's parity tests.

Tier-1 runs the whole suite on a few cores (pytest-xdist, one file per
worker). The port's parity tests are CPU-bound, mostly the JAX
reference's compiles, while the JAX package's cluster tests poll
against wall-clock deadlines. A worker that runs a port test module
therefore moves its threads to the idle scheduling class for the
module's duration (they run only on cores nothing else wants) and
restores their class after, so the timing-bound tests keep the cores
they need. Results do not change. Where the class could not be restored
(no privilege to leave the idle class), nothing is changed.

Each port test module imports ``yield_cpu``; an autouse fixture in a
module's namespace applies to that module.
"""

import os
import threading

import pytest


def _set_all(policy: int) -> None:
    """Set the scheduling class of every thread of this process (Linux
    keeps one per thread; new threads inherit their creator's)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setscheduler(int(tid), policy, os.sched_param(0))
        except ProcessLookupError:  # the thread ended meanwhile
            pass


def _can_restore() -> bool:
    """Whether a thread may leave the idle class again: probed on a
    throwaway thread, so a failed probe changes nothing that stays."""
    ok = []

    def probe():
        tid = threading.get_native_id()
        try:
            base = os.sched_getscheduler(tid)
            os.sched_setscheduler(tid, os.SCHED_IDLE, os.sched_param(0))
            os.sched_setscheduler(tid, base, os.sched_param(0))
            ok.append(True)
        except OSError:
            pass

    t = threading.Thread(target=probe)
    t.start()
    t.join(timeout=10)
    return bool(ok)


@pytest.fixture(autouse=True, scope="module")
def yield_cpu():
    if not hasattr(os, "SCHED_IDLE") or not _can_restore():
        yield
        return
    old = os.sched_getscheduler(0)
    _set_all(os.SCHED_IDLE)
    try:
        yield
    finally:
        _set_all(old)
