"""Per-type repo manager: dispatch, help-on-failure, proactive flush.

The port of jylis_tpu/models/manager.py (reference analog:
RepoManagerCore, repo_manager.pony:36-108). The actor boundary becomes
the asyncio event loop plus a per-repo asyncio.Lock; what this class
keeps is the behavioral contract:

* shutdown flag rejects new commands with the SHUTDOWN error (:49-55),
* parse failure renders the repo's help text (:62-66),
* a mutating command triggers a proactive delta flush, throttled to at
  most once per 500 ms per repo (:68-84),
* flush_deltas registers the delta sink and drains if non-empty (:86-90),
* clean_shutdown stops intake and performs a final flush (:95-108),
* every flushed batch is journaled first when a journal is attached.

It also keeps the per-class admission cap (``admission_cap``, set by
Database.set_admission_cap: commands queued behind the repo lock past
the cap get a typed BUSY refusal), the per-Database commands-served tally (SYSTEM METRICS'
"cmds" lines) and counts each flushed key's digest-tree bucket as write
heat in the Database's registry (SYSTEM OBSERVE), as the JAX manager
does.

Concurrency: commands that will hit the device (the repo's
``may_drain`` predicate) run in a worker thread via
``asyncio.to_thread`` so a drain never stalls the event loop. The
per-repo lock serialises every repo access (apply, converge, flush), so
repo state is never touched concurrently with an offloaded drain. Every
holder of the lock, in this module and outside it, takes it through
``locked(who)``, which times the wait and the hold as the registry's
``lock_wait.<TYPE>.<who>`` / ``lock_hold.<TYPE>.<who>`` spans; each
converge slice is a ``converge.<TYPE>`` span.
Host-only commands take a lock-free inline fast path when no drain is
active, which preserves per-connection order. Replies from offloaded
commands are buffered and replayed on the loop thread (transports are
not thread-safe). The sync ``apply`` path serves single-threaded callers
(tests, direct drives).
"""

from __future__ import annotations

import asyncio
import itertools
import time

from ..obs.registry import SPAN_ID, null_span
from .base import ParseError
from .help import respond_help

# one id per lock acquisition: its wait's and hold's profiler ranges
# carry it, and so do the ranges of the drain it runs
_acquisitions = itertools.count(1)


class _ReplayResp:
    """Records resp-protocol calls in a worker thread; replays them on the
    event-loop thread afterwards."""

    __slots__ = ("calls",)

    def __init__(self):
        self.calls: list = []

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, args))

        return record

    def replay(self, resp) -> None:
        for name, args in self.calls:
            getattr(resp, name)(*args)


class _Locked:
    """``RepoManager.locked(who)``: an async ``with`` that takes the repo
    lock, timing the wait and the hold as spans of the manager's
    registry (none without one)."""

    __slots__ = ("_mgr", "_who", "_hold", "_sid")

    def __init__(self, mgr: "RepoManager", who: str):
        self._mgr = mgr
        self._who = who

    async def __aenter__(self):
        mgr = self._mgr
        wait_name, hold_name = mgr._lock_spans[self._who]
        self._sid = SPAN_ID.set(next(_acquisitions))
        wait = mgr._span(wait_name)
        try:
            await mgr._lock.acquire()
        except BaseException:  # cancelled while queued: never held
            wait.close()
            SPAN_ID.reset(self._sid)
            raise
        wait.close()
        self._hold = mgr._span(hold_name)
        return self

    async def __aexit__(self, *exc) -> None:
        self._mgr._lock.release()
        self._hold.close()
        SPAN_ID.reset(self._sid)


PROACTIVE_FLUSH_INTERVAL = 0.5  # seconds; repo_manager.pony:80

SHUTDOWN_ERR = "SHUTDOWN (server is shutting down, rejecting all requests)"


class RepoManager:
    def __init__(
        self, name: str, repo, help_obj, clock=time.monotonic, served=None
    ):
        self.name = name
        self.repo = repo
        self.help = help_obj
        self._clock = clock
        # per-Database commands-served tally (SYSTEM METRICS "cmds")
        self._served = served if served is not None else {}
        # the Database's MetricsRegistry (write heat, BUSY refusals,
        # spans), when it has one (use_registry)
        self.registry = None
        # admission control (Database.set_admission_cap): commands of
        # this class queued behind the repo lock past the cap are
        # refused with a typed BUSY instead of queuing without bound.
        # 0 = off (default)
        self.admission_cap = 0
        self._inflight = 0
        # the delta journal (journal/), set by Database.set_journal:
        # _emit appends each flushed batch, in flush order
        self.journal = None
        self._deltas_fn = None
        self._last_proactive = None
        self._shutdown = False
        self._lock = asyncio.Lock()
        # the span names of this type's lock, per holder, and converge
        self._lock_spans = {
            who: (f"lock_wait.{name}.{who}", f"lock_hold.{name}.{who}")
            for who in (*self.LOCKERS, "native")
        }
        self._converge_span = f"converge.{name}"

    # who takes a repo lock: a command, a converge, the heartbeat's flush,
    # the sync digest, trees and dumps, shutdown; the server's native
    # burst ("native") takes only the engine-backed types' locks
    LOCKERS = ("apply", "converge", "flush", "sync", "shutdown")

    def use_registry(self, registry, native: bool = False) -> None:
        """Record into ``registry``, declaring this type's spans there:
        the lock's wait and hold for each of LOCKERS (and "native" with
        ``native``: a type the server's native burst locks) and the
        converge slice."""
        whos = (*self.LOCKERS, "native") if native else self.LOCKERS
        registry.declare_spans(
            [n for who in whos for n in self._lock_spans[who]]
            + [self._converge_span]
        )
        self.registry = registry

    def _span(self, name: str, items: int = 0):
        """A span of the registry's, or a null one without a registry."""
        reg = self.registry
        return (null_span if reg is None else reg.span)(name, items)

    def locked(self, who: str) -> _Locked:
        """The repo lock, for ``async with``: EVERY holder takes it here,
        naming who it is (one of LOCKERS, or "native"), so each wait and
        hold is timed."""
        return _Locked(self, who)

    def apply(self, resp, cmd: list[bytes]) -> None:
        """cmd includes the routing word (cmd[0] == data type name).
        Single-threaded path — see module docstring."""
        if self._shutdown:
            resp.err(SHUTDOWN_ERR)
            return
        if self._apply_core(resp, cmd):
            self._maybe_proactive_flush()

    def _apply_core(self, resp, cmd: list[bytes]) -> bool:
        self._served[self.name] = self._served.get(self.name, 0) + 1
        try:
            return self.repo.apply(resp, cmd[1:])
        except ParseError:
            respond_help(resp, self.help.render(cmd[1:]))
            return False

    async def apply_async(self, resp, cmd: list[bytes]) -> None:
        """Serving path: device-bound commands offload to a thread under
        the repo lock; host-only commands run inline.

        Fast path: when the lock is free (a threaded drain ALWAYS holds
        it, and releases only on the loop thread) and the command needs
        no device offload, apply synchronously with no await at all —
        the event loop is single-threaded, so the inline apply is atomic."""
        if self._shutdown:
            resp.err(SHUTDOWN_ERR)
            return
        may = getattr(self.repo, "may_drain", None)  # host-only repos have none
        if not self._lock.locked() and (may is None or not may(cmd[1:])):
            if self._apply_core(resp, cmd):
                self._maybe_proactive_flush()
            return
        if self.admission_cap and self._inflight >= self.admission_cap:
            # only lock-queued commands count as inflight (the inline
            # fast path above never queues), so the cap binds exactly
            # when this class is backed up behind its own drains
            if self.registry is not None:
                self.registry.note_serving("busy_refusals")
                self.registry.trace_event("serving", "busy", "", self.name)
            resp.err(
                f"BUSY ({self.name} admission cap {self.admission_cap} "
                "reached; this command class is backed up — retry)"
            )
            return
        self._inflight += 1
        try:
            async with self.locked("apply"):
                if self._shutdown:
                    # shutdown won the lock race while we queued behind a
                    # drain: the final flush already ran — accepting now
                    # would acknowledge a write that never replicates
                    resp.err(SHUTDOWN_ERR)
                    return
                if may is not None and may(cmd[1:]):
                    replay = _ReplayResp()
                    changed = await asyncio.to_thread(self._apply_core, replay, cmd)
                    replay.replay(resp)
                else:
                    changed = self._apply_core(resp, cmd)
                if changed:
                    self._maybe_proactive_flush()
        finally:
            self._inflight -= 1

    # keys converged per event-loop slice: a multi-thousand-key batch
    # converged in one go would block the loop; slicing under the same
    # lock keeps other traffic flowing with identical lattice results
    CONVERGE_SLICE = 256

    async def converge_async(self, batch) -> None:
        async with self.locked("converge"):
            if self._shutdown:
                return  # fire-and-forget: late deltas re-deliver elsewhere
            batch = list(batch)
            for i in range(0, len(batch), self.CONVERGE_SLICE):
                part = batch[i : i + self.CONVERGE_SLICE]
                with self._span(self._converge_span, len(part)):
                    self.converge_deltas(part)
                if i + self.CONVERGE_SLICE < len(batch):
                    await asyncio.sleep(0)
            # repos that buffer deltas (TREG, TENSOR) drain once their
            # window trips, AFTER buffering, in a worker thread: never
            # inline on the event loop
            overdue = getattr(self.repo, "drain_overdue", None)
            if overdue is not None and overdue():
                await asyncio.to_thread(self.repo.drain)

    async def flush_async(self, fn) -> None:
        """The cluster heartbeat's flush, serialised with threaded drains
        by the repo lock. A repo with banked native-queue work (UJSON's
        ``prepare_flush``) applies it in a worker thread first, so the
        loop-side flush sees fully applied state."""
        async with self.locked("flush"):
            prep = getattr(self.repo, "prepare_flush", None)
            if prep is not None:
                await asyncio.to_thread(prep)
            self.flush_deltas(fn)

    def busy(self) -> bool:
        """True while a (possibly threaded) repo access holds the lock:
        the server's native burst path defers to Python while true."""
        return self._lock.locked()

    async def clean_shutdown_async(self) -> None:
        """Lock-holding shutdown: waits out any in-flight threaded drain,
        then stops intake and performs the final flush atomically."""
        self._shutdown = True  # reject commands queued behind the lock
        async with self.locked("shutdown"):
            prep = getattr(self.repo, "prepare_flush", None)
            if prep is not None:  # banked native-queue writes must ship
                await asyncio.to_thread(prep)
            if self._deltas_fn is not None:
                self.flush_deltas(self._deltas_fn)

    def _maybe_proactive_flush(self) -> None:
        if self._deltas_fn is None:
            return
        now = self._clock()
        if (
            self._last_proactive is None
            or now - self._last_proactive >= PROACTIVE_FLUSH_INTERVAL
        ):
            # unconditional, like the reference's proactive path (:81)
            self._emit(self.repo.flush_deltas())
            self._last_proactive = now

    def flush_deltas(self, fn) -> None:
        """Heartbeat entry point: registers the sink, drains if non-empty."""
        self._deltas_fn = fn
        if self.repo.deltas_size() > 0:
            self._emit(self.repo.flush_deltas())

    def _emit(self, batch) -> None:
        """Every flushed batch leaves through here: journal first (a
        batch that reached peers but not this node's disk is the crash
        loss the journal closes; the append only enqueues), then each
        key counts as write heat against its sync_bucket (the digest
        tree's shard, models/database.py), then the batch goes to the
        sink."""
        if self.journal is not None:
            self.journal.append(self.name, batch)
        if self.registry is not None and self.registry.enabled and batch:
            from .database import sync_bucket  # database imports this module

            note = self.registry.note_write_heat
            for key, _delta in batch:
                note(self.name, sync_bucket(key))
        self._deltas_fn((self.name, batch))

    def converge_deltas(self, batch) -> None:
        """Join a batch: whole, where the repo converges a slice at once
        (the counters' ``converge_batch``), else key by key."""
        whole = getattr(self.repo, "converge_batch", None)
        if whole is not None:
            whole(batch)
            return
        for key, delta in batch:
            self.repo.converge(key, delta)
