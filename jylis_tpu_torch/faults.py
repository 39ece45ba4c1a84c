"""Deterministic fault injection: named failpoints at every I/O seam.

The cluster's delta anti-entropy is deliberately fire-and-forget (the
delta-CRDT model assumes lossy dissemination healed by periodic sync),
which means the interesting bugs live in the failure envelope AROUND the
lattice math: a dial that hangs, an fsync that fails mid-rotation, a
frame corrupted on the wire, a process that dies between journal append
and snapshot cut. Before this module every crash drill was a bespoke
monkeypatch; failpoints make the failure modes injectable by NAME, from
the environment or from test code, so the drill matrix
(tests/test_drill_matrix.py) can iterate {fault class} x {injection
site} combinatorially over a real cluster.

Arming syntax (``JYLIS_FAILPOINTS`` env var or the ``--failpoints``
flag; comma-separated)::

    cluster.dial=error:3,journal.fsync=sleep:0.2,codec.decode=corrupt

i.e. ``name=action[:arg[:budget]]``. Actions:

* ``error[:budget]``   — raise :class:`FaultError` at the point;
* ``sleep:secs[:budget]`` — delay the operation by ``secs`` seconds
  (``asyncio.sleep`` at async points, ``time.sleep`` at thread points);
* ``corrupt[:budget]`` — deterministically flip one byte of the data
  flowing through the point (degrades to ``error`` at data-less sites);
* ``crash[:budget]``   — hard-kill the process (``os._exit``), the
  SIGKILL-shaped drill; tests may install a handler instead;
* ``drop[:budget]``    — silently discard the data flowing through the
  point (the caller sees "success" and nothing is sent/written;
  degrades to ``error`` at data-less sites).

A ``budget`` bounds the number of firings: once exhausted the point
disarms itself, so a drill can inject "3 dial failures, then heal"
without coordinating a disarm. Hit counts survive disarming
(:func:`hits`), so drills can assert the site actually fired.

:class:`FaultError` subclasses ``ConnectionError`` (hence ``OSError``):
every I/O seam in this repo already routes those into its real
failure-recovery path, so an injected error exercises the handling code
that a genuine failure would, not an injection-only special case.

**Unarmed points are free.** ``point(name)`` / ``async_point(name)``
cost exactly one dict miss when nothing is armed — the registry dict is
empty unless ``JYLIS_FAILPOINTS`` is set or a test armed a point — so
the seams stay on the hot path permanently (verified by bench-smoke).

The port's copy of jylis_tpu/faults.py, whole. Its registry is its own:
arming a point here arms nothing in the JAX package, though both read
the same ``JYLIS_FAILPOINTS`` variable at import. The port's cluster
names the JAX cluster's points (``cluster.dial``, ``cluster.read``,
``cluster.write``, ``cluster.decode``, ``cluster.relay``,
``cluster.sync_dump``, ``sync.digest``, ``sync.range``).
"""

from __future__ import annotations

import asyncio
import os
import threading
import time

ACTIONS = ("error", "sleep", "corrupt", "crash", "drop")

ENV_VAR = "JYLIS_FAILPOINTS"

CRASH_EXIT_CODE = 86  # distinguishes an injected crash from real faults


class FaultError(ConnectionError):
    """Raised by an armed ``error`` failpoint (and by ``corrupt``/
    ``drop`` at data-less sites). A ``ConnectionError`` so the existing
    ``except (ConnectionError, ...)`` / ``except OSError`` recovery
    paths at every seam treat it exactly like the real failure it
    stands in for."""


class FaultSpecError(ValueError):
    """Malformed ``JYLIS_FAILPOINTS`` / ``--failpoints`` spec."""


class _Point:
    __slots__ = ("name", "action", "arg", "budget")

    def __init__(self, name: str, action: str, arg: float | None, budget: int | None):
        self.name = name
        self.action = action
        self.arg = arg
        self.budget = budget


# The registry. Reads (the hot-path dict miss) are GIL-atomic; all
# mutation — arming, budget consumption, hit counting — happens under
# _lock because points fire from the event loop AND from worker threads
# (journal writer, snapshot to_thread).
_lock = threading.Lock()
_armed: dict[str, _Point] = {}
_hits: dict[str, int] = {}  # cumulative, survives disarm (drill asserts)

# `crash` handler: tests that drive nodes in-process replace this (an
# os._exit would take the test runner down with the "node")
_crash_handler = None


def parse_spec(spec: str) -> list[tuple[str, str, float | None, int | None]]:
    """``name=action[:arg[:budget]]`` comma list -> arm() argument tuples."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise FaultSpecError(f"failpoint spec {item!r} lacks '=action'")
        name, rhs = item.split("=", 1)
        parts = rhs.split(":")
        action, args = parts[0], parts[1:]
        if action not in ACTIONS:
            raise FaultSpecError(
                f"unknown failpoint action {action!r} in {item!r} "
                f"(expected one of {', '.join(ACTIONS)})"
            )
        arg: float | None = None
        if action == "sleep":
            if not args:
                raise FaultSpecError(f"sleep needs seconds: {item!r}")
            try:
                arg = float(args.pop(0))
            except ValueError:
                raise FaultSpecError(f"bad sleep seconds in {item!r}") from None
        budget: int | None = None
        if args:
            try:
                budget = int(args.pop(0))
            except ValueError:
                raise FaultSpecError(f"bad hit budget in {item!r}") from None
            if budget <= 0:
                raise FaultSpecError(f"hit budget must be positive: {item!r}")
        if args:
            raise FaultSpecError(f"trailing arguments in {item!r}")
        out.append((name.strip(), action, arg, budget))
    return out


def arm(name: str, action: str, arg: float | None = None, budget: int | None = None) -> None:
    """Programmatic arming (tests); env/flag arming goes via arm_spec."""
    if action not in ACTIONS:
        raise FaultSpecError(f"unknown failpoint action {action!r}")
    if action == "sleep" and arg is None:
        raise FaultSpecError("sleep needs seconds")
    with _lock:
        _armed[name] = _Point(name, action, arg, budget)


def arm_spec(spec: str) -> None:
    for name, action, arg, budget in parse_spec(spec):
        arm(name, action, arg, budget)


def disarm(name: str) -> None:
    with _lock:
        _armed.pop(name, None)


def reset() -> None:
    """Disarm everything and zero the hit counters (test teardown)."""
    with _lock:
        _armed.clear()
        _hits.clear()


def hits(name: str) -> int:
    """Cumulative firings of a point (survives disarm/budget exhaustion)."""
    with _lock:
        return _hits.get(name, 0)


def armed_points() -> dict[str, str]:
    """{name: action} snapshot of what is currently armed."""
    with _lock:
        return {n: p.action for n, p in _armed.items()}


def set_crash_handler(fn) -> None:
    """Replace the ``crash`` action's process-kill (in-process drills);
    pass None to restore ``os._exit``."""
    global _crash_handler
    _crash_handler = fn


def _consume(p: _Point) -> bool:
    """Take one firing from the point's budget; False when exhausted
    (the point disarms itself and the caller proceeds normally)."""
    with _lock:
        if _armed.get(p.name) is not p:
            return False  # re-armed/disarmed concurrently: newest wins
        if p.budget is not None:
            if p.budget <= 0:
                _armed.pop(p.name, None)
                return False
            p.budget -= 1
            if p.budget == 0:
                _armed.pop(p.name, None)  # last firing happens below
        _hits[p.name] = _hits.get(p.name, 0) + 1
        return True


def _corrupt(data: bytes) -> bytes:
    """Deterministic single-byte flip, mid-buffer: the same input always
    corrupts the same way, so a drill failure replays exactly."""
    b = bytearray(data)
    if b:
        b[len(b) // 2] ^= 0x01
    return bytes(b)


def _fire(p: _Point, data):
    if p.action == "error":
        raise FaultError(f"failpoint {p.name}: injected error")
    if p.action == "crash":
        handler = _crash_handler
        if handler is not None:
            handler(p.name)
            return data
        os._exit(CRASH_EXIT_CODE)
    if p.action == "corrupt":
        if data is None:  # data-less site: degrade to error (documented)
            raise FaultError(f"failpoint {p.name}: corrupt at data-less site")
        return _corrupt(data)
    if p.action == "drop":
        if data is None:
            raise FaultError(f"failpoint {p.name}: drop at data-less site")
        return None
    raise AssertionError(f"unhandled action {p.action}")  # pragma: no cover


def point(name: str, data: bytes | None = None):
    """The synchronous failpoint. Unarmed: one dict miss, returns
    ``data`` unchanged. Armed: ``error`` raises FaultError, ``sleep``
    blocks (thread contexts — the journal writer, to_thread snapshot
    work; loop-side sync seams keep injected sleeps short), ``corrupt``
    returns mutated bytes, ``drop`` returns None (caller discards
    silently), ``crash`` kills the process."""
    p = _armed.get(name)
    if p is None:
        return data
    if not _consume(p):
        return data
    if p.action == "sleep":
        time.sleep(p.arg)
        return data
    return _fire(p, data)


async def async_point(name: str, data: bytes | None = None):
    """The event-loop failpoint: identical semantics to :func:`point`
    except ``sleep`` awaits ``asyncio.sleep`` so an injected delay
    stalls only the task at the seam, never the whole loop."""
    p = _armed.get(name)
    if p is None:
        return data
    if not _consume(p):
        return data
    if p.action == "sleep":
        await asyncio.sleep(p.arg)
        return data
    return _fire(p, data)


# env arming happens at import: spawned drill nodes (and operators)
# arm via JYLIS_FAILPOINTS with no code involved
_env_spec = os.environ.get(ENV_VAR, "")
if _env_spec:
    arm_spec(_env_spec)
