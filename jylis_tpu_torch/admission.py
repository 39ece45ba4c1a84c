"""Overload armor: per-class priority admission and load shedding.

The port's copy of jylis_tpu/admission.py, whole: the classifier, the
``--admission-policy`` parser, the BUSY reply, the hysteresis state
machine and the ``admission.shed`` failpoint (armed in the port's own
``faults`` registry).

The ``--admission-cap`` seed (models/manager.py) bounds one data type's
repo-lock queue — useful against a single hot key, useless against the
node-wide failure mode: offered load above serving capacity. This
module is the node-wide layer: every Python-path command is classified
into one of four priority classes (control > reads > writes > bulk by
default, reorderable via ``--admission-policy``), and when the node
declares itself OVERLOADED — a hysteresis state driven by the dispatch
latency EWMA and the in-flight queue depth — the low-priority classes
are refused up front with a typed BUSY reply carrying a retry-after
hint, before they cost a session flush, a repo lock, or a device
drain. The delta-CRDT discipline (arXiv:1410.2803) keeps replication
cheap under pressure only if serving queues are bounded; Big(ger) Sets
(arXiv:1605.06424) argues the shedding unit must be the smallest one —
per command class, not per connection — which is exactly what the
classifier provides.

Three design points worth naming:

* **SESSION unwrapping.** ``SESSION WRAP <cmd>`` / ``SESSION READ
  <token> <cmd>`` classify as their INNER command, not as SESSION —
  otherwise control-plane priority becomes a write-smuggling channel
  past shedding (the ``--admission-cap`` seed classified by first word
  only; tests/test_admission.py pins the inheritance).
* **Hysteresis, declared.** Overload is a STATE the node enters and
  exits (``serving.overload_enter``/``exit`` trace events, the
  ``serving.overload`` gauge, an OVERLOAD section in SYSTEM METRICS),
  not a per-command coin flip: entry takes ``enter_streak`` consecutive
  pressure observations, exit takes ``exit_streak`` consecutive calm
  ones against a threshold at half the entry latency — so the state
  can't flap per command, and operators/drills can assert transitions.
* **A hard queued-bytes bound.** Reply bytes parked on slow consumers
  (transport write buffers + the per-connection reply buffer) are
  tracked per connection; past ``--admission-queue-bytes`` EVERY class
  is refused, so a slow-consumer burst can never OOM the loop. The
  server additionally caps each connection's transport buffer so
  ``drain()`` applies real per-connection backpressure.

Unarmed cost: with no ``--admission-policy`` and the byte bound idle,
``admit()`` is two attribute reads and an integer compare per command.
The ``admission.shed`` failpoint (drills) forces the shed decision for
sheddable classes without real overload.
"""

from __future__ import annotations

import time

from . import faults

# The four priority classes, most- to least-protected in the DEFAULT
# policy order. Class names are lowercase on the wire (BUSY replies,
# OVERLOAD metrics lines) and in the policy flag.
CONTROL = "control"
READ = "read"
WRITE = "write"
BULK = "bulk"
CLASSES = (CONTROL, READ, WRITE, BULK)

DEFAULT_ORDER = "control>read>write>bulk"

# Read-shaped second words across the data-type repos (repo_*.py).
# Anything else on a known data type is a write unless listed as bulk.
_READ_OPS = frozenset((b"GET", b"SIZE", b"CUTOFF", b"KEYS"))

# Bulk = commands that carry large payloads or trigger whole-structure
# device work; they shed first under the default policy.
_BULK_OPS = frozenset(
    (
        (b"TENSOR", b"SET"),
        (b"TENSOR", b"MRG"),
        (b"UJSON", b"SET"),
        (b"UJSON", b"INS"),
        (b"TLOG", b"TRIM"),
        (b"TLOG", b"TRIMAT"),
    )
)


def classify(cmd: list[bytes]) -> str:
    """The priority class of one parsed command.

    SESSION WRAP / SESSION READ unwrap to the INNER command's class —
    the satellite fix this round pins: wrapping a write in control-plane
    syntax must not promote it past shedding. Bare SESSION ops (TOKEN,
    help) and the SYSTEM family are control. Unknown first words class
    as reads: their reply is a cheap help render, and refusing them
    under overload would hide the help text exactly when an operator is
    debugging."""
    for _ in range(4):  # tolerate (malformed) nested wrapping, bounded
        if not cmd:
            return READ
        first = cmd[0]
        if first == b"SYSTEM":
            return CONTROL
        if first != b"SESSION":
            break
        op = cmd[1] if len(cmd) > 1 else b""
        if op == b"WRAP" and len(cmd) > 2:
            cmd = cmd[2:]
            continue
        if op == b"READ" and len(cmd) > 3:
            cmd = cmd[3:]
            continue
        return CONTROL  # TOKEN / help: genuinely control-plane
    op = cmd[1] if len(cmd) > 1 else b""
    if (first, op) in _BULK_OPS:
        return BULK
    if not op or op in _READ_OPS:
        return READ  # a bare first word is a help render: cheap
    return WRITE


class PolicySpecError(ValueError):
    """Malformed ``--admission-policy`` spec."""


def parse_policy(spec: str) -> dict:
    """``--admission-policy`` syntax::

        control>read>write>bulk[,lat=<enter ms>][,depth=<hi>][,protect=<n>]

    The ``>`` chain is the priority order (must name all four classes
    exactly once); ``lat`` is the dispatch-latency EWMA that declares
    pressure (exit threshold is half of it), ``depth`` the in-flight
    queue depth that declares pressure, ``protect`` how many top ranks
    are NEVER shed while overloaded (default 2: control + the next
    rank). Empty spec = admission disabled (the queued-bytes bound
    still applies)."""
    out = {
        "enabled": bool(spec),
        "order": CLASSES,
        "enter_ms": 25.0,
        "depth_hi": 128,
        "protect": 2,
    }
    if not spec:
        return out
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    order = tuple(c.strip().lower() for c in parts[0].split(">"))
    if sorted(order) != sorted(CLASSES):
        raise PolicySpecError(
            f"policy order must name all of {'/'.join(CLASSES)} exactly "
            f"once: {parts[0]!r}"
        )
    out["order"] = order
    for opt in parts[1:]:
        if "=" not in opt:
            raise PolicySpecError(f"policy option {opt!r} lacks '=value'")
        key, val = opt.split("=", 1)
        try:
            if key == "lat":
                out["enter_ms"] = float(val)
            elif key == "depth":
                out["depth_hi"] = int(val)
            elif key == "protect":
                out["protect"] = int(val)
            else:
                raise PolicySpecError(f"unknown policy option {key!r}")
        except ValueError:
            raise PolicySpecError(
                f"bad value in policy option {opt!r}"
            ) from None
    if not 1 <= out["protect"] < len(CLASSES):
        raise PolicySpecError("protect must be in 1..3")
    return out


# Hysteresis shape: entry is fast (a streak of consecutive pressure
# observations), exit is slow (a longer calm streak against the halved
# threshold) — asymmetry is what keeps the declared state from
# flapping per command at the capacity boundary.
EWMA_ALPHA = 0.05
ENTER_STREAK = 8
EXIT_STREAK = 64
# While overloaded, an EWMA past SEVERE_FACTOR x enter_ms escalates
# shedding from the bottom rank alone to every rank below the protect
# floor (default: bulk first, then writes too) — graceful degradation
# in two steps, with the protected ranks never shed by state.
SEVERE_FACTOR = 4.0
# The EWMA estimates time-in-our-own-queue; a queue does not survive an
# idle gap. Without this reset the state machine can FREEZE overloaded:
# refusals never call done(), so a node that shed its way to (near)
# zero admitted traffic keeps an EWMA stuck at its panic value and the
# exit streak can never complete — the first samples after a lull must
# start the estimate fresh, not average against stale panic.
IDLE_RESET_S = 1.0
# De-escalation (severe -> mild, overloaded -> calm) additionally
# requires this long with NO shed events. Shedding is what makes an
# overloaded node comfortable again — the latency signal collapses the
# moment the floor engages — so a purely latency-driven exit flaps at
# the shed boundary: exit, re-admit the flood, spike the protected
# tail, re-enter. Refusals still happening are direct evidence the
# pressure source is still offering load; only once clients actually
# back off (the BUSY retry-after contract) does the quiet window
# elapse and the calm streak start counting.
EXIT_SHED_QUIET_S = 1.0

_HINT_MIN_MS = 25
_HINT_MAX_MS = 1000


def busy_reply(cls: str, hint_ms: int, why: str) -> str:
    """The typed BUSY refusal body. Clients key on the leading BUSY and
    the machine-readable ``retry-after-ms=`` field (client.py parses
    it); the rest is operator-facing."""
    return (
        f"BUSY (overload shed class={cls} retry-after-ms={hint_ms}; "
        f"{why} — back off and retry)"
    )


class AdmissionController:
    """Node-wide admission state: one per Database, consulted by the
    Server at every Python-path dispatch. Single-threaded (event loop
    only) — no locks."""

    def __init__(self, policy: str = "", queue_bytes: int = 0, registry=None):
        p = parse_policy(policy)
        self.enabled = p["enabled"]
        self.order = p["order"]
        self.enter_ms = p["enter_ms"]
        self.exit_ms = p["enter_ms"] / 2.0
        self.depth_hi = p["depth_hi"]
        self.protect = p["protect"]
        self.queue_bytes_cap = queue_bytes
        self._reg = registry
        self._rank = {cls: i for i, cls in enumerate(self.order)}
        self.overloaded = False
        self.severe = False  # sticky escalation latch (see _shed_floor)
        self._hot = 0  # consecutive pressure observations (calm state)
        self._cool = 0  # consecutive calm observations (overload state)
        self.ewma_ms = 0.0
        self._ewma_init = False
        self._last_done = 0.0
        self._last_shed = 0.0
        self.inflight = 0
        self.shed: dict[str, int] = dict.fromkeys(CLASSES, 0)
        self.enters = 0
        self.exits = 0
        self.queued_bytes = 0
        self._conn_q: dict[int, int] = {}

    # ---- the admit decision (hot path) ------------------------------------

    @property
    def armed(self) -> bool:
        """Whether the server should classify at all: policy on, or the
        byte bound configured. False = zero per-command work."""
        return self.enabled or self.queue_bytes_cap > 0

    def _hint_ms(self, rank: int) -> int:
        base = max(self.ewma_ms * 2.0, float(_HINT_MIN_MS))
        return min(int(base * (1 + rank)), _HINT_MAX_MS)

    def _shed_floor(self) -> int:
        """Lowest rank that still gets served while overloaded. Ranks at
        or past the floor shed; the floor never drops below ``protect``
        (those ranks are the contract the bench's protected-class p99.9
        is measured against), and escalates one step tighter — toward
        protect, not past it — when the EWMA says severe. The
        escalation is a STICKY latch: it engages at SEVERE_FACTOR x
        enter_ms but only releases once the EWMA is back DOWN to
        enter_ms AND no shed fired for EXIT_SHED_QUIET_S — releasing at
        the engage threshold (or while refusals were still streaming)
        made the floor oscillate (shed -> queue drains -> re-admit ->
        queue spikes) and each re-admit spike landed on the protected
        class's tail."""
        if self.ewma_ms >= self.enter_ms * SEVERE_FACTOR:
            self.severe = True
        elif (
            self.ewma_ms <= self.enter_ms
            and time.perf_counter() - self._last_shed >= EXIT_SHED_QUIET_S
        ):
            self.severe = False
        floor = self.protect if self.severe else len(self.order) - 1
        return max(min(floor, len(self.order) - 1), self.protect)

    def admit(self, cls: str, forced: bool = False) -> int | None:
        """None = admitted (caller MUST pair with done()); an int is the
        retry-after hint in ms for a typed BUSY refusal. ``forced`` is
        the armed ``admission.shed`` failpoint: shed every sheddable
        (non-control) class regardless of state — the deterministic
        drill lever."""
        rank = self._rank.get(cls, len(self.order) - 1)
        if (
            self.queue_bytes_cap
            and self.queued_bytes > self.queue_bytes_cap
        ):
            # the hard bound outranks priority: admitting ANY class
            # grows reply bytes the consumers are not draining
            return self._refuse(cls, rank)
        if forced and rank > 0:
            return self._refuse(cls, rank)
        if self.enabled and self.overloaded and rank >= self._shed_floor():
            return self._refuse(cls, rank)
        self.inflight += 1
        return None

    def _refuse(self, cls: str, rank: int) -> int:
        self.shed[cls] += 1
        # every refusal restarts the de-escalation quiet window: see
        # EXIT_SHED_QUIET_S — refusals ARE the ongoing-pressure signal
        self._last_shed = time.perf_counter()
        return self._hint_ms(rank)

    def done(self, cls: str, seconds: float) -> None:
        """Completion of an admitted dispatch: feeds the latency EWMA
        and steps the hysteresis state machine. ``seconds`` <= 0 means
        the caller had timing disabled — the depth signal still runs."""
        if self.inflight > 0:
            self.inflight -= 1
        if seconds > 0.0:
            ms = seconds * 1e3
            now = time.perf_counter()
            stale = now - self._last_done > IDLE_RESET_S
            self._last_done = now
            if not self._ewma_init or stale:
                self.ewma_ms = ms
                self._ewma_init = True
            else:
                self.ewma_ms += EWMA_ALPHA * (ms - self.ewma_ms)
        if not self.enabled:
            return
        pressure = (
            self.ewma_ms >= self.enter_ms or self.inflight >= self.depth_hi
        )
        if not self.overloaded:
            self._hot = self._hot + 1 if pressure else 0
            if self._hot >= ENTER_STREAK:
                self._enter()
        else:
            calm = (
                self.ewma_ms <= self.exit_ms
                and self.inflight < self.depth_hi
                and time.perf_counter() - self._last_shed >= EXIT_SHED_QUIET_S
            )
            self._cool = self._cool + 1 if calm else 0
            if self._cool >= EXIT_STREAK:
                self._exit()

    def _enter(self) -> None:
        self.overloaded = True
        self.enters += 1
        self._hot = 0
        self._cool = 0
        if self._reg is not None:
            self._reg.gauge_set("serving.overload", 1.0)
            self._reg.trace_event(
                "serving", "overload_enter", "",
                f"ewma_ms={self.ewma_ms:.1f} inflight={self.inflight}",
            )

    def _exit(self) -> None:
        self.overloaded = False
        self.severe = False
        self.exits += 1
        self._hot = 0
        self._cool = 0
        if self._reg is not None:
            self._reg.gauge_set("serving.overload", 0.0)
            self._reg.trace_event(
                "serving", "overload_exit", "",
                f"ewma_ms={self.ewma_ms:.1f} shed={sum(self.shed.values())}",
            )

    # ---- queued-bytes accounting (slow-consumer OOM bound) ----------------

    def note_conn_queued(self, conn_id: int, nbytes: int) -> None:
        """Current un-drained reply bytes for one connection (transport
        write buffer + the server's per-connection reply buffer);
        maintained incrementally so the total is O(1) per update."""
        prev = self._conn_q.get(conn_id, 0)
        if nbytes != prev:
            self._conn_q[conn_id] = nbytes
            self.queued_bytes += nbytes - prev
            if self._reg is not None and self._reg.enabled:
                self._reg.gauge_set(
                    "serving.queued_bytes", float(self.queued_bytes)
                )

    def drop_conn(self, conn_id: int) -> None:
        self.note_conn_queued(conn_id, 0)
        self._conn_q.pop(conn_id, None)

    # ---- reporting (OVERLOAD section of SYSTEM METRICS, prom.py) ----------

    def metrics_totals(self) -> dict[str, int]:
        """Glossary order, stable for dashboards (docs/operations.md):
        the declared state first, then transitions, then per-class shed
        counters, then the live signals."""
        out = {
            "armed": 1 if self.armed else 0,
            "state": 1 if self.overloaded else 0,
            "enters": self.enters,
            "exits": self.exits,
        }
        for cls in CLASSES:
            out[f"shed_{cls}"] = self.shed[cls]
        out["ewma_us"] = int(self.ewma_ms * 1e3)
        out["inflight"] = self.inflight
        out["queued_bytes"] = self.queued_bytes
        return out


async def gate(adm: AdmissionController, cls: str) -> int | None:
    """The server's per-dispatch admission consult: the async fault
    seam (``admission.shed`` — drills force shedding without real
    overload; async so an injected sleep stalls only this connection,
    the JL101 lesson from native.scan_apply) wrapped around the sync
    decision. None = admitted, else the retry-after hint in ms."""
    forced = False
    try:
        await faults.async_point("admission.shed")
    except faults.FaultError:
        forced = True
    return adm.admit(cls, forced=forced)
