"""Per-Database metrics registry.

The port's copy of jylis_tpu/obs/registry.py (:1-184), unchanged in
behaviour. The whole observability surface -- drain / journal / serving
counters, histograms, gauges, trace ring -- is a per-`Database`
instance: Database creates one and hands it to its repos (drain timing)
and RepoSYSTEM reads it for `SYSTEM METRICS` / `LATENCY` / `TRACE`.
utils/metrics.py keeps a process-wide DEFAULT instance so registry-less
direct drives (standalone repos) still record somewhere.

``enabled`` is the one switch the seams check before paying for
`perf_counter` pairs. Histogram and gauge names are pre-registered from
obs.SEAMS/GAUGES -- `hist()` raises KeyError on an undeclared name.

The port adds spans (``span``): the names of obs.SPANS and those a
caller declares (``declare_spans``: each repo manager its lock's and
converge's), each with a count, host seconds and items, always on while ``enabled`` (SYSTEM
METRICS' SPAN section). While a torch profiler records, a span also
opens a profiler range of its name and closes it by handle, so a span
may cross an ``await`` while other coroutines open ranges on the same
thread. A range carries ``SPAN_ID``'s value as its argument when it is
set: the repo lock's helper (models/manager.py) sets it per acquisition,
and ``asyncio.to_thread`` copies it into the worker thread, so a
command's lock wait and the drain it triggers carry one id. A span's
totals are updated by one thread at a time: the loop thread alone takes
the locks, converges and decodes, a repo lock serialises its type's
drains, and collections do not overlap.
"""

from __future__ import annotations

import contextvars
import time
from collections import defaultdict, deque

import torch
import torch.autograd.profiler as _tprof

from . import GAUGES, SEAMS, SPANS
from .hist import Histogram
from .jtrace import SpanStats
from .trace import TraceRing

JOURNAL_KEYS = ("appends", "bytes", "fsyncs", "replayed_batches", "errors")

# windowed-quantile marks: how many point-in-time seam copies we keep,
# and the minimum spacing between deposits (an opportunistic deposit on
# every scrape/SYSTEM LATENCY call must not grow cost with poll rate)
WINDOW_MARKS = 64
WINDOW_MIN_SPACING_S = 1.0

HEAT_FANOUT = 256  # digest-tree leaf fanout (models/database.py SYNC_FANOUT)

# the id a span's profiler range carries (0: none)
SPAN_ID: contextvars.ContextVar[int] = contextvars.ContextVar("span_id", default=0)
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit


class _Span:
    """One open span: ``close`` (or leaving a ``with``) adds one to its
    name's count, the host seconds since it opened and ``items``, and
    ends the profiler range it opened, if any; after ``cancel`` it only
    ends the range."""

    __slots__ = ("_tot", "_t0", "_range", "items")

    def __init__(self, tot: list, items: int, name: str):
        self._tot = tot
        self.items = items
        self._range = None
        if _tprof._is_profiler_enabled:  # a profiler records somewhere
            sid = SPAN_ID.get()
            self._range = _range_enter(name, sid) if sid else _range_enter(name)
        self._t0 = time.perf_counter()

    def close(self) -> None:
        tot = self._tot
        if tot is not None:
            tot[1] += time.perf_counter() - self._t0
            tot[0] += 1
            tot[2] += self.items
        if self._range is not None:
            _range_exit(self._range)

    def cancel(self) -> None:
        """Count nothing at the close (a drain that found nothing)."""
        self._tot = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _NullSpan:
    """The span of a disabled registry: records nothing."""

    __slots__ = ("items",)

    def close(self) -> None:
        pass

    def cancel(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


def null_span(name: str, items: int = 0) -> _NullSpan:
    """``MetricsRegistry.span``'s stand-in where there is no registry."""
    return NULL_SPAN


class MetricsRegistry:
    def __init__(self, trace_cap: int = 512):
        self.enabled = True
        # per-type device drain accumulators (batches / keys / seconds)
        self.counters: dict[str, dict[str, float]] = defaultdict(
            lambda: {"batches": 0, "keys": 0, "seconds": 0.0}
        )
        # per counter type, the converged keys whose delta was read as a
        # generic mapping, not in place from the wire (repo_counters
        # converge_batch); a type appears at its first converge
        self.converge_mapped: dict[str, int] = {}
        # delta write-ahead journal counters: appends / bytes / fsyncs
        # accrue on the writer thread, replayed_batches on boot
        # recovery, errors on ANY writer-side encode/write/fsync failure
        self.journal_counters: dict[str, int] = dict.fromkeys(JOURNAL_KEYS, 0)
        # True once a journal is attached (Database.set_journal): the
        # JOURNAL section of SYSTEM METRICS then shows explicit zeros
        # from boot instead of appearing at the first nonzero counter
        self.journal_enabled = False
        # serving-path: whole-connection demotions off the native engine
        # + per-command-class admission-control refusals (manager.py)
        self.serving_counters: dict[str, int] = {
            "demotions": 0,
            "busy_refusals": 0,
        }
        self.hists: dict[str, Histogram] = {name: Histogram() for name in SEAMS}
        self.gauges: dict[str, float] = {name: 0.0 for name in GAUGES}
        self.trace = TraceRing(trace_cap)
        # provenance-span folds (obs/jtrace.py): per-hop + per-region-
        # pair convergence histograms, SLO counters, worst exemplars
        self.spans = SpanStats()
        # per-digest-tree-bucket write heat: type -> 256 counters over
        # sha256(key)[0], counted where deltas are emitted (manager.py
        # _emit)
        self.write_heat: dict[str, list[int]] = {}
        # windowed quantiles: (monotonic ts, {seam: Histogram.mark()})
        self._window_marks: deque = deque(maxlen=WINDOW_MARKS)
        # spans: name -> [count, host seconds, items], every declared
        # name in the order declared; the open full collection's span
        # (gc_callback)
        self.span_totals: dict[str, list] = {name: [0, 0.0, 0] for name in SPANS}
        self._gc_span = None

    # ---- counters ----------------------------------------------------------

    def note_drain(self, name: str, n_keys: int, seconds: float) -> None:
        c = self.counters[name]
        c["batches"] += 1
        c["keys"] += n_keys
        c["seconds"] += seconds
        h = self.hists.get("drain." + name)
        if h is not None:
            h.record(seconds)

    def note_converge_mapped(self, name: str, n: int) -> None:
        self.converge_mapped[name] = self.converge_mapped.get(name, 0) + n

    def note_journal(self, counter: str, n: int = 1) -> None:
        self.journal_counters[counter] += n

    def note_serving(self, counter: str, n: int = 1) -> None:
        self.serving_counters[counter] += n

    def note_write_heat(self, name: str, bucket: int, n: int = 1) -> None:
        """One emitted delta batch touched ``bucket`` of ``name``'s
        digest tree (0..255). Lazy per-type vectors: a type that never
        writes costs nothing."""
        heat = self.write_heat.get(name)
        if heat is None:
            heat = self.write_heat[name] = [0] * HEAT_FANOUT
        heat[bucket] += n

    # ---- spans -------------------------------------------------------------

    def declare_spans(self, names) -> None:
        """Declare more span names (zeros until they record); a name
        already declared keeps its totals."""
        for name in names:
            self.span_totals.setdefault(name, [0, 0.0, 0])

    def span(self, name: str, items: int = 0):
        """An open span of the declared ``name`` (KeyError otherwise):
        use it as a ``with`` block, or ``close()`` it; ``items`` may be
        set until it closes."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self.span_totals[name], items, name)

    def gc_callback(self, phase: str, info: dict) -> None:
        """For ``gc.callbacks``: each full (generation 2) collection is
        a ``gc.full`` span (main.build_node registers it for its node)."""
        if info["generation"] != 2:
            return
        if phase == "start":
            self._gc_span = self.span("gc.full")
        elif self._gc_span is not None:
            self._gc_span.close()
            self._gc_span = None

    def span_stats(self):
        """(name, count, ms, items) per declared span, in the order
        declared."""
        for name, (count, seconds, items) in self.span_totals.items():
            yield name, count, seconds * 1e3, items

    # ---- histograms / gauges / trace --------------------------------------

    def hist(self, name: str) -> Histogram:
        return self.hists[name]  # KeyError = undeclared seam, fail loud

    def gauge_set(self, name: str, value: float) -> None:
        if name not in self.gauges:
            raise KeyError(name)  # undeclared gauge, fail loud
        self.gauges[name] = value

    def trace_event(
        self, subsystem: str, event: str, reason: str = "", detail: str = ""
    ) -> None:
        if self.enabled:
            self.trace.push(subsystem, event, reason, detail)

    # ---- reporting ---------------------------------------------------------

    def type_stats(self):
        """(name, drains, keys, device_ms) per drained type — the ONE
        iteration the reporting surfaces share. list() snapshots the key
        set atomically under the GIL: note_drain runs in worker threads
        and may insert a type's key mid-request."""
        for name in sorted(list(self.counters)):
            c = self.counters.get(name)
            if c is not None:
                yield name, int(c["batches"]), int(c["keys"]), c["seconds"] * 1e3

    def seam_stats(self):
        """(name, snapshot) per declared seam, SEAMS order."""
        for name in SEAMS:
            yield name, self.hists[name].snapshot()

    # ---- windowed quantiles ------------------------------------------------

    def window_deposit(self) -> None:
        """Opportunistically deposit a point-in-time mark of every seam
        (called from the reporting surfaces — SYSTEM LATENCY, the
        scrape — never the hot path). Rate-limited so poll frequency
        can't inflate the cost; the ring keeps ~the last minute."""
        now = time.monotonic()
        if self._window_marks and (
            now - self._window_marks[-1][0] < WINDOW_MIN_SPACING_S
        ):
            return
        self._window_marks.append(
            (now, {name: self.hists[name].mark() for name in SEAMS})
        )

    def window_stats(self, seconds: float):
        """(achieved_window_s, [(name, delta_snapshot), ...]) against
        the deposited mark closest to ``seconds`` ago — delta-since-mark
        quantiles, so a regression on a long-running node isn't drowned
        by since-boot history. Returns (0.0, None) when no mark is old
        enough to subtract (callers report 'no window yet')."""
        if not self._window_marks:
            return 0.0, None
        now = time.monotonic()
        best = min(
            self._window_marks,
            key=lambda m: abs((now - m[0]) - seconds),
        )
        achieved = now - best[0]
        if achieved <= 0.0:
            return 0.0, None
        marks = best[1]
        return achieved, [
            (name, self.hists[name].snapshot_since(marks[name]))
            for name in SEAMS
        ]

    def report(self) -> str:
        parts = [
            f"{name}: {drains} drains, {keys} keys, {ms:.1f}ms device"
            for name, drains, keys, ms in self.type_stats()
        ]
        return "; ".join(parts) if parts else "no drains"
