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
"""

from __future__ import annotations

import time
from collections import defaultdict, deque

from . import GAUGES, SEAMS
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


class MetricsRegistry:
    def __init__(self, trace_cap: int = 512):
        self.enabled = True
        # per-type device drain accumulators (batches / keys / seconds)
        self.counters: dict[str, dict[str, float]] = defaultdict(
            lambda: {"batches": 0, "keys": 0, "seconds": 0.0}
        )
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

    # ---- counters ----------------------------------------------------------

    def note_drain(self, name: str, n_keys: int, seconds: float) -> None:
        c = self.counters[name]
        c["batches"] += 1
        c["keys"] += n_keys
        c["seconds"] += seconds
        h = self.hists.get("drain." + name)
        if h is not None:
            h.record(seconds)

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
