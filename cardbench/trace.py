"""The traced run's window: ``torch.profiler`` over the node's CUDA work,
and host spans that this file records around the calls into the node's
layers.

The spans are the benchmark's own: for the traced run it wraps the
cluster codec's ``decode`` (one frame), each repo manager's
``converge_deltas`` (one converge slice), ``_apply_core`` (one command
on the Python path) and each repo's ``drain``, timing each call on the
host clock, and the interpreter's full (generation 2) collections. The profiler gives the device's activity: kernels, copies
and fills with their start and length. Two marks recorded through the
profiler on this thread tie the host clock to the trace's.

From them: ``busy_s``, the union of the device's busy intervals in the
window; ``window_s``, the traced window; the device time of each
operation by name; and the device's idle time split by what the host
was doing (the spans that cover it; spans of two threads may overlap,
and time no span covers is "host, no span").
"""

from __future__ import annotations

import functools
import gc
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "cardbench.mark"
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip() or name


class Tracer:
    def __init__(self, db):
        self.db = db
        self.spans: list[tuple[str, float, float]] = []
        self._undo: list = []
        self.prof = None
        self.marks: list[float] = []

    def _wrap(self, obj, attr: str, label: str) -> None:
        orig = getattr(obj, attr)
        spans = self.spans

        @functools.wraps(orig)  # keeps the attributes a function carries (counters)
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                spans.append((label, t0, time.perf_counter()))

        had = attr in vars(obj)
        try:
            setattr(obj, attr, timed)
        except AttributeError:  # an object with slots: left untimed
            return
        self._undo.append((obj, attr, orig, had))

    def _gc(self, phase: str, info: dict) -> None:
        """The interpreter's full collections, which stop every thread."""
        if info["generation"] == 2:
            if phase == "start":
                self._gc_t0 = time.perf_counter()
            elif self._gc_t0 is not None:
                self.spans.append(("gc gen2", self._gc_t0, time.perf_counter()))
                self._gc_t0 = None

    def install(self) -> None:
        from jylis_tpu_torch.cluster import codec

        self._gc_t0 = None
        gc.callbacks.append(self._gc)
        self._wrap(codec, "decode", "decode frame")
        for mgr in self.db.managers():
            self._wrap(mgr, "converge_deltas", f"converge {mgr.name}")
            self._wrap(mgr, "_apply_core", f"apply {mgr.name}")
            self._wrap(mgr.repo, "drain", f"drain {mgr.name}")

    def uninstall(self) -> None:
        gc.callbacks.remove(self._gc)
        for obj, attr, orig, had in reversed(self._undo):
            if had:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)  # the class's own method again
        self._undo.clear()

    def _mark(self) -> None:
        import torch

        with torch.profiler.record_function(MARK):
            self.marks.append(time.perf_counter())

    def _sync(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.install()
        self._sync()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._mark()

    def stop(self) -> dict:
        self._sync()
        self._mark()
        self.prof.stop()
        self.uninstall()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return summarize(events, self.spans, self.marks)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """Total length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def summarize(events: list, spans: list, marks: list) -> dict:
    """The traced window's record from the chrome trace's events (times
    in us), the host spans and the two marks (perf_counter seconds)."""
    mark_ts = sorted(e["ts"] for e in events if e.get("name") == MARK and "ts" in e)
    if len(mark_ts) < 2:
        raise RuntimeError("the profiler's trace lacks the window's marks")
    w0, w1 = mark_ts[0], mark_ts[-1]
    offset = w0 - marks[0] * 1e6  # trace us = perf_counter s * 1e6 + offset
    busy, ops = [], defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)
        if b > a:
            busy.append((a, b))
            ops[short_name(e["name"])] += (b - a) / 1e6
    busy = _union(busy)
    window_us = w1 - w0
    busy_us = sum(b - a for a, b in busy)
    idle, at = [], w0
    for a, b in busy:
        if a > at:
            idle.append([at, a])
        at = max(at, b)
    if at < w1:
        idle.append([at, w1])
    by_label = defaultdict(list)
    for label, t0, t1 in spans:
        by_label[label].append((t0 * 1e6 + offset, t1 * 1e6 + offset))
    idle_by = {}
    for label, ivs in by_label.items():
        s = _overlap(idle, _union(ivs)) / 1e6
        if s > 0:
            idle_by[label] = s
    covered = _overlap(idle, _union([iv for ivs in by_label.values() for iv in ivs]))
    idle_by["host, no span"] = (window_us - busy_us - covered) / 1e6
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
    return {
        "window_s": window_us / 1e6, "busy_s": busy_us / 1e6,
        "device_ops": dict(ops),
        "breakdown": {"device_ops": rank(ops), "idle_gaps": rank(idle_by)},
    }
