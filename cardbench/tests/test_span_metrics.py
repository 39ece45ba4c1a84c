"""The readers of the program's spans (SYSTEM METRICS' SPAN section): on
a synthetic record, on a record of a program without the section, and
in a whole traced run of the cell on the CPU."""

from __future__ import annotations

import pytest

from cardbench import run
from cardbench.tests.cells import small_cell

NEW = ("get_lock_wait_ms_mean", "converge_lock_hold_ms_mean", "converge_us_per_key",
       "decode_ms_per_frame", "drain_fill_ms_mean", "gc_full_ms_per_s")


def record(before: dict, after: dict, window_s: float = 10.0) -> dict:
    return {"config": {"type": "PNCOUNT"}, "window_s": window_s,
            "system_metrics": {"before": before, "after": after}}


def spans(**fields) -> dict:
    """SYSTEM METRICS as Resp.metrics parses it, from name=(count, ms,
    items) and a few drain counters."""
    out = {"PNCOUNT drains": fields.pop("drains", 0)}
    for name, (count, ms, items) in fields.items():
        name = name.replace("__", ".")
        out |= {f"SPAN {name} count": count, f"SPAN {name} ms": ms, f"SPAN {name} items": items}
    return out


BEFORE = spans(lock_wait__PNCOUNT__apply=(10, 100.0, 0),
               lock_hold__PNCOUNT__converge=(5, 50.0, 0),
               converge__PNCOUNT=(20, 40.0, 5000),
               decode__frame=(5, 10.0, 1 << 20),
               drain__PNCOUNT__fill=(3, 30.0, 60000),
               gc__full=(2, 100.0, 0), drains=3)
AFTER = spans(lock_wait__PNCOUNT__apply=(210, 60100.0, 0),
              lock_hold__PNCOUNT__converge=(85, 3650.0, 0),
              converge__PNCOUNT=(660, 3240.0, 165000),
              decode__frame=(85, 410.0, 17 << 20),
              drain__PNCOUNT__fill=(23, 1230.0, 460000),
              gc__full=(22, 2100.0, 0), drains=23)
WANT = {
    "get_lock_wait_ms_mean": 60000.0 / 200,    # ms over waits
    "converge_lock_hold_ms_mean": 3600.0 / 80,  # ms over holds
    "converge_us_per_key": 3200.0 * 1e3 / 160000,  # us over keys
    "decode_ms_per_frame": 400.0 / 80,
    "drain_fill_ms_mean": 1200.0 / 20,          # fill ms over drains
    "gc_full_ms_per_s": 2000.0 / 10.0,          # ms over the window's s
}


@pytest.mark.parametrize("name", NEW)
def test_reads_the_growth_of_its_span(name):
    assert run.reader(name)(record(BEFORE, AFTER)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_the_span_section(name):
    """A program without the spans (the parent of the change that added
    them) reads None, and nothing raises; drains alone give no fill."""
    old = {"PNCOUNT drains": 3.0, "PNCOUNT keys": 100.0, "PNCOUNT device_ms": 9.0}
    new = {"PNCOUNT drains": 9.0, "PNCOUNT keys": 900.0, "PNCOUNT device_ms": 99.0}
    assert run.reader(name)(record(old, new)) is None


@pytest.mark.parametrize("name", NEW)
def test_no_growth_reads_none_but_gc_reads_zero(name):
    got = run.reader(name)(record(BEFORE, BEFORE))
    assert got == (0.0 if name == "gc_full_ms_per_s" else None)


def test_a_traced_run_reports_every_span_metric_on_the_cpu():
    """The cell, small, traced, on the CPU: each new metric is there and
    the counters agree with the run's own records."""
    cell = small_cell("pn100k-r8.sweep-read")
    out = run.run_cell(cell, 2**33 + 5, 2.0, True, device="cpu")
    result, rec = out["result"], out["record"]
    assert result["correct"], result["checks"]
    for name in NEW:
        assert result["metrics"][name]["value"] >= 0, name
    d = lambda line: (rec["system_metrics"]["after"].get(line, 0)  # noqa: E731
                      - rec["system_metrics"]["before"].get(line, 0))
    drains = d("PNCOUNT drains")
    assert drains > 0
    for phase in ("collect", "fill", "launch", "wait", "finish"):
        assert d(f"SPAN drain.PNCOUNT.{phase} count") == drains, phase
    assert d("SPAN drain.PNCOUNT.collect items") == d("PNCOUNT keys")
    # every key the peers sent in the window converges, within one frame
    # a peer of what was in flight at its edges
    sent = rec["merges"]
    frame = cell["traffic"]["frame_keys"]
    assert abs(d("SPAN converge.PNCOUNT items") - sent) <= cell["config"]["replicas"] * frame
