"""The port's spans (obs/registry.py ``MetricsRegistry.span``, obs.SPANS):
the repo locks' waits and holds, converge slices, frame decodes, the
drains' phases and full collections, their counters in SYSTEM METRICS'
SPAN section, their profiler ranges, ``JYLIS_PROFILE_DIR``, and the
counter drains' key count, all on the CPU."""

from __future__ import annotations

import asyncio
import gc
import json
import time

import pytest
import torch

from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.cluster.cluster import Cluster, wire_frame
from jylis_tpu_torch.cluster.msg import MsgPushDeltas
from jylis_tpu_torch.models.database import Database
from jylis_tpu_torch.obs import SPAN_FIELDS, SPANS
from jylis_tpu_torch.obs import registry as registry_mod
from jylis_tpu_torch.obs.registry import MetricsRegistry
from jylis_tpu_torch.server.resp import Respond
from jylis_tpu_torch.system import System
from jylis_tpu_torch.utils import metrics
from jylis_tpu_torch.utils.address import Address
from jylis_tpu_torch.utils.config import Config
from jylis_tpu_torch.utils.log import Log

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers

PHASES = ("collect", "fill", "launch", "wait", "finish")


def pn_batch(n: int, rid: int = 7, first: int = 0):
    return [(b"k%06d" % i, ({rid: i + 1}, {rid: 1})) for i in range(first, first + n)]


def span(db, name: str) -> list:
    """[count, seconds, items] of one span."""
    return list(db.metrics.span_totals[name])


async def get(db, key: bytes, kind: str = "PNCOUNT") -> bytes:
    out = bytearray()
    await db.manager(kind).apply_async(Respond(out.extend), [kind.encode(), b"GET", key])
    return bytes(out)


def test_every_declared_span_shows_from_boot_with_zeros():
    lines = metrics.metric_lines(registry=MetricsRegistry())
    spans = [ln for ln in lines if ln.startswith("SPAN ")]
    assert spans == [f"SPAN {s} {f} {'0.0' if f == 'ms' else 0}"
                     for s in SPANS for f in SPAN_FIELDS]
    assert lines[-len(spans):] == spans  # the section ends the reply
    with pytest.raises(KeyError):
        MetricsRegistry().span("lock_wait.PNCOUNT.apply")  # no manager declared it


@pytest.mark.parametrize("engine", ["python", "auto"])
def test_each_manager_declares_the_spans_its_lockers_can_record(engine):
    """A Database's registry holds the node-wide spans, then each
    manager's converge and its lock's wait and hold for every caller that
    can take that lock: the server's native burst only the five
    engine-backed types', and only with a native engine."""
    db = Database(5, device="cpu", engine=engine)
    names = list(db.metrics.span_totals)
    burst = ("TREG", "TLOG", "GCOUNT", "PNCOUNT", "UJSON")
    want = list(SPANS)
    for mgr in db.managers():
        t = mgr.name
        whos = ("apply", "converge", "flush", "sync", "shutdown")
        if db.native_engine is not None and t in burst:
            whos += ("native",)
        want += [f"lock_{k}.{t}.{w}" for w in whos for k in ("wait", "hold")]
        want.append(f"converge.{t}")
    assert names == want
    assert len(db.managers()) == 9  # the eight data types and SYSTEM
    assert ("lock_wait.PNCOUNT.native" in names) == (engine == "auto")
    lines = metrics.metric_lines(registry=db.metrics)
    assert [ln.rsplit(" ", 1)[0] for ln in lines if ln.startswith("SPAN ")] == \
        [f"SPAN {s} {f}" for s in want for f in SPAN_FIELDS]
    for name in ("lock_wait.MAP.native", "lock_hold.SYSTEM.native"):
        with pytest.raises(KeyError):
            db.metrics.span(name)


def test_a_600_key_converge_is_three_slices():
    db = Database(5, device="cpu", engine="python")
    asyncio.run(db.converge_async("PNCOUNT", pn_batch(600)))
    assert span(db, "converge.PNCOUNT")[::2] == [3, 600]
    assert span(db, "lock_wait.PNCOUNT.converge")[0] == 1
    assert span(db, "lock_hold.PNCOUNT.converge")[0] == 1
    assert span(db, "lock_hold.PNCOUNT.converge")[1] >= span(db, "converge.PNCOUNT")[1]


def test_a_get_queued_behind_a_held_lock_records_its_wait():
    db = Database(5, device="cpu", engine="python")
    mgr = db.manager("PNCOUNT")

    async def main():
        await db.converge_async("PNCOUNT", pn_batch(10))
        async with mgr.locked("sync"):
            task = asyncio.ensure_future(get(db, b"k000003"))
            await asyncio.sleep(0)  # the GET queues on the lock
            t0 = time.perf_counter()
            await asyncio.sleep(0.05)
            held = time.perf_counter() - t0
        return await task, held

    reply, held = asyncio.run(main())
    assert reply == b":3\r\n"  # p 4 - n 1
    count, seconds, _ = span(db, "lock_wait.PNCOUNT.apply")
    assert count == 1 and seconds >= held
    assert span(db, "lock_hold.PNCOUNT.apply")[0] == 1
    assert span(db, "lock_hold.PNCOUNT.sync")[0] == 1


def test_one_drain_records_its_five_phases():
    """Each phase once, with the batch's keys as items, the five covering
    at least 90% of the drain's time (timed_drain's device_ms)."""
    db = Database(5, device="cpu", engine="python")
    asyncio.run(db.converge_async("PNCOUNT", pn_batch(20000)))
    before = db.metrics.counters["PNCOUNT"]["seconds"]
    assert asyncio.run(get(db, b"k000001")) == b":1\r\n"
    drain_s = db.metrics.counters["PNCOUNT"]["seconds"] - before
    assert db.metrics.counters["PNCOUNT"]["batches"] == 1
    total = 0.0
    for phase in PHASES:
        count, seconds, items = span(db, f"drain.PNCOUNT.{phase}")
        assert (count, items) == (1, 20000), phase
        total += seconds
    assert 0.9 * drain_s <= total <= drain_s


def test_a_treg_drain_records_its_five_phases():
    db = Database(5, device="cpu", engine="python")
    repo = db.manager("TREG").repo
    for i in range(300):
        repo.converge(b"r%04d" % i, (b"v%d" % i, 10 + i))
    repo.drain()
    repo.drain()  # nothing pending: counts nothing
    for phase in PHASES:
        count, _, items = span(db, f"drain.TREG.{phase}")
        assert (count, items) == (1, 300), phase
    assert db.metrics.counters["TREG"]["keys"] == 300


def test_a_full_collection_is_one_gc_full_span():
    reg = MetricsRegistry()
    gc.callbacks.append(reg.gc_callback)
    try:
        gc.collect(0)
        gc.collect(1)
        assert reg.span_totals["gc.full"][0] == 0
        gc.collect()
        assert reg.span_totals["gc.full"][0] == 1
    finally:
        gc.callbacks.remove(reg.gc_callback)


def test_two_cluster_frames_are_two_decodes():
    config = Config()
    config.port = "0"
    config.addr = Address("127.0.0.1", "0", "spans")
    config.heartbeat_time = 0.05
    config.log = Log.create_none()
    system = System(config)
    db = Database(5, device="cpu", engine="python", system_repo=system.repo)
    cluster = Cluster(config, db)

    async def main():
        await cluster.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", cluster.listen_port)
            writer.write(wire_frame(codec.signature()))
            await reader.read(1 << 16)  # the passive side's echo
            frames = [codec.encode(MsgPushDeltas("PNCOUNT", tuple(pn_batch(4, first=4 * j))))
                      for j in range(2)]
            writer.write(b"".join(wire_frame(f) for f in frames))
            await writer.drain()
            for _ in range(400):
                if span(db, "converge.PNCOUNT")[2] == 8:
                    break
                await asyncio.sleep(0.01)
            writer.close()
            return sum(len(f) for f in frames)
        finally:
            cluster.dispose()

    nbytes = asyncio.run(main())
    assert span(db, "decode.frame")[::2] == [2, nbytes]
    assert span(db, "converge.PNCOUNT")[::2] == [2, 8]


def test_a_disabled_registry_counts_nothing():
    db = Database(5, device="cpu", engine="python")
    db.metrics.enabled = False
    gc.callbacks.append(db.metrics.gc_callback)
    try:
        asyncio.run(db.converge_async("PNCOUNT", pn_batch(600)))
        assert asyncio.run(get(db, b"k000002")) == b":2\r\n"
        gc.collect()
    finally:
        gc.callbacks.remove(db.metrics.gc_callback)
    assert all(t == [0, 0.0, 0] for t in db.metrics.span_totals.values())


def test_no_range_is_opened_without_a_recording_profiler(monkeypatch):
    def fail(*a):
        raise AssertionError("a range opened with no profiler recording")

    monkeypatch.setattr(registry_mod, "_range_enter", fail)
    db = Database(5, device="cpu", engine="python")
    asyncio.run(db.converge_async("PNCOUNT", pn_batch(300)))
    assert asyncio.run(get(db, b"k000002")) == b":2\r\n"
    assert span(db, "drain.PNCOUNT.wait")[0] == 1


def trace_events(path) -> list[dict]:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_profiler_ranges_hold_the_spans_and_interleaved_waits_whole(tmp_path):
    """Under a recording profiler (every thread, shapes recorded): the
    spans' ranges, a command's lock wait and the drain it runs in a
    worker thread carrying one id, and two coroutines' waits on one
    thread that interleave, each whole."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    db = Database(5, device="cpu", engine="python")
    mgr = db.manager("PNCOUNT")

    async def main():
        await db.converge_async("PNCOUNT", pn_batch(300))
        async with mgr.locked("sync"):
            read = asyncio.ensure_future(get(db, b"k000009"))
            await asyncio.sleep(0)
            more = asyncio.ensure_future(db.converge_async("PNCOUNT", pn_batch(10, rid=8)))
            await asyncio.sleep(0.03)
        return await read, await more

    prof = profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    try:
        reply, _ = asyncio.run(main())
    finally:
        prof.stop()
    assert reply == b":9\r\n"
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    by_name = {}
    for e in trace_events(path):
        by_name.setdefault(e["name"], []).append(e)
    for name in ("lock_wait.PNCOUNT.apply", "lock_hold.PNCOUNT.apply",
                 "lock_wait.PNCOUNT.converge", "lock_hold.PNCOUNT.converge",
                 "lock_hold.PNCOUNT.sync", "converge.PNCOUNT",
                 *(f"drain.PNCOUNT.{p}" for p in PHASES)):
        assert name in by_name, name
    (wait_get,) = by_name["lock_wait.PNCOUNT.apply"]
    wait_conv = by_name["lock_wait.PNCOUNT.converge"][-1]
    a0, a1 = wait_get["ts"], wait_get["ts"] + wait_get["dur"]
    b0, b1 = wait_conv["ts"], wait_conv["ts"] + wait_conv["dur"]
    assert a0 < b0 < a1 < b1  # interleaved, not nested
    assert wait_get["dur"] >= 30e3 and b1 - a1 >= by_name["lock_hold.PNCOUNT.apply"][0]["dur"]
    # the GET's wait and its drain's phases carry one id
    sid = wait_get["args"]["Concrete Inputs"]
    assert sid not in ([], [""])
    for p in PHASES:
        (drain,) = by_name[f"drain.PNCOUNT.{p}"]
        assert drain["args"]["Concrete Inputs"] == sid, p
    assert wait_conv["args"]["Concrete Inputs"] != sid


def test_profile_dir_records_the_served_node_through_its_spans(tmp_path, monkeypatch):
    """JYLIS_PROFILE_DIR: the session starts when the node serves and the
    clean shutdown writes it, its ranges the spans; build_node's gc hook
    goes at shutdown."""
    from jylis_tpu_torch.main import build_node, serve
    from jylis_tpu_torch.utils.config import config_from_cli

    out = tmp_path / "prof"
    monkeypatch.setenv("JYLIS_PROFILE_DIR", str(out))
    config = config_from_cli(["--device", "cpu", "-p", "0", "-a", "127.0.0.1:0:prof",
                              "-L", "warn"])

    async def main():
        node = build_node(config)
        hook = node.database.metrics.gc_callback
        assert hook in gc.callbacks
        dispose = await serve(node)
        await node.database.converge_async("PNCOUNT", pn_batch(20))
        assert await get(node.database, b"k000004") == b":4\r\n"
        gc.collect()
        dispose.dispose()
        await dispose.done.wait()
        return hook

    hook = asyncio.run(main())
    assert hook not in gc.callbacks
    assert metrics._profiler is None
    (path,) = [p for p in out.iterdir() if p.name.endswith(".json")]
    names = {e["name"] for e in trace_events(path)}
    for name in ("lock_hold.PNCOUNT.apply", "converge.PNCOUNT", "drain.PNCOUNT.fill",
                 "gc.full", "lock_wait.PNCOUNT.shutdown"):
        assert name in names, name
    assert not any(n.startswith("drain_") for n in names)  # the old drain ranges


@pytest.mark.parametrize("engine", ["python", "auto"])
@pytest.mark.parametrize("kind", ["GCOUNT", "PNCOUNT"])
@pytest.mark.parametrize("batch", ["own", "foreign", "mixed", "idle"])
def test_drain_key_count_reads_as_the_pending_union(engine, kind, batch):
    """``<TYPE> keys`` and ``drains`` grow as they did when the count was
    the union of the own pending rows and the buffered foreign rows,
    read before the drain: own-only, foreign-only and mixed batches, and
    own rows with nothing to join (INC 0), counted though they join
    nothing."""
    db = Database(5, device="cpu", engine=engine)
    mgr = db.manager(kind)
    repo = mgr.repo
    ops = [b"INC"] if kind == "GCOUNT" else [b"INC", b"DEC"]
    sink = Respond(bytearray().extend)
    if batch in ("own", "mixed", "idle"):
        for i in range(40):
            op = ops[i % len(ops)]
            mgr.apply(sink, [kind.encode(), op, b"k%06d" % i,
                             b"0" if batch == "idle" or i % 5 == 0 else b"3"])
    if batch in ("foreign", "mixed"):
        for i in range(20, 70):
            delta = {9: i + 1} if kind == "GCOUNT" else ({9: i + 1}, {} if i % 2 else {9: 1})
            repo.converge(b"k%06d" % i, delta)
    own_rows, _, _ = repo._tbl.export_pending(clear=False)
    want = len(set(own_rows) | set(repo._pending_f[0]) | set(repo._pending_f[1]))
    assert want > 0
    c = db.metrics.counters[kind]
    before = (c["batches"], c["keys"])
    repo.drain()
    assert (c["batches"] - before[0], c["keys"] - before[1]) == (1, want)
    assert span(db, f"drain.{kind}.collect")[::2] == [1, want]
    repo.drain()  # nothing pending but the idle rows the window keeps
    again = 2 if batch == "idle" else 1
    assert c["batches"] - before[0] == again
    assert span(db, f"drain.{kind}.collect")[0] == again  # an empty drain counts none


# the pending count each drain's ``keys`` grew by when timed_drain read it
# before the drain (now each drain returns it)
PENDING = {
    "TREG": lambda repo: repo._tbl.pend_count(),
    "TLOG": lambda repo: repo._tbl.touched_count(),
    "TENSOR": lambda repo: repo._tbl.pend_count(),
    "MAP": lambda repo: len(repo._tbl.pending),
    "BCOUNT": lambda repo: len(repo._pending),
}


def writes(kind: str, i: int) -> list[bytes]:
    """One write of key i of ``kind``."""
    key = b"w%04d" % i
    return {
        "TREG": [b"TREG", b"SET", key, b"v%d" % i, b"%d" % (i + 1)],
        "TLOG": [b"TLOG", b"INS", key, b"v%d" % i, b"%d" % (i + 1)],
        "TENSOR": [b"TENSOR", b"SET", key, b"MAX", b"%d" % (i + 1),
                   bytes([i % 200, 0, 0, 0]) * 2],
        "MAP": [b"MAP", b"TREG", b"SET", key, b"f", b"v%d" % i, b"%d" % (i + 1)],
        "BCOUNT": [b"BCOUNT", b"GRANT", key, b"%d" % (i + 1)],
    }[kind]


@pytest.mark.parametrize("engine", ["python", "auto"])
@pytest.mark.parametrize("kind", sorted(PENDING))
def test_each_drain_counts_its_keys_as_the_pending_read_before_it(engine, kind):
    """The drains of the other types return their key count:
    ``<TYPE> keys`` grows by what their pending count read before the
    drain, for own writes, foreign deltas from another node and both;
    a drain with nothing pending records nothing."""
    src = Database(9, device="cpu", engine="python")
    sink = Respond(bytearray().extend)
    for i in range(30):
        src.manager(kind).apply(sink, writes(kind, i))
    foreign = src.manager(kind).repo.flush_deltas()
    assert foreign
    db = Database(5, device="cpu", engine=engine)
    mgr = db.manager(kind)
    repo = mgr.repo
    c = db.metrics.counters[kind]
    for step in ("own", "foreign", "mixed", "empty"):
        if step in ("own", "mixed"):
            for i in range(20, 45):
                mgr.apply(sink, writes(kind, i))
        if step in ("foreign", "mixed"):
            for key, delta in foreign:
                repo.converge(key, delta)
        want = PENDING[kind](repo)
        if step in ("foreign", "mixed", "empty"):  # own writes may skip the window
            assert (want > 0) == (step != "empty"), step
        before = (c["batches"], c["keys"])
        repo.drain()
        assert (c["batches"] - before[0], c["keys"] - before[1]) == (int(want > 0), want), step


@pytest.mark.parametrize("engine", ["python", "auto"])
def test_a_tlog_trim_with_nothing_pending_counts_one_key(engine):
    db = Database(5, device="cpu", engine=engine)
    mgr = db.manager("TLOG")
    sink = Respond(bytearray().extend)
    for i in range(3):
        mgr.apply(sink, [b"TLOG", b"INS", b"log", b"v%d" % i, b"%d" % (i + 1)])
    mgr.repo.drain()
    c = db.metrics.counters["TLOG"]
    before = (c["batches"], c["keys"])
    assert mgr.repo._tbl.touched_count() == 0
    mgr.apply(sink, [b"TLOG", b"TRIM", b"log", b"1"])
    assert (c["batches"] - before[0], c["keys"] - before[1]) == (1, 1)
    out = bytearray()
    mgr.apply(Respond(out.extend), [b"TLOG", b"SIZE", b"log"])
    assert out == b":1\r\n"
