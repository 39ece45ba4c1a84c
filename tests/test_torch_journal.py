"""The delta journal in the port (jylis_tpu_torch/journal/) against the JAX package.

At tolerance 0, on the CPU, each case on both port engines
(``engine="auto"``, the native tables, and ``engine="python"``):

* The seeded all-type stream of test_torch_persist.py, flushed after each
  round into a journal by a JAX ``Database(engine="python")`` and by port
  Databases: the segments decode to equal batches and are byte-equal. A
  port node whose repos are written again after every append (the
  writer thread encodes later) still journals the bytes JAX journals.
  The JAX segment replays into a port Database, and the port's into a
  JAX Database, with equal ``SYSTEM DIGEST`` / ``SYSTEM DIGEST TYPES``.
* The cases of tests/test_journal.py on the port: round trips, the own
  counter column, snapshot overlap, the SYSTEM keepalive, a torn tail
  (truncated, recovered, appendable), a CRC flip (refused, moved aside),
  a signature mismatch, a legacy segment (replayed and re-stamped),
  empty and missing segments, rotation and its failed-compaction fold,
  the size trigger, the counters, the fsync policies, rotation that
  never blocks appends, failed and concurrent rotations, and Dispose's
  journal close off the loop.
* The failpoints ``journal.append``, ``journal.fsync``,
  ``journal.rotate`` and ``journal.replay``.
* The persistence flags parse to the JAX node's values.
* One SIGKILL drill through ``python -m jylis_tpu_torch --device cpu
  --data-dir D`` with the online snapshot loop and the journal: the
  restarted node serves every write the journal covered.
"""

import asyncio
import copy
import os
import signal
import struct
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from jylis_tpu import journal as jax_journal
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu_torch import faults, persist
from jylis_tpu_torch import journal as journal_mod
from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.cluster.framing import frame
from jylis_tpu_torch.cluster.msg import MsgPushDeltas
from jylis_tpu_torch.journal import Journal, JournalError
from jylis_tpu_torch.journal.journal import HEADER_LEN, read_journal
from jylis_tpu_torch.main import Dispose
from jylis_tpu_torch.models.database import Database
from jylis_tpu_torch.obs.registry import MetricsRegistry

from test_persist import READS
from test_torch_persist import (  # noqa: F401 (jax_python_paths: autouse)
    ENGINES, SYSTEM_LOG, call, digests, jax_python_paths, populate, port_db,
)
from test_torch_system_digest import IDENTITY, feed, mismatch, round_one, round_two

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)

U64 = (1 << 64) - 1
TENSOR_MAX = b"*3\r\n$3\r\nMAX\r\n$8\r\n\x00\x00\x80?\x00\x00\x00\xc0\r\n:0\r\n"


def make_journal(tmp_path, name="journal.jylis", **kw):
    kw.setdefault("fsync", "off")
    j = Journal(str(tmp_path / name), registry=kw.pop("registry", MetricsRegistry()), **kw)
    j.open()
    return j


def flush_all(db, journal) -> None:
    """The serving flush path, driven directly: attach, then flush every
    repo into a discarding sink (manager._emit journals first)."""
    db.set_journal(journal)
    db.flush_deltas(lambda deltas: None)


def segment(path: str):
    msgs, good_end, total = read_journal(path)
    assert good_end == total
    return [(m.name, m.batch) for m in msgs]


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """The stream journaled by JAX and by each port engine, flushed after
    each round. "mut" is a native port node whose writer thread is held
    until every batch is queued, and whose repos meanwhile take local
    writes, foreign deltas and a drain on the journaled keys (the
    journal detached first, so none of that is journaled): the queued
    batches are encoded after it all."""
    d = tmp_path_factory.mktemp("journals")
    rng = np.random.default_rng(8)
    rounds = [round_one(rng), round_two(rng)]
    out = {"paths": {}, "dbs": {}}
    for name in ["jax"] + ENGINES + ["mut"]:
        jax_side = name == "jax"
        path = str(d / f"{name}.jylis")
        if jax_side:
            db = JaxDatabase(identity=IDENTITY, engine="python")
            j = jax_journal.Journal(path, fsync="off")
        else:
            db = Database(IDENTITY, device="cpu", engine="auto" if name == "mut" else name)
            j = Journal(path, fsync="off", registry=db.metrics)
        gate = threading.Event()
        if name == "mut":
            run = j._run
            j._run = lambda: (gate.wait(), run())
        j.open()
        db.set_journal(j)
        writers = {}
        for steps in rounds:
            feed(db, steps, jax_side, bytearray(), writers)
            db.flush_deltas(lambda deltas: None)
        db.set_journal(None)
        if name == "mut":
            assert j._q, "the writer ran before the rewrites"
            for args in (("GCOUNT", "INC", "k1", 5), ("PNCOUNT", "DEC", "k1", 5),
                         ("TREG", "SET", "k1", "later", 1 << 62),
                         ("TLOG", "INS", "k1", "later", 1 << 62), ("TLOG", "TRIM", "k2", 0),
                         ("TENSOR", "SET", "tm", "MAX", 0, b"\x00\x00\x80\x7f\x00\x00\x80\x7f"),
                         ("UJSON", "SET", "u1", "a", '"later"'), ("UJSON", "CLR", "u3"),
                         ("MAP", "TREG", "DEL", "m0", "TR1"), ("BCOUNT", "GRANT", "b1", 3)):
                call(db, *args)
            db.converge("GCOUNT", [(b"k%d" % i, {7: U64}) for i in range(30)])
            db.converge("TREG", [(b"k%d" % i, (b"zz", U64)) for i in range(30)])
            db.converge("TLOG", [(b"k%d" % i, ([(b"zz", U64)], 5)) for i in range(30)])
            db.drain_all()
            gate.set()
        j.close()
        out["paths"][name] = path
        out["dbs"][name] = db
    return out


@pytest.mark.parametrize("engine", ENGINES + ["mut"])
def test_journal_of_the_stream_equals_jax(journals, engine):
    """Equal batches in equal order, and equal bytes; the rewrites after
    each append never reach the flushed batches."""
    want = [(m.name, m.batch) for m in jax_journal.journal.read_journal(
        journals["paths"]["jax"])[0]]
    got = segment(journals["paths"][engine])
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) >= 12
    for (name, a), (_, b) in zip(got, want):
        assert codec.encode(MsgPushDeltas(name, a)) == codec.encode(MsgPushDeltas(name, b)), name
    blob = open(journals["paths"][engine], "rb").read()
    assert blob == open(journals["paths"]["jax"], "rb").read()
    if engine == "mut":
        assert journals["dbs"]["mut"].metrics.journal_counters["appends"] == len(want)


@pytest.mark.parametrize("engine", ENGINES)
def test_jax_journal_replays_into_port(journals, engine):
    """A JAX segment replays into a port node and the port's into a JAX
    node: digests equal the JAX node's that wrote it, on both sides."""
    jdb = journals["dbs"]["jax"]
    db = port_db(engine, identity=IDENTITY)
    assert journal_mod.recover(db, journals["paths"]["jax"]) >= 12
    jback = JaxDatabase(identity=IDENTITY, engine="python")
    jax_journal.recover(jback, journals["paths"][engine])
    assert digests(db, False) == digests(jback, True), mismatch(jback, db)
    assert db.metrics.journal_counters["replayed_batches"] >= 12
    # the journal holds this node's own writes only; converged foreign
    # deltas are not journaled, so the digests differ from the writer's
    assert digests(db, False) != digests(jdb, True)


@pytest.mark.parametrize("engine", ENGINES)
def test_roundtrip_all_types(tmp_path, engine):
    db = port_db(engine)
    populate(db)
    db.converge("SYSTEM", copy.deepcopy(SYSTEM_LOG))
    j = make_journal(tmp_path)
    flush_all(db, j)
    j.close()
    db2 = port_db(engine)
    assert journal_mod.recover(db2, j.path) > 0
    for req, want in READS.items():
        assert call(db2, *req) == want, req
    assert b"a log line" in call(db2, "SYSTEM", "GETLOG")


@pytest.mark.parametrize("engine", ENGINES)
def test_own_counter_state_survives_replay(tmp_path, engine):
    db = port_db(engine)
    call(db, "GCOUNT", "INC", "g", "7")
    call(db, "PNCOUNT", "INC", "p", "5")
    call(db, "GCOUNT", "INC", "top", (1 << 64) - 1)
    j = make_journal(tmp_path)
    flush_all(db, j)
    j.close()
    db2 = port_db(engine)
    journal_mod.recover(db2, j.path)
    call(db2, "GCOUNT", "INC", "g", "3")
    assert call(db2, "GCOUNT", "GET", "g") == b":10\r\n"
    call(db2, "PNCOUNT", "DEC", "p", "1")
    assert call(db2, "PNCOUNT", "GET", "p") == b":4\r\n"
    call(db2, "GCOUNT", "INC", "top", 2)
    assert call(db2, "GCOUNT", "GET", "top") == b":1\r\n"  # u64 wrap, as JAX


@pytest.mark.parametrize("engine", ENGINES)
def test_journal_joins_with_snapshot_overlap(tmp_path, engine):
    db = port_db(engine)
    call(db, "GCOUNT", "INC", "g", "7")
    j = make_journal(tmp_path)
    flush_all(db, j)
    snap = str(tmp_path / "snap.jylis")
    persist.save_snapshot(db, snap)
    call(db, "GCOUNT", "INC", "g", "2")
    db.flush_deltas(lambda deltas: None)
    j.close()
    db2 = port_db(engine)
    persist.load_snapshot(db2, snap)
    journal_mod.recover(db2, j.path)
    assert call(db2, "GCOUNT", "GET", "g") == b":9\r\n"


def test_system_keepalive_not_journaled(tmp_path):
    j = make_journal(tmp_path)
    before = j.size()
    j.append("SYSTEM", [(b"_log", ([], 0))])
    j.append("GCOUNT", [])
    j.flush()
    assert j.size() == before
    j.append("SYSTEM", [(b"_log", ([(b"line", 3)], 0))])
    j.flush()
    assert j.size() > before
    j.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_torn_trailing_frame_truncated_and_recovered(tmp_path, engine):
    db = port_db(engine)
    call(db, "GCOUNT", "INC", "g", "7")
    call(db, "TREG", "SET", "r", "hello", "9")
    j = make_journal(tmp_path)
    flush_all(db, j)
    j.close()
    whole = os.path.getsize(j.path)
    with open(j.path, "ab") as f:
        f.write(b"\x06" + (900).to_bytes(8, "big") + b"partial body")
    db2 = port_db(engine)
    n = journal_mod.recover(db2, j.path)
    assert n > 0 and os.path.getsize(j.path) == whole
    assert not os.path.exists(j.path + ".unreadable")
    assert call(db2, "GCOUNT", "GET", "g") == b":7\r\n"
    assert call(db2, "TREG", "GET", "r") == b"*2\r\n$5\r\nhello\r\n:9\r\n"
    j2 = Journal(j.path, fsync="off", registry=MetricsRegistry())
    j2.open()
    j2.append("GCOUNT", [(b"g", {1: 8})])
    j2.close()
    db3 = port_db(engine)
    assert journal_mod.recover(db3, j.path) == n + 1
    assert call(db3, "GCOUNT", "GET", "g") == b":8\r\n"


@pytest.mark.parametrize("engine", ENGINES)
def test_mid_file_bitflip_refused_and_moved_aside(tmp_path, engine):
    db = port_db(engine)
    populate(db)
    j = make_journal(tmp_path)
    flush_all(db, j)
    j.close()
    blob = bytearray(open(j.path, "rb").read())
    blob[HEADER_LEN + 9 + 6] ^= 0x40
    open(j.path, "wb").write(bytes(blob))
    db2 = port_db(engine)
    with pytest.raises(JournalError, match="CRC"):
        journal_mod.replay_journal(db2, j.path)
    assert call(db2, "GCOUNT", "GET", "g") == b":0\r\n"
    assert journal_mod.recover(db2, j.path) == 0
    assert not os.path.exists(j.path) and os.path.exists(j.path + ".unreadable")


def test_schema_signature_mismatch_moved_aside(tmp_path):
    path = str(tmp_path / "journal.jylis")
    open(path, "wb").write(journal_mod.MAGIC + b"\x00" * 32)
    db = port_db("python")
    with pytest.raises(JournalError, match="signature"):
        journal_mod.replay_journal(db, path)
    assert journal_mod.recover(db, path) == 0
    assert os.path.exists(path + ".unreadable")
    bad = str(tmp_path / "bad")
    open(bad, "wb").write(b"definitely not a journal")
    with pytest.raises(JournalError, match="not a journal"):
        journal_mod.replay_journal(db, bad)


@pytest.mark.parametrize("engine", ENGINES)
def test_legacy_delta_signature_replays_and_restamps(tmp_path, engine):
    path = str(tmp_path / "journal.jylis")
    payload = codec.encode(MsgPushDeltas("GCOUNT", ((b"leg", {1: 5}),)))
    with open(path, "wb") as f:
        f.write(journal_mod.MAGIC + codec.legacy_delta_signatures()[0])
        f.write(frame(struct.pack(">I", zlib.crc32(payload)) + payload))
    db = port_db(engine)
    assert journal_mod.replay_journal(db, path) == 1
    assert call(db, "GCOUNT", "GET", "leg") == b":5\r\n"
    assert open(path, "rb").read(HEADER_LEN)[len(journal_mod.MAGIC):] == codec.delta_signature()
    j = Journal(path, fsync="always", registry=MetricsRegistry())
    j.open()
    db2 = port_db(engine)
    call(db2, "TENSOR", "SET", "t", "MAX", "0", b"\x00\x00\x80?\x00\x00\x00\xc0")
    flush_all(db2, j)
    j.close()
    db3 = port_db(engine, identity=2)
    assert journal_mod.replay_journal(db3, path) == 2
    assert call(db3, "GCOUNT", "GET", "leg") == b":5\r\n"
    assert call(db3, "TENSOR", "GET", "t") == TENSOR_MAX


def test_empty_and_missing_journal(tmp_path):
    db = port_db("python")
    path = str(tmp_path / "journal.jylis")
    assert journal_mod.recover(db, path) == 0
    open(path, "wb").close()
    assert journal_mod.recover(db, path) == 0
    j = Journal(path, fsync="off", registry=MetricsRegistry())
    j.open()
    j.close()
    assert journal_mod.recover(db, path) == 0
    assert not os.path.exists(path + ".unreadable")


@pytest.mark.parametrize("engine", ENGINES)
def test_rotation_retires_and_failed_compaction_folds(tmp_path, engine):
    j = make_journal(tmp_path)
    j.append("GCOUNT", [(b"a", {1: 1})])
    j.rotate_begin()
    assert os.path.exists(j.retiring_path())
    j.append("GCOUNT", [(b"b", {1: 2})])
    j.rotate_begin()  # the snapshot "failed": batch 2 folds into .retiring
    j.append("GCOUNT", [(b"c", {1: 3})])
    j.close()
    db = port_db(engine)
    assert journal_mod.recover(db, j.path) == 3
    for key, want in ((b"a", b":1\r\n"), (b"b", b":2\r\n"), (b"c", b":3\r\n")):
        assert call(db, "GCOUNT", "GET", key) == want
    j2 = Journal(j.path, fsync="off", registry=MetricsRegistry())
    j2.open()
    j2.rotate_commit()
    assert not os.path.exists(j.retiring_path())
    j2.close()


def test_size_trigger_notifies_once_per_segment_and_after_late_install(tmp_path):
    calls = []
    j = make_journal(tmp_path, "j.jylis", max_bytes=1)
    j.append("GCOUNT", [(b"a", {1: 1})])  # no hook yet: not latched away
    j.flush()
    assert j.needs_rotation()
    j.rotate_notify = lambda: calls.append(1)
    j.append("GCOUNT", [(b"b", {1: 2})])
    j.append("GCOUNT", [(b"c", {1: 2})])
    j.flush()
    assert len(calls) == 1
    j.rotate_begin()
    j.append("GCOUNT", [(b"d", {1: 3})])
    j.flush()
    assert len(calls) == 2
    j.rotate_commit()
    j.close()


def test_metrics_counters_and_lines(tmp_path):
    from jylis_tpu_torch.utils import metrics

    reg = MetricsRegistry()
    j = make_journal(tmp_path, registry=reg)
    j.append("GCOUNT", [(b"k", {1: 5})])
    j.close()
    assert reg.journal_counters["appends"] == 1 and reg.journal_counters["bytes"] > 0
    reg.journal_enabled = True
    assert any(line.startswith("JOURNAL appends 1") for line in metrics.metric_lines(registry=reg))
    db = port_db("python")
    assert journal_mod.recover(db, j.path) == 1
    assert db.metrics.journal_counters["replayed_batches"] == 1
    db.set_journal(j)
    assert any(ln.startswith(b"JOURNAL appends") for ln in
               call(db, "SYSTEM", "METRICS").split(b"\r\n"))


def test_fsync_policies_count(tmp_path):
    t = [0.0]
    reg = MetricsRegistry()
    j = make_journal(tmp_path, "j.jylis", fsync="always", clock=lambda: t[0], registry=reg)
    j.append("GCOUNT", [(b"a", {1: 1})])
    j.append("GCOUNT", [(b"b", {1: 2})])
    j.close()
    assert reg.journal_counters["fsyncs"] >= 2
    reg = MetricsRegistry()
    j = make_journal(tmp_path, "j2.jylis", fsync="interval", fsync_interval=10.0,
                     clock=lambda: t[0], registry=reg)
    j.append("GCOUNT", [(b"a", {1: 1})])
    t[0] += 11.0
    j.append("GCOUNT", [(b"b", {1: 2})])
    j.close()
    assert reg.journal_counters["fsyncs"] == 1
    reg = MetricsRegistry()
    j = make_journal(tmp_path, "j3.jylis", fsync="interval", fsync_interval=0.05, registry=reg)
    j.append("GCOUNT", [(b"a", {1: 1})])
    j.flush()
    deadline = time.time() + 10
    while reg.journal_counters["fsyncs"] == 0 and time.time() < deadline:
        time.sleep(0.02)
    assert reg.journal_counters["fsyncs"] > 0, "idle tail never fsynced"
    j.close()
    with pytest.raises(ValueError):
        Journal(str(tmp_path / "x"), fsync="sometimes")


def test_rotation_never_blocks_appends(tmp_path, monkeypatch):
    j = make_journal(tmp_path, "j.jylis", fsync="always")
    j.append("GCOUNT", [(b"before", {1: 1})])
    j.flush()
    real_fsync, slow = os.fsync, threading.Event()

    def slow_fsync(fd):
        slow.set()
        time.sleep(0.5)
        real_fsync(fd)

    monkeypatch.setattr(os, "fsync", slow_fsync)
    rot = threading.Thread(target=j.rotate_begin)
    rot.start()
    assert slow.wait(10)
    t0 = time.monotonic()
    j.append("GCOUNT", [(b"during", {1: 2})])
    append_s = time.monotonic() - t0
    rot.join(timeout=30)
    monkeypatch.setattr(os, "fsync", real_fsync)
    assert not rot.is_alive() and append_s < 0.2, append_s
    j.flush()
    j.close()
    assert [b[0][0] for _, b in segment(j.path)] == [b"during"]
    assert [b[0][0] for _, b in segment(j.retiring_path())] == [b"before"]


def test_failed_rotations_resume_and_retry(tmp_path, monkeypatch):
    """A rotation that dies before its rename re-asks when the writer
    drops an undurable batch; one that dies after it re-opens on retry;
    two at once serialise."""
    asks = []
    j = make_journal(tmp_path)
    j.rotate_notify = lambda: asks.append(1)
    j.append("GCOUNT", [(b"a", {1: 1})])
    j.flush()
    real_replace = os.replace
    monkeypatch.setattr(os, "replace", lambda src, dst: (_ for _ in ()).throw(OSError("gone")))
    j.rotate_begin()
    assert isinstance(j.last_error, OSError)
    j.append("GCOUNT", [(b"dropped", {1: 2})])
    j.flush()
    assert asks
    monkeypatch.setattr(os, "replace", real_replace)
    j.rotate_begin()
    j.append("GCOUNT", [(b"recovered", {1: 3})])
    j.flush()
    j.close()
    assert [b[0][0] for _, b in segment(j.path)] == [b"recovered"]

    j = make_journal(tmp_path, "k.jylis")
    j.append("GCOUNT", [(b"a", {1: 1})])
    j.flush()
    real_open_fresh = Journal._open_fresh_file
    monkeypatch.setattr(Journal, "_open_fresh_file",
                        lambda self: (_ for _ in ()).throw(OSError("EMFILE")))
    j.last_error = None
    j.rotate_begin()
    assert isinstance(j.last_error, OSError) and not os.path.exists(j.path)
    monkeypatch.setattr(Journal, "_open_fresh_file", real_open_fresh)
    j.rotate_begin()
    j.last_error = None
    threads = [threading.Thread(target=j.rotate_begin) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and j.last_error is None
    j.append("GCOUNT", [(b"b", {1: 2})])
    j.flush()
    j.close()
    assert [b[0][0] for _, b in segment(j.path)] == [b"b"]
    assert [b[0][0] for _, b in segment(j.retiring_path())] == [b"a"]


@pytest.mark.parametrize("engine", ENGINES)
def test_journal_failpoints(tmp_path, engine):
    """journal.append: error counts an error and keeps the writer, drop
    loses that batch, corrupt makes boot replay refuse the segment;
    journal.fsync: error counts and skips the sync; journal.rotate:
    error leaves the writer running on no segment until a retry;
    journal.replay: error moves the segment aside."""
    reg = MetricsRegistry()
    try:
        j = make_journal(tmp_path, registry=reg, fsync="always")
        # each failpoint armed while the writer is idle (flush between)
        for point, action, key in (("journal.append", "error", b"e"),
                                   ("journal.append", "drop", b"d"),
                                   (None, None, b"kept"),
                                   ("journal.fsync", "error", b"unsynced")):
            if point:
                faults.arm(point, action, budget=1)
            j.append("GCOUNT", [(key, {1: 1})])
            j.flush()
        assert reg.journal_counters["errors"] == 2 and reg.journal_counters["appends"] == 2
        faults.arm("journal.rotate", "error", budget=1)
        j.rotate_begin()
        assert isinstance(j.last_error, faults.FaultError) and os.path.exists(j.path)
        j.rotate_begin()
        j.rotate_commit()
        faults.arm("journal.append", "corrupt", budget=1)
        j.append("GCOUNT", [(b"c", {1: 1})])
        j.close()
        db = port_db(engine)
        assert journal_mod.recover(db, j.path) == 0
        assert os.path.exists(j.path + ".unreadable")
        j = make_journal(tmp_path, "r.jylis")
        j.append("GCOUNT", [(b"k", {1: 4})])
        j.close()
        # recover replays the .retiring sibling first: the point fires
        # for it (absent) and for the segment
        faults.arm("journal.replay", "error", budget=2)
        db = port_db(engine)
        assert journal_mod.recover(db, j.path) == 0
        assert os.path.exists(j.path + ".unreadable")
        assert all(faults.hits(p) for p in ("journal.append", "journal.fsync",
                                            "journal.rotate", "journal.replay"))
    finally:
        faults.reset()


def test_dispose_closes_journal_off_the_loop_and_survives_failure():
    """Dispose closes the journal in a worker thread; a close that raises
    (a full disk) still stops the cluster and the server and sets done."""
    closed_on, disposed = [], []

    class _Journal:
        def __init__(self, fail):
            self.fail = fail

        def close(self):
            closed_on.append(threading.current_thread())
            if self.fail:
                raise OSError("disk full")

    class _Server:
        async def dispose(self):
            disposed.append("server")

    class _Cluster:
        def dispose(self):
            disposed.append("cluster")

    class _Db:
        async def clean_shutdown_async(self):
            pass

    async def drive(fail):
        d = Dispose(_Db(), _Server(), _Cluster(), journal=_Journal(fail))
        await d._shutdown()
        return threading.current_thread(), d.done.is_set()

    for fail in (False, True):
        loop_thread, done = asyncio.run(drive(fail))
        assert done and closed_on[-1] is not loop_thread
    assert disposed == ["cluster", "server"] * 2


# the drill's first stage outgrows this and compacts (a snapshot from the
# loop); its second stage stays in the fresh segment
DRILL_MAX_BYTES = 400


def _spawn(port, cport, data_dir):
    root = str(Path(__file__).resolve().parents[1])
    return subprocess.Popen(
        [sys.executable, "-m", "jylis_tpu_torch", "--port", str(port),
         "--addr", f"127.0.0.1:{cport}:drill", "--heartbeat-time", "0.2",
         "--device", "cpu", "--log-level", "error", "--data-dir", data_dir,
         "--snapshot-interval", "0", "--journal-max-bytes", str(DRILL_MAX_BYTES),
         "--journal-fsync-interval", "0.05"],
        env=dict(os.environ, PYTHONPATH=root), cwd=root,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _journal_appends(client) -> int:
    return sum(int(ln.rsplit(b" ", 1)[1]) for ln in client.execute_command("SYSTEM", "METRICS")
               if ln.startswith(b"JOURNAL appends"))


def test_sigkill_drill_restarts_from_snapshot_and_journal(tmp_path):
    """A port node with the snapshot loop and the journal takes writes of
    every type; they outgrow --journal-max-bytes, so the loop cuts a
    snapshot and retires the segment. More writes follow and reach the
    journal (its appends counter stable across two polls), then the node
    is SIGKILLed. The restarted node replays the journal after the
    snapshot, serves every write, and on SIGTERM writes its shutdown
    snapshot and retires the journal."""
    from procutil import connect_client, free_port

    data = str(tmp_path / "data")
    port, cport = free_port(), free_port()
    first = [("GCOUNT", "INC", "g", 41), ("PNCOUNT", "DEC", "p", 3),
             ("TREG", "SET", "r", "v", 5), ("TLOG", "INS", "l", "a", 7),
             ("UJSON", "SET", "u", "k", '"x"'),
             ("TENSOR", "SET", "t", "MAX", 0, b"\x00\x00\x80?\x00\x00\x00\xc0"),
             ("MAP", "GCOUNT", "SET", "m", "f", 6), ("BCOUNT", "GRANT", "b", 9)]
    first += [("GCOUNT", "INC", "x%d" % i, i + 1) for i in range(30)]
    second = [("GCOUNT", "INC", "g", 1), ("TLOG", "INS", "l", "b", 8),
              ("UJSON", "INS", "u", "tags", 2), ("TREG", "SET", "r2", "w", 6)]
    reads = [("GCOUNT", "GET", "g"), ("PNCOUNT", "GET", "p"), ("TREG", "GET", "r"),
             ("TREG", "GET", "r2"), ("TLOG", "GET", "l"), ("UJSON", "GET", "u"),
             ("TENSOR", "GET", "t"), ("MAP", "GCOUNT", "GET", "m", "f"), ("BCOUNT", "GET", "b")]
    snap = os.path.join(data, "snapshot.jylis")
    jpath = os.path.join(data, "journal.jylis")
    proc = _spawn(port, cport, data)
    try:
        c = connect_client(port, proc=proc)
        for cmd in first:
            c.execute_command(*cmd)
        deadline = time.monotonic() + 60
        while (not os.path.exists(snap) or os.path.exists(jpath + ".retiring")) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert os.path.exists(snap), "no snapshot from the compaction"
        for cmd in second:
            c.execute_command(*cmd)
        last, stable = -1, 0
        while stable < 2 and time.monotonic() < deadline:
            n = _journal_appends(c)
            stable = stable + 1 if n == last and n >= 4 else 0
            last = n
            time.sleep(0.3)
        assert stable == 2, f"journal appends never settled ({last})"
        before = [c.execute_command(*cmd) for cmd in reads]
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        proc.stderr.close()
    assert DRILL_MAX_BYTES > os.path.getsize(jpath) > HEADER_LEN
    assert before[0] == 42 and before[3] == [b"w", 6]
    proc = _spawn(port, cport, data)
    try:
        c = connect_client(port, proc=proc)
        assert [c.execute_command(*cmd) for cmd in reads] == before
        assert any(ln.startswith(b"JOURNAL replayed_batches") and not ln.endswith(b" 0")
                   for ln in c.execute_command("SYSTEM", "METRICS"))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
    assert not os.path.exists(os.path.join(data, "journal.jylis.retiring"))
    assert os.path.getsize(os.path.join(data, "journal.jylis")) == HEADER_LEN
    db = port_db("python", identity=0)
    assert persist.load_snapshot(db, snap) == 9
    assert call(db, "GCOUNT", "GET", "g") == b":42\r\n"


PERSIST_FLAGS = ("data_dir", "snapshot_interval", "journal", "journal_fsync",
                 "journal_fsync_interval", "journal_max_bytes")


@pytest.mark.parametrize("argv", [
    [],
    ["--data-dir", "/tmp/d", "--snapshot-interval", "30", "--no-journal",
     "--journal-fsync", "always", "--journal-fsync-interval", "0.5",
     "--journal-max-bytes", "4096"],
    ["--data-dir", "/tmp/d", "--journal-fsync", "off"],
], ids=["defaults", "set", "journal-on"])
def test_persistence_flags_match_jax(argv):
    """The persistence flags parse to the JAX node's values, defaults
    included; --snapshot-interval without --data-dir is refused by both."""
    from jylis_tpu.utils.config import config_from_cli as jax_config_from_cli
    from jylis_tpu_torch.utils.config import config_from_cli

    ours, theirs = config_from_cli(argv), jax_config_from_cli(argv)
    assert [getattr(ours, f) for f in PERSIST_FLAGS] == [getattr(theirs, f) for f in PERSIST_FLAGS]
    for parse in (config_from_cli, jax_config_from_cli):
        with pytest.raises(SystemExit):
            parse(["--snapshot-interval", "5"])
