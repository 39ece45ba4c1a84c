"""Snapshots in the port (jylis_tpu_torch/persist.py) against the JAX package.

At tolerance 0, on the CPU, each case on both port engines
(``engine="auto"``, the native tables, and ``engine="python"``):

* One seeded stream over all eight data types and SYSTEM (the stream of
  test_torch_system_digest.py: counters >= 2^63, TLOG trims, a resident
  UJSON key and pending fan-ins, TENSOR in three modes, MAP tombstones,
  BCOUNT escrow) goes into a JAX ``Database(engine="python")`` and into
  port Databases. Their snapshot files are byte-equal, frame by frame.
  The JAX file restores into a port Database with equal ``dump_state``
  bytes per type and equal ``SYSTEM DIGEST`` / ``SYSTEM DIGEST TYPES``
  replies; the port's file restores into a JAX Database with equal
  digests. The JAX Database and the files are built once for the module.
* The cases of tests/test_persist.py on the port: every type round
  trips, the own counter column keeps counting after a restore (equal
  to JAX, own values 2^63 and 2^64-1 among them), a stale snapshot joins
  live state, another identity keeps the writer's columns, corrupt,
  mismatched and truncated files are refused, a frame-boundary cut is
  refused under the current and a legacy header, every legacy header
  loads, and the online path's async dump writes a loadable file.
* The failpoints ``snapshot.write`` and ``snapshot.load``.
* A restored UJSON document of SEG_FANIN_MIN entries or more goes back
  to a resident row; a smaller one stays on the host.
* The JAX file restores into a port Database on a 4-part CPU keyspace
  (``make_mesh(4, devices=["cpu"] * 4)``) with the same dumps and
  digests.
"""

import asyncio
import copy
import os

import numpy as np
import pytest
import torch

from jylis_tpu import persist as jax_persist
from jylis_tpu.cluster import codec as jax_codec
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.server.resp import Respond as JaxRespond
from jylis_tpu_torch import faults, persist
from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.cluster.framing import HEADER_SIZE, FrameReader, frame, parse_header
from jylis_tpu_torch.models import repo_ujson
from jylis_tpu_torch.models.database import Database
from jylis_tpu_torch.server.resp import Respond

from test_persist import READS
from test_torch_system_digest import (
    DIGEST, DIGEST_TYPES, IDENTITY, ask, feed, mismatch, round_one, round_two,
)

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)

ENGINES = ["auto", "python"]
U64 = (1 << 64) - 1
# a SYSTEM log delta with fixed timestamps (inslog stamps the wall clock)
SYSTEM_LOG = [(b"_log", ([(b"b", 9), (b"a", 9), (b"c", 1)], 2))]


@pytest.fixture(scope="module", autouse=True)
def jax_python_paths():
    """The JAX side takes its Python paths (the codec's oracle, the
    resident store's Python grid encode), so these modules build no JAX
    native library: the JAX package builds its library unlocked, and
    parallel first builds race (ROADMAP C3). JAX's own tests hold its
    native paths equal to these."""
    import jylis_tpu.native as jax_native
    from jylis_tpu.native import codec as jax_native_codec

    patch = pytest.MonkeyPatch()
    for mod in (jax_native, jax_native_codec):
        patch.setattr(mod, "lib", lambda: None)
    yield
    patch.undo()


def port_db(engine: str, identity: int = 1) -> Database:
    return Database(identity, device="cpu", engine=engine)


def call(db, *args) -> bytes:
    out = bytearray()
    db.apply(Respond(out.extend), [a if isinstance(a, bytes) else str(a).encode()
                                   for a in args])
    return bytes(out)


def jax_call(db, *args) -> bytes:
    out = bytearray()
    db.apply(JaxRespond(out.extend), [a if isinstance(a, bytes) else str(a).encode()
                                      for a in args])
    return bytes(out)


def populate(db, caller=call) -> None:
    """tests/test_persist.py's populate, through either package."""
    for args in (
        ("GCOUNT", "INC", "g", "7"), ("PNCOUNT", "INC", "p", "40"),
        ("PNCOUNT", "DEC", "p", "2"), ("TREG", "SET", "r", "hello", "9"),
        ("TLOG", "INS", "l", "a", "3"), ("TLOG", "INS", "l", "b", "5"),
        ("TLOG", "TRIMAT", "l", "4"), ("UJSON", "SET", "u", "name", '"alice"'),
        ("UJSON", "RM", "u", "name", '"alice"'), ("UJSON", "INS", "u", "tag", "1"),
        ("TENSOR", "SET", "t", "MAX", "0", b"\x00\x00\x80?\x00\x00\x00\xc0"),
        ("MAP", "TREG", "SET", "m", "fr", "val", "11"), ("MAP", "GCOUNT", "SET", "m", "fg", "6"),
        ("MAP", "TLOG", "SET", "m", "fl", "entry", "2"),
        ("MAP", "TREG", "SET", "m", "dead", "x", "1"), ("MAP", "TREG", "DEL", "m", "dead"),
        ("BCOUNT", "GRANT", "b", "50"), ("BCOUNT", "INC", "b", "20"), ("BCOUNT", "DEC", "b", "5"),
    ):
        caller(db, *args)
    db.system.inslog("a log line")


def frames_of(blob: bytes, header_len: int) -> list[bytes]:
    reader = FrameReader(max_frame=1 << 62)
    reader.append(blob[header_len:])
    return list(reader)


def encoded_dumps(db, cod) -> dict[str, bytes]:
    """Each type's dump_state as one encoded PushDeltas body."""
    from jylis_tpu.cluster.msg import MsgPushDeltas as JaxMsg
    from jylis_tpu_torch.cluster.msg import MsgPushDeltas

    msg = JaxMsg if cod is jax_codec else MsgPushDeltas
    return {m.name: cod.encode(msg(m.name, tuple(m.repo.dump_state())))
            for m in db.managers()}


def digests(db, jax_side: bool) -> tuple[bytes, bytes]:
    return ask(db, DIGEST, jax_side, False), ask(db, DIGEST_TYPES, jax_side, False)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """The stream fed to one JAX Database and one port Database per
    engine, each one's snapshot file, and their digests."""
    d = tmp_path_factory.mktemp("snapshots")
    rng = np.random.default_rng(8)
    rounds = [round_one(rng), round_two(rng)]
    dbs = {"jax": JaxDatabase(identity=IDENTITY, engine="python")}
    dbs.update({e: Database(IDENTITY, device="cpu", engine=e) for e in ENGINES})
    out = {"dbs": dbs, "files": {}, "digests": {}}
    for name, db in dbs.items():
        writers = {}
        for steps in rounds:
            feed(db, steps, name == "jax", bytearray(), writers)
        if name == "jax":
            db.converge_deltas(("SYSTEM", copy.deepcopy(SYSTEM_LOG)))
        else:
            db.converge("SYSTEM", copy.deepcopy(SYSTEM_LOG))
        path = str(d / f"{name}.jylis")
        (jax_persist if name == "jax" else persist).save_snapshot(db, path)
        out["files"][name] = path
        out["digests"][name] = digests(db, name == "jax")
    # TLOG entries of equal ts dump in arrival order, which a restore
    # changes in JAX too: dumps compare with a JAX restore of the file
    out["jax_restored"] = JaxDatabase(identity=IDENTITY, engine="python")
    jax_persist.load_snapshot(out["jax_restored"], out["files"]["jax"])
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_snapshot_bytes_equal_jax(stream, engine):
    """Both packages' files of the same stream are byte-equal: every
    type's dump order is deterministic in both."""
    jblob = open(stream["files"]["jax"], "rb").read()
    tblob = open(stream["files"][engine], "rb").read()
    hdr = len(persist.MAGIC) + 32
    assert tblob[:hdr] == jblob[:hdr] == jax_persist.MAGIC + jax_codec.delta_signature()
    jf, tf = frames_of(jblob, hdr), frames_of(tblob, hdr)
    assert [codec.decode(b).name for b in tf] == [m.name for m in stream["dbs"][engine].managers()]
    for jb, tb in zip(jf, tf):
        assert tb == jb, codec.decode(tb).name
    assert tblob == jblob and len(jblob) > 4000
    assert stream["digests"][engine] == stream["digests"]["jax"]


@pytest.mark.parametrize("engine", ENGINES)
def test_jax_snapshot_restores_in_port(stream, engine):
    """A JAX node's file loads into a port Database: equal SYSTEM DIGEST
    [TYPES] and dump_state bytes per type equal to a JAX Database's
    restore of the same file."""
    jdb = stream["dbs"]["jax"]
    db = Database(IDENTITY, device="cpu", engine=engine)
    assert persist.load_snapshot(db, stream["files"]["jax"]) == 9
    assert digests(db, False) == stream["digests"]["jax"], mismatch(jdb, db)
    assert encoded_dumps(db, codec) == encoded_dumps(stream["jax_restored"], jax_codec)
    assert b"b" in call(db, "SYSTEM", "GETLOG")


@pytest.mark.parametrize("engine", ENGINES)
def test_port_snapshot_restores_in_jax(stream, engine):
    jdb = JaxDatabase(identity=IDENTITY, engine="python")
    assert jax_persist.load_snapshot(jdb, stream["files"][engine]) == 9
    assert digests(jdb, True) == stream["digests"][engine]


@pytest.mark.parametrize("engine", ENGINES)
def test_roundtrip_all_types(tmp_path, engine):
    db = port_db(engine)
    populate(db)
    path = str(tmp_path / "snap.jylis")
    persist.save_snapshot(db, path)
    db2 = port_db(engine)
    assert persist.load_snapshot(db2, path) == 9
    for req, want in READS.items():
        assert call(db2, *req) == want, req
    assert b"a log line" in call(db2, "SYSTEM", "GETLOG")


@pytest.mark.parametrize("engine", ENGINES)
def test_own_counter_state_survives(tmp_path, engine):
    """INCs after a restore still advance the node's own column, as on a
    JAX node restoring the same file; own values 2^63 and 2^64-1 round
    trip and wrap as JAX's do."""
    db = port_db(engine)
    for args in (("GCOUNT", "INC", "g", 7), ("PNCOUNT", "INC", "p", 5),
                 ("GCOUNT", "INC", "big", 1 << 63), ("PNCOUNT", "DEC", "big", U64),
                 ("GCOUNT", "INC", "top", U64)):
        call(db, *args)
    path = str(tmp_path / "snap.jylis")
    persist.save_snapshot(db, path)
    jdb = JaxDatabase(identity=1, engine="python")
    for args in (("GCOUNT", "INC", "g", 7), ("PNCOUNT", "INC", "p", 5),
                 ("GCOUNT", "INC", "big", 1 << 63), ("PNCOUNT", "DEC", "big", U64),
                 ("GCOUNT", "INC", "top", U64)):
        jax_call(jdb, *args)
    jpath = str(tmp_path / "jax.jylis")
    jax_persist.save_snapshot(jdb, jpath)
    assert open(path, "rb").read() == open(jpath, "rb").read()

    db2, jdb2 = port_db(engine), JaxDatabase(identity=1, engine="python")
    persist.load_snapshot(db2, path)
    jax_persist.load_snapshot(jdb2, jpath)
    after = (("GCOUNT", "INC", "g", 3), ("GCOUNT", "GET", "g"), ("PNCOUNT", "DEC", "p", 1),
             ("PNCOUNT", "GET", "p"), ("GCOUNT", "INC", "big", 1 << 63), ("GCOUNT", "GET", "big"),
             ("PNCOUNT", "INC", "big", 2), ("PNCOUNT", "GET", "big"),
             ("GCOUNT", "INC", "top", 1), ("GCOUNT", "GET", "top"))
    got = [call(db2, *a) for a in after]
    assert got == [jax_call(jdb2, *a) for a in after]
    assert got[1] == b":10\r\n" and got[3] == b":4\r\n"
    assert digests(db2, False) == digests(jdb2, True)


@pytest.mark.parametrize("engine", ENGINES)
def test_stale_snapshot_joins_with_live_state(tmp_path, engine):
    db = port_db(engine)
    call(db, "TREG", "SET", "r", "old", "5")
    path = str(tmp_path / "snap.jylis")
    persist.save_snapshot(db, path)
    call(db, "TREG", "SET", "r", "new", "8")
    persist.load_snapshot(db, path)
    assert call(db, "TREG", "GET", "r") == b"*2\r\n$3\r\nnew\r\n:8\r\n"


@pytest.mark.parametrize("engine", ENGINES)
def test_restore_under_other_identity(tmp_path, engine):
    db = port_db(engine)
    call(db, "GCOUNT", "INC", "g", "7")
    path = str(tmp_path / "snap.jylis")
    persist.save_snapshot(db, path)
    db2 = port_db(engine, identity=2)
    persist.load_snapshot(db2, path)
    call(db2, "GCOUNT", "INC", "g", "1")
    assert call(db2, "GCOUNT", "GET", "g") == b":8\r\n"


@pytest.mark.parametrize("engine", ENGINES)
def test_corrupt_and_mismatched_files(tmp_path, engine):
    db = port_db(engine)
    bad = tmp_path / "bad"
    bad.write_bytes(b"not a snapshot at all")
    with pytest.raises(persist.SnapshotError, match="not a snapshot"):
        persist.load_snapshot(db, str(bad))
    sig = tmp_path / "sig"
    sig.write_bytes(persist.MAGIC + b"\x00" * 32)
    with pytest.raises(persist.SnapshotError, match="signature"):
        persist.load_snapshot(db, str(sig))
    populate(db)
    ok = tmp_path / "ok"
    persist.save_snapshot(db, str(ok))
    trunc = tmp_path / "trunc"
    trunc.write_bytes(ok.read_bytes()[:-10])
    fresh = port_db(engine)
    with pytest.raises(persist.SnapshotError, match="truncated"):
        persist.load_snapshot(fresh, str(trunc))
    assert call(fresh, "GCOUNT", "GET", "g") == b":0\r\n"  # nothing converged
    with pytest.raises(persist.SnapshotError, match="cannot read"):
        persist.load_snapshot(fresh, str(tmp_path / "missing"))


@pytest.mark.parametrize("engine", ENGINES)
def test_truncation_at_frame_boundary_detected(tmp_path, engine):
    db = port_db(engine)
    populate(db)
    path = tmp_path / "snap.jylis"
    persist.save_snapshot(db, str(path))
    blob = path.read_bytes()
    sig_end = len(persist.MAGIC) + 32
    first_len = parse_header(blob[sig_end: sig_end + HEADER_SIZE])
    cut = tmp_path / "cut.jylis"
    cut.write_bytes(blob[: sig_end + HEADER_SIZE + first_len])
    with pytest.raises(persist.SnapshotError, match="type batches"):
        persist.load_snapshot(port_db(engine), str(cut))


@pytest.mark.parametrize("engine", ENGINES)
def test_write_snapshot_from_async_dump(tmp_path, engine):
    """The online path: per-type async dumps, written atomically, load
    back like save_snapshot's file."""
    db = port_db(engine, identity=7)
    call(db, "GCOUNT", "INC", "g", "5")
    call(db, "TLOG", "INS", "l", "e", "9")
    call(db, "TREG", "SET", "r", "v", "3")
    call(db, "UJSON", "SET", "d", "k", '"x"')
    path = str(tmp_path / "online.jylis")
    persist.write_snapshot(asyncio.run(db.dump_state_async()), path)
    assert not os.path.exists(path + ".tmp")
    fresh = port_db(engine, identity=8)
    assert persist.load_snapshot(fresh, path) == len(list(fresh.managers()))
    assert call(fresh, "GCOUNT", "GET", "g") == b":5\r\n"
    assert call(fresh, "TLOG", "GET", "l") == b"*1\r\n*2\r\n$1\r\ne\r\n:9\r\n"
    assert call(fresh, "TREG", "GET", "r") == b"*2\r\n$1\r\nv\r\n:3\r\n"
    assert call(fresh, "UJSON", "GET", "d", "k") == b'$3\r\n"x"\r\n'
    other = str(tmp_path / "sync.jylis")
    persist.save_snapshot(db, other)
    assert open(other, "rb").read() == open(path, "rb").read()


@pytest.mark.parametrize("engine", ENGINES)
def test_legacy_snapshot_headers(tmp_path, engine):
    """Every legacy header loads a current-shape body; a legacy file cut
    to three whole frames is refused (neither its era's count nor the
    current one)."""
    db = port_db(engine)
    populate(db)
    path = tmp_path / "snap"
    persist.save_snapshot(db, str(path))
    blob = path.read_bytes()
    legacy = codec.legacy_snapshot_signatures()
    assert legacy == jax_codec.legacy_snapshot_signatures() and len(legacy) == 5
    assert codec.legacy_delta_signatures() == jax_codec.legacy_delta_signatures()
    sig_end = len(persist.MAGIC) + 32
    for v, sig in enumerate(legacy, start=1):
        old = tmp_path / f"snap_v{v}"
        old.write_bytes(persist.MAGIC + sig + blob[sig_end:])
        db2 = port_db(engine)
        assert persist.load_snapshot(db2, str(old)) == 9
        for args, want in READS.items():
            assert call(db2, *args) == want, (v, args)
    bodies = frames_of(blob, sig_end)
    partial = tmp_path / "snap_partial"
    partial.write_bytes(persist.MAGIC + legacy[0] + b"".join(
        frame(codec.encode(codec.decode(b))) for b in bodies[:3]))
    with pytest.raises(persist.SnapshotError, match="legacy"):
        persist.load_snapshot(port_db(engine), str(partial))


@pytest.mark.parametrize("engine", ENGINES)
def test_snapshot_failpoints(tmp_path, engine):
    """snapshot.write: error raises out of the write and keeps the old
    file; corrupt and drop write a file the next load refuses.
    snapshot.load: error, corrupt and drop refuse the file, and nothing
    converges."""
    db = port_db(engine)
    populate(db)
    path = str(tmp_path / "snap.jylis")
    persist.save_snapshot(db, path)
    good = open(path, "rb").read()
    try:
        faults.arm("snapshot.write", "error", budget=1)
        with pytest.raises(faults.FaultError):
            persist.save_snapshot(db, path)
        assert open(path, "rb").read() == good
        for action in ("corrupt", "drop"):
            faults.arm("snapshot.write", action, budget=1)
            bad = str(tmp_path / f"{action}.jylis")
            persist.save_snapshot(db, bad)
            with pytest.raises(persist.SnapshotError):
                persist.load_snapshot(port_db(engine), bad)
        for action in ("error", "corrupt", "drop"):
            faults.arm("snapshot.load", action, budget=1)
            fresh = port_db(engine)
            with pytest.raises(persist.SnapshotError):
                persist.load_snapshot(fresh, path)
            assert call(fresh, "GCOUNT", "GET", "g") == b":0\r\n"
        assert faults.hits("snapshot.load") >= 3 and faults.hits("snapshot.write") >= 3
    finally:
        faults.reset()
    assert persist.load_snapshot(port_db(engine), path) == 9


@pytest.mark.parametrize("engine", ENGINES)
def test_large_restored_documents_fold_resident(tmp_path, engine):
    """A restored UJSON document of SEG_FANIN_MIN entries or more goes
    back to a resident row in the restore's drain, a smaller one stays on
    the host, and both read back as written; the file loads into a JAX
    Database with the same digests."""
    db = port_db(engine)
    for i in range(repo_ujson.SEG_FANIN_MIN):
        call(db, "UJSON", "INS", "big", "tags", str(i))
    call(db, "UJSON", "SET", "small", "a", "1")
    path = str(tmp_path / "snap.jylis")
    persist.save_snapshot(db, path)
    db2 = port_db(engine)
    persist.load_snapshot(db2, path)
    repo = db2.manager("UJSON").repo
    assert repo._is_resident(b"big") and not repo._is_resident(b"small")
    for key in ("big", "small"):
        assert call(db2, "UJSON", "GET", key) == call(db, "UJSON", "GET", key)
    jdb = JaxDatabase(identity=1, engine="python")
    jax_persist.load_snapshot(jdb, path)
    assert digests(db2, False) == digests(jdb, True)


def test_snapshot_restores_on_a_mesh(stream):
    """The JAX file restored into a port Database on a 4-part CPU
    keyspace: the restore grows each sharded keyspace before its drain,
    and digests and dumps equal the single-device restore's."""
    from jylis_tpu_torch import parallel

    db = Database(IDENTITY, device="cpu", mesh=parallel.make_mesh(4, devices=["cpu"] * 4))
    assert persist.load_snapshot(db, stream["files"]["jax"]) == 9
    for name in ("GCOUNT", "PNCOUNT", "TREG", "TLOG"):
        assert len(db.manager(name).repo._ks.parts) == 4
    assert digests(db, False) == stream["digests"]["jax"]
    assert encoded_dumps(db, codec) == encoded_dumps(stream["jax_restored"], jax_codec)
