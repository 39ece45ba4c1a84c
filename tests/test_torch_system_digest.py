"""SYSTEM and the sync digest in the port against the JAX package.

One seeded command and delta stream over all eight data types goes into
a JAX ``Database(identity, engine="python")``, a port
``Database(identity, device="cpu")`` and a port Database on a 4-part CPU
keyspace (``mesh=make_mesh(4, devices=["cpu"] * 4)``). It holds counter
values >= 2^63 and the own-counter wrap inside a drain window, TLOG
trims and raised cutoffs, a resident UJSON key and keys of 64 and more
deltas left pending for the digest to fold, TENSOR in all three modes,
and MAP tombstones and BCOUNT escrow (the streams of
test_torch_map_bcount.py). In three rounds, the reply bytes, ``SYSTEM
DIGEST`` and every line of ``SYSTEM DIGEST TYPES`` (through the serving
path's ``apply_async`` and through the blocking path), and every
``sync_tree_async`` leaf must be equal, at tolerance 0. SYSTEM GETLOG,
TOPOLOGY and VERSION replies must be equal, and SYSTEM METRICS must name
the same lines in the sections the port has. The databases are built
once for the module.
"""

import asyncio
import copy

import numpy as np
import pytest
import torch

from jylis_tpu.cluster import codec as jax_codec
from jylis_tpu.models.database import DATA_TYPE_NAMES
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.ops.ujson_host import UJSON as JaxUJSON
from jylis_tpu.server.resp import Respond as JaxRespond
from jylis_tpu_torch import parallel as tpar
from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.models.database import SERVED_TYPES, Database
from jylis_tpu_torch.ops.ujson_host import UJSON
from jylis_tpu_torch.server.resp import Respond

from test_torch_map_bcount import bcount_steps, map_steps
from test_torch_server import decoded, tensor_blob, ujson_delta, vec

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

IDENTITY = 0xABCDEF
U64 = (1 << 64) - 1
DIGEST = [b"SYSTEM", b"DIGEST"]
DIGEST_TYPES = [b"SYSTEM", b"DIGEST", b"TYPES"]


def c(*words) -> list[bytes]:
    return [w if isinstance(w, bytes) else str(w).encode() for w in words]


def uj_spec(rng, n_ops: int = 2):
    """A UJSON delta spec (writer replica, ops) for decoded()."""
    paths = [("a",), ("b",), ("tags",)]
    return (int(rng.integers(300, 303)), [
        ("set" if rng.random() < 0.4 else "ins", paths[int(rng.integers(3))],
         str(int(rng.integers(100)))) for _ in range(n_ops)])


def round_one(rng):
    """Every type: local writes, foreign deltas, reads."""
    steps = []
    keys = [b"k%d" % i for i in range(30)]
    # counters: u64 foreign columns >= 2^63; the own wrap (INC 5, then
    # INC 2^64-1 in one drain window) on k0
    steps.append(("cmd", [c("GCOUNT", "INC", k, int(rng.integers(1, 99))) for k in keys[:20]]
                  + [c("GCOUNT", "INC", b"k0", U64), c("PNCOUNT", "INC", b"k0", 5),
                     c("PNCOUNT", "DEC", b"k0", U64)]
                  + [c("PNCOUNT", "DEC", k, int(rng.integers(1, 99))) for k in keys[5:25]]))
    steps.append(("conv", "GCOUNT", [(k, {7: U64 - i, 8: (1 << 63) + i}) for i, k in
                                     enumerate(keys[10:])]))
    steps.append(("conv", "PNCOUNT", [(k, ({7: (1 << 63) + i}, {9: U64 - i}))
                                      for i, k in enumerate(keys)]))
    steps.append(("cmd", [c(t, "GET", k) for t in ("GCOUNT", "PNCOUNT") for k in keys[:12]]))
    # TREG: ts >= 2^63, a shared 8-byte prefix at equal ts
    steps.append(("cmd", [c("TREG", "SET", k, "v%d" % i, i % 4) for i, k in enumerate(keys)]))
    steps.append(("conv", "TREG", [(k, (b"prefix00%d" % (i % 3), (1 << 63) + i % 2 if i % 2
                                        else i % 4)) for i, k in enumerate(keys)]))
    steps.append(("cmd", [c("TREG", "GET", k) for k in keys[:8]]))
    # TLOG: entries, raised cutoffs, TRIM / TRIMAT / CLR, a u64 ts
    steps.append(("cmd", [c("TLOG", "INS", k, "e%d" % j, int(rng.integers(0, 50)))
                          for k in keys[:15] for j in range(3)]))
    steps.append(("conv", "TLOG", [(k, ([(b"x%d" % j, int(rng.integers(0, 60))) for j in range(4)],
                                        int(rng.integers(0, 20)) if i % 3 == 0 else 0))
                                   for i, k in enumerate(keys)]))
    steps.append(("cmd", [c("TLOG", "TRIM", k, 2) for k in keys[:5]]
                  + [c("TLOG", "TRIMAT", k, 30) for k in keys[5:9]]
                  + [c("TLOG", "CLR", k) for k in keys[9:11]]
                  + [c("TLOG", "INS", b"k20", "big", U64), c("TLOG", "GET", b"k1"),
                     c("TLOG", "CUTOFF", b"k9")]))
    # UJSON: local documents; 300 deltas to "fan" and a GET make it
    # resident; then deltas left pending: a few to "fan", 70 to each of
    # three keys (a shared fold at the digest's drain), some to others
    steps.append(("cmd", [c("UJSON", "SET", b"u%d" % i, "a", '{"x": %d}' % i) for i in range(6)]
                  + [c("UJSON", "INS", b"u1", "tags", '"t"'), c("UJSON", "RM", b"u1", "a", "x", 1),
                     c("UJSON", "CLR", b"u2", "a")]))
    steps.append(("conv", "UJSON", [(b"fan", uj_spec(rng)) for _ in range(300)]))
    steps.append(("cmd", [c("UJSON", "GET", b"fan"), c("UJSON", "GET", b"u1")]))
    steps.append(("conv", "UJSON", [(b"fan", uj_spec(rng)) for _ in range(5)]
                  + [(b"seg%d" % s, uj_spec(rng)) for s in range(3) for _ in range(70)]
                  + [(b"u%d" % i, uj_spec(rng)) for i in range(6)]))
    # TENSOR: the three modes, local and merged
    steps.append(("cmd", [c("TENSOR", "SET", b"tl", "LWW", 7) + [vec(1, 2, 3)],
                          c("TENSOR", "SET", b"tm", "MAX", 0) + [vec(-0.0, 1)],
                          c("TENSOR", "SET", b"ta", "AVG", 4) + [vec(2, 4)]]))
    steps.append(("conv", "TENSOR", [
        (b"tl", tensor_blob(2, 3, vec(9, 9, 9), np.array([7, 8, 6], "<u8").tobytes(),
                            np.array([1, 1, 0xFFFFFFFF], "<u4").tobytes())),
        (b"tm", tensor_blob(1, 2, vec(3, 0))),
        (b"ta", tensor_blob(3, 2, contribs={9: (2, vec(8, 8))}))]))
    steps.append(("cmd", [c("TENSOR", "GET", k) for k in (b"tl", b"tm", b"ta")]))
    # MAP (tombstones, all four inner types) and BCOUNT (escrow)
    for name, made in (("MAP", map_steps(rng, 120)), ("BCOUNT", bcount_steps(rng, 120))):
        steps += [("cmd", [x]) if kind == "cmd" else ("conv", name, x) for kind, x in made]
    return steps


def round_two(rng):
    """A second round over several types (the digest re-folds only them)."""
    return [("cmd", [c("GCOUNT", "INC", b"k%d" % i, 3) for i in range(5)]
             + [c("TREG", "SET", b"n%d" % i, "w", 9) for i in range(4)]
             + [c("TLOG", "TRIM", b"k12", 1), c("MAP", "TREG", "DEL", b"m0", b"TR0"),
                c("BCOUNT", "GRANT", b"b4", 9)]),
            ("conv", "UJSON", [(b"seg0", uj_spec(rng)) for _ in range(3)]),
            ("conv", "PNCOUNT", [(b"k3", ({8: U64}, {}))])]


ROUND_THREE = [("cmd", [c("GCOUNT", "INC", b"k%d" % i, 1) for i in range(3)]
                + [c("GCOUNT", "INC", b"fresh", 2)])]


def feed(db, steps, jax_side: bool, out: bytearray, writers: dict) -> None:
    """Apply a round's steps; UJSON deltas are built by each package's
    own document class from their specs, one writer document per (key,
    replica) for the whole stream (so a writer's dots never repeat)."""
    resp = (JaxRespond if jax_side else Respond)(out.extend)
    cod = jax_codec if jax_side else codec
    cls = JaxUJSON if jax_side else UJSON
    for step in steps:
        if step[0] == "cmd":
            for cmd in step[1]:
                db.apply(resp, list(cmd))
            continue
        if step[1] == "UJSON":
            batch = [(k, ujson_delta(cls, writers, k, spec)) for k, spec in step[2]]
        else:
            batch = decoded(step[1], copy.deepcopy(step[2]), cod)
        if jax_side:
            db.converge_deltas((step[1], batch))
        else:
            db.converge(step[1], batch)


def ask(db, cmd, jax_side: bool, serving: bool) -> bytes:
    out = bytearray()
    resp = (JaxRespond if jax_side else Respond)(out.extend)
    if serving:
        asyncio.run(db.apply_async(resp, list(cmd)))
    else:
        db.apply(resp, list(cmd))
    return bytes(out)


def mismatch(jdb, tdb) -> str:
    """Name the first type whose digest differs and its first key whose
    canonical state differs, with both canons."""
    for name in DATA_TYPE_NAMES:
        if jdb._sync_xor[name] == tdb._sync_xor[name]:
            continue
        jh, th = jdb._sync_hash[name], tdb._sync_hash[name]
        for key in sorted(set(jh) | set(th)):
            if jh.get(key) != th.get(key):
                jrepo, trepo = (db.manager(name).repo for db in (jdb, tdb))
                return (f"{name}: key {key!r}: JAX canon {jrepo.sync_canon(key)!r} != "
                        f"port canon {trepo.sync_canon(key)!r}")
        return f"{name}: equal per-key hashes but different XOR"
    return "no type differs"


@pytest.fixture(scope="module")
def nodes():
    """The three databases after each round: replies, and the digest
    replies asked on the serving path (round 1), the blocking path
    (round 2) and both (round 3)."""
    rng = np.random.default_rng(8)
    rounds = [round_one(rng), round_two(rng), ROUND_THREE]
    dbs = {"jax": JaxDatabase(identity=IDENTITY, engine="python"),
           "cpu": Database(IDENTITY, device="cpu"),
           "mesh": Database(IDENTITY, device="cpu",
                            mesh=tpar.make_mesh(4, devices=["cpu"] * 4))}
    out = {"dbs": dbs, "replies": {n: [] for n in dbs}, "digests": {n: [] for n in dbs},
           "pending_fan": None}
    writers = {n: {} for n in dbs}
    for r, steps in enumerate(rounds):
        for name, db in dbs.items():
            buf = bytearray()
            feed(db, steps, name == "jax", buf, writers[name])
            out["replies"][name].append(bytes(buf))
            if r == 0 and name == "cpu":
                repo = db.manager("UJSON").repo
                out["pending_fan"] = (repo._is_resident(b"fan"), len(repo._pend.get(b"fan", ())),
                                      len(repo._pend.get(b"seg0", ())))
            modes = [[True], [False], [True, False]][r]
            out["digests"][name].append([
                (ask(db, DIGEST_TYPES, name == "jax", s), ask(db, DIGEST, name == "jax", s))
                for s in modes])
    return out


def test_replies_match_jax(nodes):
    want = nodes["replies"]["jax"]
    for name in ("cpu", "mesh"):
        assert nodes["replies"][name] == want, name
    assert sum(len(r) for r in want) > 10_000


def test_the_stream_reaches_resident_and_pending_ujson(nodes):
    """Before the first digest a UJSON key is resident with deltas still
    pending, and three keys hold 70 pending deltas each; the digest folds
    them (nothing left pending after it)."""
    resident, fan_pending, seg_pending = nodes["pending_fan"]
    assert (resident, fan_pending, seg_pending) == (True, 5, 70)
    for name in ("cpu", "mesh"):
        repo = nodes["dbs"][name].manager("UJSON").repo
        assert not repo._pend and repo._is_resident(b"seg0"), name


@pytest.mark.parametrize("rnd", [0, 1, 2], ids=["serving", "blocking", "both"])
def test_system_digest_matches_jax(nodes, rnd):
    jdb = nodes["dbs"]["jax"]
    want = nodes["digests"]["jax"][rnd]
    for name in ("cpu", "mesh"):
        got = nodes["digests"][name][rnd]
        for (jt, jd), (tt, td) in zip(want, got):
            assert tt == jt, f"{name}: SYSTEM DIGEST TYPES: {mismatch(jdb, nodes['dbs'][name])}"
            assert td == jd, name
    assert len({d for pair in want for d in pair}) == 2  # both paths gave one answer


def test_digest_types_lines(nodes):
    """Eight lines in the JAX registry's order, every type non-zero."""
    types, digest = nodes["digests"]["cpu"][0][0]
    lines = [ln for ln in types.split(b"\r\n") if ln and ln[:1] not in b"*$"]
    assert [ln.split()[0].decode() for ln in lines] == list(DATA_TYPE_NAMES) == list(SERVED_TYPES)
    assert all(ln.split()[1] != b"0" * 64 for ln in lines)
    assert digest.startswith(b"$64\r\n")


def test_digest_is_incremental(nodes):
    """Round 3 wrote four GCOUNT keys: its digest re-hashes those four keys
    and nothing else, and the other types' digests stay as they were."""
    dbs = nodes["dbs"]
    calls = {}
    for name in ("cpu",):
        db = dbs[name]
        for t in SERVED_TYPES:
            db.manager(t).repo.sync_dirty_keys()  # nothing is dirty after round 3
        db.apply(Respond(bytearray().extend), c("GCOUNT", "INC", b"k1", 1))
        db.apply(Respond(bytearray().extend), c("TREG", "SET", b"k1", "z", U64))
        for t in SERVED_TYPES:
            repo = db.manager(t).repo
            calls[t] = []
            orig = repo.sync_canon
            repo.sync_canon = lambda key, orig=orig, t=t: calls[t].append(key) or orig(key)
        before = dict(db._sync_xor)
        db._sync_digest_blocking()
        for t in SERVED_TYPES:
            del db.manager(t).repo.sync_canon
        assert calls["GCOUNT"] == [b"k1"] and calls["TREG"] == [b"k1"]
        assert all(not calls[t] for t in SERVED_TYPES if t not in ("GCOUNT", "TREG"))
        assert [t for t in SERVED_TYPES if db._sync_xor[t] != before[t]] == ["TREG", "GCOUNT"]
    r3 = nodes["digests"]
    assert r3["cpu"][1][0][0] != r3["cpu"][2][0][0]  # round 3 moved GCOUNT's line


@pytest.mark.parametrize("name", DATA_TYPE_NAMES)
def test_sync_tree_leaves_match_jax(nodes, name):
    trees = {n: asyncio.run(db.sync_tree_async(name)) for n, db in nodes["dbs"].items()
             if n != "cpu"}
    assert trees["mesh"] == trees["jax"]
    assert len(trees["jax"]) >= 3


def test_system_getlog_topology_version_match_jax(nodes):
    """A converged SYSTEM log delta reads back the same; TOPOLOGY gives
    the cluster-less self line and VERSION the package version."""
    log = [(b"_log", ([(b"b", 9), (b"a", 9), (b"c", 1)], 2))]
    got = {}
    for name, db in nodes["dbs"].items():
        if name == "jax":
            db.converge_deltas(("SYSTEM", copy.deepcopy(log)))
        else:
            db.converge("SYSTEM", copy.deepcopy(log))
        got[name] = [ask(db, c("SYSTEM", *w), name == "jax", s) for s in (False, True) for w in
                     (["GETLOG"], ["GETLOG", 1], ["TOPOLOGY"], ["VERSION"], ["FOO"], [])]
    assert got["cpu"] == got["mesh"] == got["jax"]
    assert got["jax"][0] == b"*2\r\n*2\r\n$1\r\nb\r\n:9\r\n*2\r\n$1\r\na\r\n:9\r\n"
    assert got["jax"][3] == b"$15\r\njylis-tpu 0.5.0\r\n"


def metric_names(reply: bytes) -> list[str]:
    """Each line of a reply without its numbers."""
    def name(line: str) -> str:
        return " ".join(w for w in line.split() if not w.replace(".", "").isdigit())

    return [name(ln.decode()) for ln in reply.split(b"\r\n") if ln and ln[:1] not in b"*$"]


def test_metrics_line_names_match_jax(nodes):
    """SYSTEM METRICS names the same lines (cmds per type, the SERVING
    split, drain counters, LATENCY seams) and SYSTEM LATENCY / OBSERVE /
    TRACE SPANS the same seams and lines; the port has no CLUSTER,
    SESSION, LANE or OVERLOAD section, and neither has a JAX node without
    a cluster or armed admission. The port's SYSTEM METRICS ends with its
    own SPAN section, which a JAX node lacks: every line before it is
    compared exactly, and it names each declared span's three fields."""
    from jylis_tpu_torch.obs import SPAN_FIELDS

    names = {}
    for name, db in nodes["dbs"].items():
        names[name] = [metric_names(ask(db, c("SYSTEM", *w), name == "jax", False))
                       for w in (["METRICS"], ["LATENCY"], ["OBSERVE"], ["TRACE", "SPANS"])]
    for name in ("cpu", "mesh"):
        declared = nodes["dbs"][name].metrics.span_totals
        assert "lock_wait.PNCOUNT.apply" in declared
        spans = [f"SPAN {s} {f}" for s in declared for f in SPAN_FIELDS]
        assert names[name][0][-len(spans):] == spans
        del names[name][0][-len(spans):]
    assert not any(n.startswith("SPAN ") for n in names["jax"][0])
    assert names["cpu"] == names["mesh"] == names["jax"]
    metrics = names["jax"][0]
    for want in ("UJSON cmds", "SERVING demoted_cmds", "TLOG drains", "GCOUNT keys",
                 "LATENCY drain.TLOG.p99_us", "BCOUNT cmds"):
        assert want in metrics, want
    assert not any(n.split()[0] in ("CLUSTER", "SESSION", "LANE", "OVERLOAD") for n in metrics)
