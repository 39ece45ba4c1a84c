"""The port keys-sharded over several cards, against the JAX package.

A node started with ``--device cuda`` on a host with several cards
shards every plane-backed repo over all of them (parallel/mesh.py
``serving_mesh``). On the CPU a card is a device name, ``cpu:i``: the
shards on one name form one card (one shard table, one staged copy
each way), so ``["cpu:0", "cpu:1", "cpu:2", "cpu:3"]`` is four distinct
cards, where ``["cpu"] * 4`` (the other port tests' mesh) is one. Every
comparison is exact (tolerance 0):

(a) a port ``Database`` on the four cards, fed the digest script of
    test_torch_system_digest.py, gives a JAX single-device Database's
    reply bytes, ``SYSTEM DIGEST`` / ``DIGEST TYPES`` and encoded dumps;
(b) the counter, TREG and TLOG repos grow from a capacity of 8 keys
    over several doublings on the four cards (each doubling gathers the
    shards, grows and splits them again): replies, flushes and dumps
    equal a one-device port repo's and the JAX repo's after every round;
(c) a snapshot written by the four-card Database restores into a
    one-device Database, and one written on one device restores on the
    four cards: digests equal the JAX Database's, dumps equal a JAX
    Database's restore of the same file (a TLOG row's entries at one
    timestamp dump in the order their values were interned, which a
    restore changes);
(d) ``join_replica_axis`` on (rep 4, keys 1) and (2, 2) meshes of the
    four cards gives numpy's column max in every block;
(e) the per-card launch tally (ops/_build.py ``count``) sums to each
    wrapper's ``.launches``; a node's shutdown line carries both, and
    chip_smoke.py reads both back; a mesh node's warmup reaches every
    card's keyspace; chip_smoke.py's mesh puts two shards on each of two
    cards.
"""

import copy
import json

import numpy as np
import pytest
import torch

from jylis_tpu import persist as jax_persist
from jylis_tpu.cluster import codec as jax_codec
from jylis_tpu.models import repo_counters as jrc
from jylis_tpu.models import repo_tlog as jrl
from jylis_tpu.models import repo_treg as jrt
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.server import resp as jresp
from jylis_tpu_torch import parallel as tpar
from jylis_tpu_torch import persist
from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.models import database as tdatabase
from jylis_tpu_torch.models import repo_counters as rc
from jylis_tpu_torch.models import repo_tlog as rl
from jylis_tpu_torch.models import repo_treg as rt
from jylis_tpu_torch.models.database import Database
from jylis_tpu_torch.ops import _build, planes
from jylis_tpu_torch.server import resp as tresp
from jylis_tpu_torch.utils import metrics

from test_torch_persist import digests, encoded_dumps
from test_torch_system_digest import (
    DIGEST, DIGEST_TYPES, IDENTITY, ROUND_THREE, ask, feed, mismatch, round_one, round_two,
)

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

CARDS = ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
U64 = (1 << 64) - 1


def cards_mesh(rep: int = 1):
    return tpar.make_mesh(len(CARDS), rep=rep, devices=CARDS)


# ---- (a) the four-card Database against JAX -----------------------------------------


@pytest.fixture(scope="module")
def fed():
    """A JAX single-device Database and a port Database on the four cards,
    fed the digest script's three rounds; each one's replies and digests
    (serving path, blocking path, both) after each round."""
    rng = np.random.default_rng(8)
    rounds = [round_one(rng), round_two(rng), ROUND_THREE]
    dbs = {"jax": JaxDatabase(identity=IDENTITY, engine="python"),
           "cards": Database(IDENTITY, device="cpu", mesh=cards_mesh())}
    out = {"dbs": dbs, "replies": {n: [] for n in dbs}, "digests": {n: [] for n in dbs}}
    writers = {n: {} for n in dbs}
    for r, steps in enumerate(rounds):
        for name, db in dbs.items():
            buf = bytearray()
            feed(db, steps, name == "jax", buf, writers[name])
            out["replies"][name].append(bytes(buf))
            modes = [[True], [False], [True, False]][r]
            out["digests"][name].append([
                (ask(db, DIGEST_TYPES, name == "jax", s), ask(db, DIGEST, name == "jax", s))
                for s in modes])
    return out


def test_every_repo_is_sharded_over_four_cards(fed):
    db = fed["dbs"]["cards"]
    for name in ("GCOUNT", "PNCOUNT", "TREG", "TLOG"):
        ks = db.manager(name).repo._ks
        assert len(ks.parts) == 4 and len(ks.cards) == 4, name
        assert [str(d) for d in ks.devices] == CARDS
    store = db.manager("UJSON").repo._res
    assert store is not None and len(store._ks.cards) == 4


def test_four_card_replies_match_jax(fed):
    assert fed["replies"]["cards"] == fed["replies"]["jax"]
    assert sum(len(r) for r in fed["replies"]["jax"]) > 10_000


@pytest.mark.parametrize("rnd", [0, 1, 2], ids=["serving", "blocking", "both"])
def test_four_card_system_digest_matches_jax(fed, rnd):
    jdb, tdb = fed["dbs"]["jax"], fed["dbs"]["cards"]
    for (jt, jd), (tt, td) in zip(fed["digests"]["jax"][rnd], fed["digests"]["cards"][rnd]):
        assert tt == jt, f"SYSTEM DIGEST TYPES: {mismatch(jdb, tdb)}"
        assert td == jd


def test_four_card_dumps_encode_as_jax(fed):
    got = encoded_dumps(fed["dbs"]["cards"], codec)
    want = encoded_dumps(fed["dbs"]["jax"], jax_codec)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


# ---- (b) growth over several doublings on four cards --------------------------------


def _counter_delta(rng, pn: bool):
    cols = {int(c): int(rng.integers(0, 1 << 64, dtype=np.uint64))
            for c in rng.integers(1, 6, 2)}
    return (cols, {5: int(rng.integers(1, 1 << 63))}) if pn else cols


def _round_steps(rng, name: str, keys: list[bytes]):
    """One round over ``keys``: local writes on every key, foreign deltas
    on half of them, then a read of every key (each read drains)."""
    steps = []
    for i, k in enumerate(keys):
        if name in ("GCOUNT", "PNCOUNT"):
            steps.append(("cmd", [b"INC", k, b"%d" % int(rng.integers(1, 1 << 40))]))
            if name == "PNCOUNT" and i % 3 == 0:
                steps.append(("cmd", [b"DEC", k, b"%d" % int(rng.integers(1, 99))]))
        elif name == "TREG":
            steps.append(("cmd", [b"SET", k, b"v%d" % int(rng.integers(9)),
                                  b"%d" % int(rng.integers(0, 6))]))
        else:
            steps.append(("cmd", [b"INS", k, b"e%d" % int(rng.integers(9)),
                                  b"%d" % int(rng.integers(0, 1 << 40))]))
    for k in keys[::2]:
        if name in ("GCOUNT", "PNCOUNT"):
            steps.append(("conv", k, _counter_delta(rng, name == "PNCOUNT")))
        elif name == "TREG":
            steps.append(("conv", k, (b"w%d" % int(rng.integers(9)),
                                      int(rng.integers(0, 1 << 64, dtype=np.uint64)))))
        else:
            steps.append(("conv", k, ([(b"x%d" % j, int(rng.integers(0, 1 << 40)))
                                       for j in range(3)], int(rng.integers(0, 1 << 20)))))
    steps += [("cmd", [b"GET", k]) for k in keys]
    if name == "TLOG":
        steps += [("cmd", [b"TRIM", k, b"2"]) for k in keys[1::5]]
    return steps


GROWTH = {"GCOUNT": (jrc.RepoGCOUNT, rc.RepoGCOUNT), "PNCOUNT": (jrc.RepoPNCOUNT, rc.RepoPNCOUNT),
          "TREG": (jrt.RepoTREG, rt.RepoTREG), "TLOG": (jrl.RepoTLOG, rl.RepoTLOG)}


@pytest.mark.parametrize("name", list(GROWTH))
def test_repos_grow_over_four_cards_as_one_device_and_jax(name):
    """Keys 6, 12, ... 384: the keyspace doubles from 8 rows to 512 on the
    four cards, each doubling a gather, grow and split; after each round
    the replies, flushed deltas and dumps of the four-card repo equal the
    one-device port repo's and the JAX repo's."""
    jcls, tcls = GROWTH[name]
    rng = np.random.default_rng(len(name))
    jrepo = jcls(IDENTITY, key_cap=8, mesh=None, engine="python")
    one = tcls(IDENTITY, key_cap=8, device="cpu")
    four = tcls(IDENTITY, key_cap=8, device="cpu", mesh=cards_mesh())
    caps = []
    out = {n: bytearray() for n in ("jax", "one", "four")}
    resps = {"jax": jresp.Respond(out["jax"].extend), "one": tresp.Respond(out["one"].extend),
             "four": tresp.Respond(out["four"].extend)}
    repos = {"jax": jrepo, "one": one, "four": four}
    for n_keys in (6, 12, 24, 48, 96, 192, 384):
        keys = [b"g%d" % i for i in range(n_keys)]
        for kind, *args in _round_steps(rng, name, keys):
            for side, repo in repos.items():
                if kind == "cmd":
                    repo.apply(resps[side], list(args[0]))
                else:
                    repo.converge(args[0], copy.deepcopy(args[1]))
        assert bytes(out["four"]) == bytes(out["one"]) == bytes(out["jax"]), n_keys
        flushed = [repo.flush_deltas() for repo in repos.values()]
        assert flushed[0] == flushed[1] == flushed[2], n_keys
        dumps = [repo.dump_state() for repo in repos.values()]
        assert dumps[0] == dumps[1] == dumps[2], n_keys
        assert len(four._ks.parts) == 4 and len(four._ks.cards) == 4
        caps.append(four._ks.key_cap)
    assert caps[0] == 8 and caps[-1] >= 512 and len(set(caps)) >= 6


# ---- (c) snapshots across device layouts --------------------------------------------


def restored_as_jax(path: str):
    """A JAX Database restored from ``path``: the dumps a restore gives."""
    jdb = JaxDatabase(identity=IDENTITY, engine="python")
    jax_persist.load_snapshot(jdb, path)
    return jdb


def test_a_four_card_snapshot_restores_on_one_device(fed, tmp_path):
    path = str(tmp_path / "cards.jylis")
    persist.save_snapshot(fed["dbs"]["cards"], path)
    one = Database(IDENTITY, device="cpu")
    assert persist.load_snapshot(one, path) == 9
    assert digests(one, False) == digests(fed["dbs"]["jax"], True)
    assert encoded_dumps(one, codec) == encoded_dumps(restored_as_jax(path), jax_codec)


def test_a_one_device_snapshot_restores_on_four_cards(fed, tmp_path):
    """The four-card restore of a file a one-device Database wrote (the
    four-card Database's state, restored on one device and saved)."""
    src, path = str(tmp_path / "src.jylis"), str(tmp_path / "one.jylis")
    persist.save_snapshot(fed["dbs"]["cards"], src)
    one = Database(IDENTITY, device="cpu")
    persist.load_snapshot(one, src)
    persist.save_snapshot(one, path)
    four = Database(IDENTITY, device="cpu", mesh=cards_mesh())
    assert persist.load_snapshot(four, path) == 9
    for name in ("GCOUNT", "PNCOUNT", "TREG", "TLOG"):
        ks = four.manager(name).repo._ks
        assert len(ks.parts) == len(ks.cards) == 4, name
    assert digests(four, False) == digests(fed["dbs"]["jax"], True)
    assert encoded_dumps(four, codec) == encoded_dumps(restored_as_jax(path), jax_codec)


# ---- (d) the replica join over distinct cards ---------------------------------------


@pytest.mark.parametrize("rep,s", [(4, 64), (4, 12), (2, 64), (2, 10)],
                         ids=["rep4-S64", "rep4-S12", "rep2-S64", "rep2-S10"])
def test_join_replica_axis_over_four_cards_matches_numpy(rep, s):
    rng = np.random.default_rng(s * 10 + rep)
    k = 256
    states = rng.integers(0, 1 << 64, size=(s, k), dtype=np.uint64)
    states[:, 0] = 0
    states[-1, 1] = U64
    states[:, 2] = 1 << 63
    mesh = cards_mesh(rep)
    assert mesh.devices.shape == (rep, 4 // rep)
    blocks = tpar.shard_grid(mesh, states)
    out = tpar.join_replica_axis(mesh, blocks)
    want = states.max(axis=0)
    nk = 4 // rep
    for r in range(rep):
        for c in range(nk):
            got = out[r][c]
            assert tuple(got.shape) == tuple(blocks[r][c].shape)
            np.testing.assert_array_equal(
                planes.to_u64_np(got.contiguous()),
                np.broadcast_to(want[c * k // nk:(c + 1) * k // nk], got.shape))


# ---- (e) the per-card tally -------------------------------------------------------------


def test_every_wrapper_tallies_its_launches_by_card():
    """``count`` adds one to ``.launches`` and to the card's entry of
    ``.by_card`` (and the class, on the row kernels); their sum is
    ``.launches``; ``reset`` sets both to 0; ``launches_since`` reads
    the difference a node logs at its clean shutdown."""
    wrappers = metrics.kernel_wrappers()
    assert len(wrappers) == 13
    saved = {n: (fn.launches, dict(fn.by_card), dict(getattr(fn, "classes", {})))
             for n, fn in wrappers.items()}
    try:
        _build.reset(*wrappers.values())
        before = (metrics.kernel_launches(), metrics.kernel_launches_by_card())
        rng = np.random.default_rng(5)
        for i, (name, fn) in enumerate(wrappers.items()):
            for _ in range(i + 1):
                card = int(rng.integers(0, 4))
                kind = "warp" if hasattr(fn, "classes") else None
                _build.count(fn, torch.device("cuda", card) if i % 2 else card, kind)
        for name, fn in wrappers.items():
            assert sum(fn.by_card.values()) == fn.launches > 0, name
            if hasattr(fn, "classes"):
                assert fn.classes == {"warp": fn.launches}
        total, cards = metrics.launches_since(*before)
        assert total == {n: fn.launches for n, fn in wrappers.items()}
        assert {n: sum(c.values()) for n, c in cards.items()} == total
        assert all(set(c) <= {"0", "1", "2", "3"} for c in cards.values())
        _build.reset(*wrappers.values())
        assert not any(fn.launches or fn.by_card for fn in wrappers.values())
    finally:
        for n, fn in wrappers.items():
            fn.launches, fn.by_card = saved[n][0], saved[n][1]
            if hasattr(fn, "classes"):
                fn.classes.clear()
                fn.classes.update(saved[n][2])


def test_chip_smoke_reads_the_shutdown_launch_line():
    """The line a node logs at its clean shutdown (main.Dispose), with
    the tally by card, parses back through chip_smoke.py's patterns; a
    lane's start line gives its device and its mesh."""
    import chip_smoke as cs

    line = (f"kernel launches since warmup (pid 41): {json.dumps({'treg_drain_sparse': 3})}; "
            f"by card: {json.dumps({'treg_drain_sparse': {'0': 1, '3': 2}})}")
    [(pid, total, cards)] = cs._LANE_LAUNCHES.findall("x\n" + line + "\ny")
    assert (pid, json.loads(total), json.loads(cards)) == (
        "41", {"treg_drain_sparse": 3}, {"treg_drain_sparse": {"0": 1, "3": 2}})
    up = ("serving lane 1/2 (pid 77) TREG/TLOG on port 7000, device cuda:0, "
          "Mesh({'rep': 1, 'keys': 4}, ['cuda:0', 'cuda:1', 'cuda:2', 'cuda:3'])")
    [(lane, pid, dev, mesh)] = cs._LANE_UP.findall(up)
    assert (lane, pid, dev) == ("1", "77", "cuda:0") and "cuda:3" in mesh
    [(_, _, dev, mesh)] = cs._LANE_UP.findall("serving lane 0/2 (pid 5) X on port 1, device cpu")
    assert (dev, mesh) == ("cpu", "")
    tally = cs.card_sum({"a": {"0": 1}}, {"a": {"0": 2, "1": 1}, "b": {"2": 1}})
    assert tally == {"a": {"0": 3, "1": 1}, "b": {"2": 1}}
    assert cs.off_cards(tally, (("a",), ("b", "a")), 3) == [(("a",), 2)]


def test_a_mesh_warmup_fills_every_cards_keyspace():
    """``_warm_cards``: writes to fresh keys fill the counter, TREG and
    TLOG keyspaces to their first capacity, so the last card holds keys,
    and nothing grows; the last key (on the last card) reads back."""
    db = Database(identity=0, device="cpu", mesh=cards_mesh())
    tdatabase._warm_cards(db, tdatabase._NullRespond())
    for name in ("GCOUNT", "PNCOUNT", "TREG", "TLOG"):
        repo = db.manager(name).repo
        rows = repo._tbl.rows()
        assert rows == repo._key_cap == 1024, name
        assert rows - 1 >= 3 * repo._ks.rows_per_shard  # a key on the last card
    out = bytearray()
    for name in (b"GCOUNT", b"PNCOUNT", b"TREG", b"TLOG"):
        db.apply(tresp.Respond(out.extend), [name, b"GET", b"warm1023"])
    assert bytes(out) == (b":1\r\n:1\r\n*2\r\n$1\r\nv\r\n:1\r\n"
                          b"*1\r\n*2\r\n$1\r\nv\r\n:1\r\n")


def test_chip_smoke_mesh_takes_every_card(monkeypatch):
    """Four shards: one a card on four cards, two a card on two, all on
    the one card of a one-card host."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "DEVICE", "cuda")
    for count, want in ((4, [0, 1, 2, 3]), (8, [0, 1, 2, 3]), (2, [0, 0, 1, 1]),
                        (1, [0, 0, 0, 0])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda count=count: count)
        assert cs.mesh_devices(torch) == [f"cuda:{i}" for i in want], count


def test_a_node_on_cuda_never_falls_back_to_the_cpu(monkeypatch):
    """``--device cuda`` without a card raises instead of serving on the
    CPU; with several cards the serving mesh takes only cards."""
    from jylis_tpu_torch.parallel import mesh as tmesh

    with pytest.raises(RuntimeError, match="requested"):
        Database(IDENTITY, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tmesh, "_SERVING_MESH", [])
    mesh = tmesh.resolve_mesh("auto", "cuda")
    assert [str(d) for d in mesh.keys_devices] == [f"cuda:{i}" for i in range(4)]
    assert tmesh.resolve_mesh("auto", "cuda:1") is None
