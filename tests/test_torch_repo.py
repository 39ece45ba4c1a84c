"""Parity of the port's counter repos and database with the JAX package's.

One seeded stream of INC/DEC/GET commands and anti-entropy converges
goes into a JAX repo (``mesh=None``: tests/conftest.py forces 8 virtual
CPU devices, which would otherwise select the sharded drain;
``engine="python"``: the pure-Python table) and into the port's repo on
the CPU. The reply bytes, the flushed outbound deltas and the dumped
state must be equal. The streams cross the dense-drain threshold, grow
the keyspace and the replica columns, and wrap sums past 2^64.
"""

import asyncio
import copy

import numpy as np
import pytest
import torch

from jylis_tpu.models import repo_counters as jrc
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.server import resp as jresp
from jylis_tpu_torch.models import database as tdb
from jylis_tpu_torch.models import repo_counters as rc
from jylis_tpu_torch.ops import gcount, pncount
from jylis_tpu_torch.server import resp as tresp

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

IDENTITY = 0xC0FFEE
U64 = (1 << 64) - 1


def amount(rng) -> int:
    # mostly small, some near 2^64 so own columns and sums wrap
    return int(rng.integers(1, 1 << 20)) if rng.random() < 0.7 else int(
        rng.integers(1 << 62, 1 << 64, dtype=np.uint64)
    )


def delta(rng, rids, pn: bool):
    def one():
        pick = rng.choice(len(rids), size=int(rng.integers(1, 4)), replace=False)
        return {rids[i]: amount(rng) for i in pick}

    return (one(), one()) if pn else one()


def run_stream(name, seed, n_keys, n_rids, n_ops):
    rng = np.random.default_rng(seed)
    rids = [int(x) for x in rng.integers(1, 1 << 62, n_rids)]
    keys = [b"key%d" % i for i in range(n_keys)]
    pn = name == "PNCOUNT"
    jrepo = getattr(jrc, f"Repo{name}")(IDENTITY, mesh=None, engine="python")
    trepo = getattr(rc, f"Repo{name}")(IDENTITY, device="cpu")
    jout, tout = bytearray(), bytearray()
    jr, tr = jresp.Respond(jout.extend), tresp.Respond(tout.extend)
    ops = ["INC", "DEC", "GET", "CONV", "BULK", "FLUSH"] if pn else [
        "INC", "GET", "CONV", "BULK", "FLUSH"]
    weights = np.array([4, 2, 4, 3, 0.3, 0.5] if pn else [4, 4, 3, 0.3, 0.5])
    for _ in range(n_ops):
        op = ops[rng.choice(len(ops), p=weights / weights.sum())]
        key = keys[int(rng.integers(n_keys))]
        if op in ("INC", "DEC", "GET"):
            args = [op.encode(), key] + (
                [b"%d" % amount(rng)] if op != "GET" else []
            )
            for repo, r in ((jrepo, jr), (trepo, tr)):
                repo.apply(r, list(args))
        elif op == "CONV":
            d = delta(rng, rids, pn)
            jrepo.converge(key, d)
            trepo.converge(key, d)
        elif op == "BULK":
            # one replica sweep over a random third of the keyspace
            for i in rng.choice(n_keys, max(1, n_keys // 3), replace=False):
                k = keys[i]
                d = delta(rng, rids, pn)
                jrepo.converge(k, d)
                trepo.converge(k, d)
        else:
            assert trepo.flush_deltas() == jrepo.flush_deltas()
            assert trepo.deltas_size() == jrepo.deltas_size() == 0
        assert bytes(tout) == bytes(jout), op
    for k in keys:
        for repo, r in ((jrepo, jr), (trepo, tr)):
            repo.apply(r, [b"GET", k])
    assert bytes(tout) == bytes(jout)
    assert trepo.flush_deltas() == jrepo.flush_deltas()
    assert trepo.dump_state() == jrepo.dump_state()
    return trepo, bytes(tout)


@pytest.mark.parametrize("name", ["GCOUNT", "PNCOUNT"])
@pytest.mark.parametrize("seed,n_keys,n_rids,n_ops", [
    (0, 12, 3, 300),  # sparse drains only
    (1, 600, 5, 120),  # bulk sweeps take the dense drain
    (2, 2400, 12, 120),  # keyspace and replica columns both grow
])
def test_command_and_delta_stream_matches_jax(name, seed, n_keys, n_rids, n_ops):
    trepo, out = run_stream(name, seed, n_keys, n_rids, n_ops)
    assert b":" in out  # GETs were answered
    assert trepo._state[0].device.type == "cpu"
    if n_keys > 1024:
        assert trepo._key_cap >= 2048 and trepo._rep_cap == 16


def test_dense_and_sparse_drains_both_run(monkeypatch):
    """The port's repo takes the dense drain for a sweep covering >= 1/4
    of the keyspace and the sparse one otherwise (DENSE_FRACTION)."""
    calls = []
    for fn in ("_drain_pn", "_drain_pn_dense"):
        orig = getattr(rc, fn)
        monkeypatch.setattr(
            rc, fn, lambda *a, _o=orig, _n=fn: calls.append(_n) or _o(*a)
        )
    repo = rc.RepoPNCOUNT(IDENTITY, device="cpu")
    for i in range(300):
        repo.converge(b"k%d" % i, ({7: i + 1}, {}))
    repo.drain()
    repo.converge(b"k1", ({7: 99}, {9: 1}))
    repo.drain()
    assert calls == ["_drain_pn_dense", "_drain_pn"]
    out = bytearray()
    repo.apply(tresp.Respond(out.extend), [b"GET", b"k1"])
    assert bytes(out) == b":98\r\n"


def test_database_dense_drains_match_jax(monkeypatch):
    """A port Database on the CPU and a JAX Database take one stream that
    forces the dense drains: local INC/DEC, then foreign deltas from three
    replicas at 600 and 500 of the 1,024 rows (>= K / 4; values >= 2^63,
    sums that wrap), GETs that drain, SYSTEM DIGEST, a sparse round and a
    grow past 1,024 keys. Replies, digests and dumps must be equal, and
    the port's dense wrappers must have run."""
    calls = []
    for fn in ("_drain_g_dense", "_drain_pn_dense"):
        orig = getattr(rc, fn)
        monkeypatch.setattr(rc, fn, lambda *a, _o=orig, _n=fn: calls.append(_n) or _o(*a))
    rng = np.random.default_rng(23)
    rids = [int(x) for x in rng.integers(1, 1 << 62, 3)]
    keys = [b"key%d" % i for i in range(1500)]
    jdb = JaxDatabase(identity=IDENTITY, engine="python")
    pdb = tdb.Database(IDENTITY, device="cpu")
    jout, tout = bytearray(), bytearray()
    jr, tr = jresp.Respond(jout.extend), tresp.Respond(tout.extend)

    def cmds(lines):
        for line in lines:
            jdb.apply(jr, list(line))
            pdb.apply(tr, list(line))
        assert bytes(tout) == bytes(jout)

    def conv(name, ks):
        batch = [(k, delta(rng, rids, name == "PNCOUNT")) for k in ks]
        jdb.converge_deltas((name, copy.deepcopy(batch)))
        pdb.converge(name, copy.deepcopy(batch))

    def gets(ks):
        cmds([[t, b"GET", k] for t in (b"GCOUNT", b"PNCOUNT") for k in ks])

    cmds([[b"GCOUNT", b"INC", k, b"%d" % amount(rng)] for k in keys[:60]]
         + [[b"PNCOUNT", b"DEC", k, b"%d" % amount(rng)] for k in keys[30:90]])
    conv("GCOUNT", keys[:600])
    conv("PNCOUNT", keys[100:600])
    gets(keys[:700:7])
    assert calls == ["_drain_g_dense", "_drain_pn_dense"]
    cmds([[b"SYSTEM", b"DIGEST"]])
    conv("GCOUNT", keys[5:10])
    conv("PNCOUNT", keys[5:10])
    gets(keys[:12])
    conv("GCOUNT", keys[:1500])  # the keyspace grows to 2,048 rows: dense again
    gets(keys[::11])
    cmds([[b"SYSTEM", b"DIGEST"], [b"SYSTEM", b"DIGEST", b"TYPES"]])
    assert calls == ["_drain_g_dense", "_drain_pn_dense", "_drain_g_dense"]
    for name in ("GCOUNT", "PNCOUNT"):
        assert (pdb.manager(name).repo.dump_state()
                == jdb.manager(name).repo.dump_state())
    assert pdb.manager("GCOUNT").repo._key_cap == 2048


def test_signed_value_wraps_like_the_reference():
    repo = rc.RepoPNCOUNT(IDENTITY, device="cpu")
    out = bytearray()
    r = tresp.Respond(out.extend)
    repo.apply(r, [b"DEC", b"k", b"%d" % U64])
    repo.apply(r, [b"GET", b"k"])
    repo.converge(b"k", ({5: U64}, {6: 3}))
    repo.apply(r, [b"GET", b"k"])
    # -(2^64-1) wraps to 1; then (2^64-1) - (2^64-1+3) = -3
    assert bytes(out) == b"+OK\r\n:1\r\n:-3\r\n"


@pytest.mark.parametrize("name", ["GCOUNT", "PNCOUNT"])
def test_own_counter_wrap_inside_a_drain_window_matches_jax(name):
    """An own counter that wraps past 2^64 is not a lattice move: the
    drain joins the window's largest own value, so GET serves the
    wrapped sum until a drain and the pre-wrap value after it. The JAX
    package does the same, and the port keeps parity with it."""
    jrepo = getattr(jrc, f"Repo{name}")(IDENTITY, mesh=None, engine="python")
    trepo = getattr(rc, f"Repo{name}")(IDENTITY, device="cpu")
    jout, tout = bytearray(), bytearray()
    for repo, out in ((jrepo, jout), (trepo, tout)):
        r = (jresp if repo is jrepo else tresp).Respond(out.extend)
        repo.apply(r, [b"INC", b"k", b"5"])
        repo.apply(r, [b"INC", b"k", b"%d" % U64])
        repo.apply(r, [b"GET", b"k"])
        repo.dump_state()  # drains the window
        repo.apply(r, [b"GET", b"k"])
    assert bytes(tout) == bytes(jout) == b"+OK\r\n+OK\r\n:4\r\n:5\r\n"
    assert trepo.dump_state() == jrepo.dump_state()


def test_database_routes_counters_and_renders_help():
    db = tdb.Database(1, device="cpu")
    out = bytearray()
    r = tresp.Respond(out.extend)
    db.apply(r, [b"GCOUNT", b"INC", b"a", b"2"])
    db.apply(r, [b"GCOUNT", b"GET", b"a"])
    db.apply(r, [b"ZSET", b"GET", b"a"])  # no such data type
    db.apply(r, [b"PNCOUNT", b"INC", b"a"])
    text = bytes(out)
    assert text.startswith(b"+OK\r\n:2\r\n-BADCOMMAND (could not parse command)\n")
    assert b"The first word of each command must be a data type." in text
    assert text.endswith(
        b"This operation expects the arguments in the following form:\n"
        b"PNCOUNT INC key value\r\n"
    )
    assert isinstance(db.manager("PNCOUNT").repo._state, pncount.PNCountState)
    assert isinstance(db.manager("GCOUNT").repo._state, gcount.GCountState)


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdb.Database(1)
    with pytest.raises(RuntimeError):
        tdb.Database(1, device="cuda:0")


def test_async_path_offloads_drains_and_shuts_down():
    async def drive():
        db = tdb.Database(1, device="cpu")
        out = bytearray()
        r = tresp.Respond(out.extend)
        await db.apply_async(r, [b"GCOUNT", b"INC", b"k", b"4"])
        await db.converge_async("GCOUNT", [(b"k", {9: 10}), (b"j", {9: 1})])
        assert db.manager("GCOUNT").repo.may_drain([b"GET", b"k"])
        sent = []
        db.flush_deltas(sent.append)
        await asyncio.gather(
            db.apply_async(r, [b"GCOUNT", b"GET", b"k"]),
            db.apply_async(r, [b"GCOUNT", b"GET", b"j"]),
        )
        db.stop_intake()
        await db.apply_async(r, [b"GCOUNT", b"GET", b"k"])
        await db.clean_shutdown_async()
        return bytes(out), sent

    out, sent = asyncio.run(drive())
    assert out == (
        b"+OK\r\n:14\r\n:1\r\n"
        b"-SHUTDOWN (server is shutting down, rejecting all requests)\r\n"
    )
    # the SYSTEM log's delta ships on every flush, empty or not
    # (repo_system.pony:21, kept by both packages)
    log = ("SYSTEM", [(b"_log", ([], 0))])
    assert sent == [("GCOUNT", [(b"k", {1: 4})]), log, log]
