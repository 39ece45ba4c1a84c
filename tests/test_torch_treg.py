"""Parity of the port's TREG (ops/treg.py, models/repo_treg.py) with the JAX
package's, on the CPU.

The same numpy-seeded inputs go through the JAX functions and the port's
plain PyTorch versions (the path every CPU tensor takes); the bit
patterns must be equal (tolerance 0: an integer lattice). Timestamps and
ranks are drawn from pools that hold values >= 2^63 and repeat, so
every stage of the select sees equal and unsigned-ordered operands, and
vids include -1 (unset). The repo streams compare reply bytes, flushed
deltas, dumped state, the mirror cache and the device planes (through
convert.py) across the dense, sparse and tie-patch drains, keyspace
growth and interner compaction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jylis_tpu.models import repo_treg as jrt
from jylis_tpu.ops import interner as jint
from jylis_tpu.ops import planes as jplanes
from jylis_tpu.ops import treg as jtreg
from jylis_tpu.server import resp as jresp
from jylis_tpu_torch import convert
from jylis_tpu_torch import parallel as tpar
from jylis_tpu_torch.models import repo_treg as rt
from jylis_tpu_torch.ops import interner, planes, treg
from jylis_tpu_torch.ops.staging import DensePlan, Stage
from jylis_tpu_torch.server import resp as tresp
from jylis_tpu_torch.utils.batching import pad_rows

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

K, B = 64, 16
SEEDS = [0, 1, 2]
U64 = (1 << 64) - 1
TS_POOL = np.array([0, 1, 7, 1 << 63, (1 << 63) + 5, U64, U64 - 1], np.uint64)


def draw_u64(rng, n):
    """Half from a small pool (equal values, >= 2^63), half uniform."""
    pool = TS_POOL[rng.integers(0, len(TS_POOL), n)]
    uni = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    return np.where(rng.random(n) < 0.7, pool, uni).astype(np.uint64)


def draw_reg(rng, n):
    """(ts, rank, vid) planes: an unset register is (0, 0, -1)."""
    ts, rank = draw_u64(rng, n), draw_u64(rng, n)
    vid = rng.integers(-1, 4, n).astype(np.int32)
    unset = vid < 0
    ts[unset & (rng.random(n) < 0.5)] = 0
    rank[unset] = 0
    return ts, rank, vid


def jax_state(ts, rank, vid):
    return jtreg.TRegState(*(jnp.asarray(p) for p in (
        *jplanes.split64_np(ts), *jplanes.split64_np(rank), vid.copy()
    )))


def port_state(ts, rank, vid):
    return convert.treg_from_jax(
        *jplanes.split64_np(ts), *jplanes.split64_np(rank), vid, "cpu"
    )


def jax_planes(state):
    return tuple(np.asarray(p) for p in state)


def assert_same_state(port, jax):
    for got, want in zip(convert.treg_to_jax(port), jax_planes(jax)):
        assert np.array_equal(got, want)


def deltas(ts, rank, vid):
    return (planes.to_tensor(ts, "cpu"), planes.to_tensor(rank, "cpu"),
            torch.from_numpy(vid.copy()))


# ---- ops ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("live", [B, 11, 0])
def test_converge_batch_and_sparse_drain_match_jax(seed, live):
    rng = np.random.default_rng(seed)
    st = draw_reg(rng, K)
    ki = pad_rows(B)
    ki[:live] = rng.choice(K, size=live, replace=False)
    d = draw_reg(rng, B)
    # half the live slots copy their row's ts and rank: ties and the
    # presence tie-break
    same = rng.random(B) < 0.5
    for i in np.flatnonzero(same[:live]):
        d[0][i], d[1][i] = st[0][ki[i]], st[1][ki[i]]
    dj = (*jplanes.split64_np(d[0]), *jplanes.split64_np(d[1]), d[2])
    jst, jtie = jtreg.converge_batch(jax_state(*st), ki, *dj)
    tst = port_state(*st)
    tst, tie = treg.converge_batch(tst, torch.from_numpy(ki), *deltas(*d))
    assert_same_state(tst, jst)
    assert np.array_equal(tie.numpy()[:live], np.asarray(jtie)[:live])
    assert not tie[live:].any()  # pads: 0 (JAX clamps their gathers)
    if seed == 0 and live == B:
        assert tie.any() and not tie.all()
    # the repo's sparse drain: the gathered winners after the join
    jres = jrt._drain(jax_state(*st), ki, *dj)
    tie2, out_ts, out_vid = rt._drain(
        port_state(*st), torch.from_numpy(ki), *deltas(*d)
    )
    jts = jplanes.combine64_np(np.asarray(jres[2]), np.asarray(jres[3]))
    assert np.array_equal(planes.to_u64_np(out_ts)[:live], jts[:live])
    assert np.array_equal(out_vid.numpy()[:live], np.asarray(jres[4])[:live])
    assert np.array_equal(tie2.numpy(), tie.numpy())
    assert not out_ts[live:].any() and not out_vid[live:].any()


@pytest.mark.parametrize("seed", SEEDS)
def test_converge_dense_and_dense_drain_match_jax(seed):
    rng = np.random.default_rng(seed + 10)
    st = draw_reg(rng, K)
    d = draw_reg(rng, K)
    copy = rng.random(K) < 0.4
    d[0][copy], d[1][copy] = st[0][copy], st[1][copy]
    ident = rng.random(K) < 0.2  # rows with no delta carry the identity
    d[0][ident], d[1][ident], d[2][ident] = 0, 0, -1
    dj = (*jplanes.split64_np(d[0]), *jplanes.split64_np(d[1]), d[2])
    jst, jtie = jtreg.converge_dense(jax_state(*st), *dj)
    tst, tie = treg.converge_dense(port_state(*st), *deltas(*d))
    assert_same_state(tst, jst)
    assert np.array_equal(tie.numpy(), np.asarray(jtie))
    assert tie.any() and not tie[ident].any()
    # the repo's dense drain: JAX's on the whole planes (identity rows
    # included), the port's on the staged compact batch of the other
    # rows, in no order
    jres = jrt._drain_dense(jax_state(*st), *dj)
    rows = rng.permutation(np.flatnonzero(~ident)).astype(np.int32)
    plan = DensePlan(port_state(*st))
    (ki, *dd), out = staged(rows, *(x[rows] for x in d))
    full, got = rt._drain_dense(plan, ki, *dd, out)
    assert got is out and full is plan.full
    assert_same_state(plan.state, jres[0])
    assert np.array_equal(full.numpy(), np.asarray(jres[1]))
    jts = jplanes.combine64_np(np.asarray(jres[2]), np.asarray(jres[3]))
    assert np.array_equal(out[0].numpy(), np.asarray(jres[1])[rows])
    assert np.array_equal(planes.to_u64_np(out[1]), jts[rows])
    assert np.array_equal(out[2].numpy(), np.asarray(jres[4])[rows])
    assert plan.slots is None  # TREG's drain runs in slot order, with no map


def staged(rows, ts, rank, vid):
    """A compact TREG batch in a CPU Stage's views, as the repo stages it:
    (the uploaded (rows, ts, rank, vid), the (tie, ts, vid) output
    views)."""
    stage = Stage("cpu")
    b = len(rows)
    fields = [(np.int32, ()), (np.uint64, ()), (np.uint64, ()), (np.int32, ())]
    for view, a in zip(stage.host_in(b, fields), (rows, ts, rank, vid)):
        view[...] = a
    return stage.upload(), tuple(stage.device_out(b, OUTS))


OUTS = ((np.bool_, ()), (np.int64, ()), (np.int32, ()))


def whole_reg(rows, d, k):
    """The JAX package's delta planes for a compact batch: ``d``'s
    registers at ``rows``, the identity (0, 0, -1) elsewhere."""
    ts, rank = np.zeros(k, np.uint64), np.zeros(k, np.uint64)
    vid = np.full(k, -1, np.int32)
    ts[rows], rank[rows], vid[rows] = d
    return (*jplanes.split64_np(ts), *jplanes.split64_np(rank), vid)


def test_dense_drain_slot_map_stays_clean_across_a_raise_and_a_grow(monkeypatch):
    """A keyspace's dense TREG drains (parallel.drain_unrouted_treg with
    dense=True, the repo's path) at B = K / 4 and K, unsorted, row K - 1
    among them, a third of the deltas tying their row, against JAX's
    whole-plane drain: slot outputs, every key's tie flag (the last
    call's only) and states equal after each call, and no slot map (the
    TREG drain runs in slot order); a call that raises leaves the next
    right; after ``grow``, the same at the new capacity."""
    rng = np.random.default_rng(31)
    st = draw_reg(rng, K)
    ks = tpar.Keyspace(None, "cpu")
    ks.place(port_state(*st))
    js = jax_state(*st)

    def batch(b, k):
        rows = rng.permutation(k)[:b].astype(np.int32)
        if k - 1 not in rows:
            rows[0] = k - 1
        d = draw_reg(rng, b)
        cur = [planes.to_u64_np(ks.parts[0].ts), planes.to_u64_np(ks.parts[0].rank)]
        tie = rng.random(b) < 1 / 3
        d[0][tie], d[1][tie] = cur[0][rows[tie]], cur[1][rows[tie]]
        return rows, d

    def drain(rows, d, k):
        nonlocal js
        got = tpar.drain_unrouted_treg(ks, rows, tpar.fill_from(*d), rt._drain_dense,
                                       dense=True)
        jres = jrt._drain_dense(js, *whole_reg(rows, d, k))
        js = jres[0]
        jts = jplanes.combine64_np(np.asarray(jres[2]), np.asarray(jres[3]))
        assert np.array_equal(got[0], np.asarray(jres[1])[rows])
        assert np.array_equal(got[1].view(np.uint64), jts[rows])
        assert np.array_equal(got[2], np.asarray(jres[4])[rows])
        assert np.array_equal(ks.dense_plan().full.numpy(), np.asarray(jres[1]))
        assert_same_state(ks.parts[0], js)
        assert ks.slots is None
        return got

    for b in (K // 4, K):
        assert drain(*batch(b, K), K)[0].any()

    rows, d = batch(K // 2, K)
    wins = treg._b_wins

    def fail(*a):
        raise RuntimeError("injected failure in the join")

    monkeypatch.setattr(treg, "_b_wins", fail)
    with pytest.raises(RuntimeError, match="injected"):
        tpar.drain_unrouted_treg(ks, rows, tpar.fill_from(*d), rt._drain_dense, dense=True)
    assert ks.slots is None
    monkeypatch.setattr(treg, "_b_wins", wins)
    drain(rows, d, K)

    ks.grow(lambda s: treg.grow(s, 2 * K))
    js = jtreg.grow(js, 2 * K)
    assert ks.dense_plan().state.vid.shape == (2 * K,)
    drain(*batch(2 * K, 2 * K), 2 * K)


@pytest.mark.parametrize("seed", SEEDS)
def test_converge_many_set_batch_and_read_match_jax(seed):
    rng = np.random.default_rng(seed + 20)
    n = 3
    st = draw_reg(rng, K)
    ki = np.stack([pad_rows(B) for _ in range(n)])
    for i in range(n):
        ki[i, :12] = rng.choice(K, 12, replace=False)
    ds = [draw_reg(rng, B) for _ in range(n)]
    d_ts = np.stack([d[0] for d in ds])
    d_rank = np.stack([d[1] for d in ds])
    d_vid = np.stack([d[2] for d in ds])
    jst, jtie = jtreg.converge_many(
        jax_state(*st), ki, *jplanes.split64_np(d_ts),
        *jplanes.split64_np(d_rank), d_vid,
    )
    tst, tie = treg.converge_many(
        port_state(*st), torch.from_numpy(ki), planes.to_tensor(d_ts, "cpu"),
        planes.to_tensor(d_rank, "cpu"), torch.from_numpy(d_vid),
    )
    assert_same_state(tst, jst)
    assert np.array_equal(tie.numpy()[:, :12], np.asarray(jtie)[:, :12])
    # set_batch is converge_batch
    d = draw_reg(rng, B)
    ki1 = ki[0].copy()
    jst2, _ = jtreg.set_batch(
        jst, ki1, *jplanes.split64_np(d[0]), *jplanes.split64_np(d[1]), d[2]
    )
    tst2, _ = treg.set_batch(tst, torch.from_numpy(ki1), *deltas(*d))
    assert_same_state(tst2, jst2)
    rows = rng.choice(K, 10, replace=False).astype(np.int32)
    jth, jtl, jv = jtreg.read(jst2, rows)
    ts, vid = treg.read(tst2, torch.from_numpy(rows))
    assert np.array_equal(
        planes.to_u64_np(ts),
        jplanes.combine64_np(np.asarray(jth), np.asarray(jtl)),
    )
    assert np.array_equal(vid.numpy(), np.asarray(jv))


def test_grow_init_and_convert_roundtrip_match_jax():
    rng = np.random.default_rng(5)
    st = draw_reg(rng, 48)
    assert_same_state(treg.grow(port_state(*st), 200),
                      jtreg.grow(jax_state(*st), 200))
    assert_same_state(treg.init(33, "cpu"), jtreg.init(33))
    p = port_state(*st)
    assert treg.grow(p, 48) is p
    back = convert.treg_to_jax(p)
    again = convert.treg_from_jax(*back, "cpu")
    for x, y in zip(p, again):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()


def test_prefix_rank_and_interner_compaction_match_jax():
    rng = np.random.default_rng(9)
    vals = [bytes(rng.integers(0, 256, int(rng.integers(0, 12)), np.uint8))
            for _ in range(300)]
    vals += [b"\x80" + b"x" * 9, b"\xff" * 8 + b"a", b"\xff" * 8 + b"b", b""]
    assert [interner.prefix_rank(v) for v in vals] == [
        jint.prefix_rank(v) for v in vals
    ]
    ti, ji = interner.Interner(), jint.Interner()
    assert list(ti.intern_many(vals)) == list(ji.intern_many(vals))
    live = [int(x) for x in rng.choice(len(ti), 40)]
    assert np.array_equal(ti.compact(live), ji.compact(live))
    assert [ti.lookup(i) for i in range(len(ti))] == [
        ji.lookup(i) for i in range(len(ji))
    ]
    assert np.array_equal(ti.ranks_for(np.arange(-1, len(ti))),
                          ji.ranks_for(np.arange(-1, len(ji))))


# ---- the repo -----------------------------------------------------------------

PREFIXES = [b"", b"\x80prefix!", b"shared8b", b"\xffzzzzzzz"]


def value(rng) -> bytes:
    """Values that often share their 8-byte prefix (device ties), start
    with bytes >= 0x80 (ranks >= 2^63), or are short."""
    pre = PREFIXES[int(rng.integers(len(PREFIXES)))]
    tail = bytes(rng.integers(0, 256, int(rng.integers(0, 4)), np.uint8))
    return pre + tail


def ts_of(rng) -> int:
    return int(TS_POOL[int(rng.integers(len(TS_POOL)))]) if rng.random() < 0.6 \
        else int(rng.integers(0, 1 << 64, dtype=np.uint64))


def run_stream(seed, n_keys, n_ops, weights):
    """One seeded command/delta stream into both repos; every reply, flush
    and the final dump, mirror cache and device planes compared."""
    rng = np.random.default_rng(seed)
    keys = [b"key%d" % i for i in range(n_keys)]
    jrepo = jrt.RepoTREG(1, mesh=None, engine="python")
    trepo = rt.RepoTREG(1, device="cpu")
    jout, tout = bytearray(), bytearray()
    jr, tr = jresp.Respond(jout.extend), tresp.Respond(tout.extend)
    ops = ["SET", "GET", "CONV", "BULK", "DRAIN", "FLUSH"]
    w = np.asarray(weights, float)
    for _ in range(n_ops):
        op = ops[rng.choice(len(ops), p=w / w.sum())]
        key = keys[int(rng.integers(n_keys))]
        if op in ("SET", "GET"):
            args = [op.encode(), key]
            if op == "SET":
                args += [value(rng), b"%d" % ts_of(rng)]
            jrepo.apply(jr, list(args))
            trepo.apply(tr, list(args))
        elif op == "CONV":
            d = (value(rng), ts_of(rng))
            jrepo.converge(key, d)
            trepo.converge(key, d)
        elif op == "BULK":
            # one replica sweep over a third of the keyspace: dense drain
            for i in rng.choice(n_keys, max(1, n_keys // 3), replace=False):
                d = (value(rng), ts_of(rng))
                jrepo.converge(keys[i], d)
                trepo.converge(keys[i], d)
        elif op == "DRAIN":
            jrepo.drain()
            trepo.drain()
        else:
            assert trepo.flush_deltas() == jrepo.flush_deltas()
        assert bytes(tout) == bytes(jout), op
    for k in keys:
        jrepo.apply(jr, [b"GET", k])
        trepo.apply(tr, [b"GET", k])
    assert bytes(tout) == bytes(jout)
    assert trepo.flush_deltas() == jrepo.flush_deltas()
    assert trepo.dump_state() == jrepo.dump_state()
    assert trepo._cache == jrepo._cache
    assert trepo._key_cap == jrepo._key_cap
    assert_same_state(trepo._state, jrepo._state)
    assert len(trepo._interner) == len(jrepo._interner)
    return trepo, jrepo, bytes(tout)


@pytest.fixture
def drains(monkeypatch):
    """Which device steps the port's repo ran, in order."""
    calls = []
    for fn in ("_drain", "_drain_dense", "_patch_vids"):
        orig = getattr(rt, fn)
        monkeypatch.setattr(
            rt, fn, lambda *a, _o=orig, _n=fn: calls.append(_n) or _o(*a)
        )
    return calls


@pytest.mark.parametrize("seed,n_keys,n_ops,weights,steps", [
    # sparse drains and prefix ties patched on the host
    (0, 12, 400, [4, 4, 3, 0, 0.6, 0.4], {"_drain", "_patch_vids"}),
    # bulk sweeps over a quarter of the keyspace or more: dense drains
    (1, 900, 150, [3, 3, 2, 0.5, 0.6, 0.3],
     {"_drain", "_drain_dense", "_patch_vids"}),
    # the keyspace grows past 2048
    (2, 2100, 80, [1, 1, 1, 1.5, 1, 0.3],
     {"_drain", "_drain_dense", "_patch_vids"}),
])
def test_command_and_delta_stream_matches_jax(drains, seed, n_keys, n_ops,
                                              weights, steps):
    trepo, _j, out = run_stream(seed, n_keys, n_ops, weights)
    assert b"*2\r\n" in out and b"$-1\r\n" in out
    assert trepo._state.vid.device.type == "cpu"
    assert set(drains) == steps
    if n_keys > 2048:
        assert trepo._key_cap == 4096


def test_interner_compaction_matches_jax(monkeypatch):
    """Overwrites with fresh values strand interner ids; past
    2 x live + COMPACT_SLACK the drain compacts and replaces the vid
    plane. Both packages must remap identically (run_stream compares
    the cache, the vid plane and the interner's size). The slack is
    lowered in both packages alike so a short stream compacts often."""
    monkeypatch.setattr(rt, "COMPACT_SLACK", 256)
    monkeypatch.setattr(jrt, "COMPACT_SLACK", 256)
    compactions = []
    orig = interner.Interner.compact
    monkeypatch.setattr(
        interner.Interner, "compact",
        lambda self, live: compactions.append(1) or orig(self, live),
    )
    trepo, jrepo, _ = run_stream(3, 40, 3000, [6, 0.2, 2, 0, 2, 0.1])
    assert len(compactions) >= 2
    assert len(trepo._interner) < 2 * 40 + 256 + 40
    assert [trepo._interner.lookup(i) for i in range(len(trepo._interner))] == [
        jrepo._interner.lookup(i) for i in range(len(jrepo._interner))
    ]


def test_database_dense_drains_match_jax(monkeypatch):
    """A port Database on the CPU and a JAX Database take one TREG stream
    that forces the dense drain twice: SETs and foreign deltas at 700 of
    the 1,024 rows (>= K / 4, ts >= 2^63), a drain, then foreign deltas at
    600 rows, a third of them at their row's ts under another value with
    the same 8-byte prefix (prefix ties the host settles, half of them won
    by the delta), GETs, SYSTEM DIGEST, a sparse round. Replies, digests,
    dumps and the mirror caches must be equal, and the port's dense
    wrapper must have run."""
    from jylis_tpu.models.database import Database as JaxDatabase
    from jylis_tpu_torch.models import database as tdb

    calls = []
    for fn in ("_drain", "_drain_dense", "_patch_vids"):
        orig = getattr(rt, fn)
        monkeypatch.setattr(rt, fn, lambda *a, _o=orig, _n=fn: calls.append(_n) or _o(*a))
    rng = np.random.default_rng(29)
    keys = [b"key%d" % i for i in range(800)]
    jdb = JaxDatabase(identity=1, engine="python")
    pdb = tdb.Database(1, device="cpu")
    jout, tout = bytearray(), bytearray()
    jr, tr = jresp.Respond(jout.extend), tresp.Respond(tout.extend)
    held = {}

    def cmds(lines):
        for line in lines:
            jdb.apply(jr, list(line))
            pdb.apply(tr, list(line))
        assert bytes(tout) == bytes(jout)

    def conv(batch):
        for k, (v, ts) in batch:
            if (ts, v) > held.get(k, (-1, b"")):
                held[k] = (ts, v)
        jdb.converge_deltas(("TREG", list(batch)))
        pdb.converge("TREG", list(batch))

    def dump_and_compare():
        jrepo, prepo = jdb.manager("TREG").repo, pdb.manager("TREG").repo
        assert prepo.dump_state() == jrepo.dump_state()
        assert prepo._cache == jrepo._cache

    cmds([[b"TREG", b"SET", k, b"local%d" % i, b"%d" % ts_of(rng)]
          for i, k in enumerate(keys[:100])])
    conv([(k, (b"prefix%02d-%d" % (i % 7, i), (1 << 63) + i % 5))
          for i, k in enumerate(keys[:700])])
    dump_and_compare()
    assert calls == ["_drain_dense"]
    batch = []
    for i, k in enumerate(keys[100:700]):
        ts, v = held[k]
        if i % 3 == 0:  # the same 8-byte prefix at the same ts
            batch.append((k, (v[:8] + (b"~" if i % 2 else b"!") + v[8:], ts)))
        else:
            batch.append((k, (value(rng), ts_of(rng))))
    conv(batch)
    cmds([[b"TREG", b"GET", k] for k in keys[:800:3]] + [[b"SYSTEM", b"DIGEST"]])
    dump_and_compare()
    assert calls == ["_drain_dense", "_drain_dense", "_patch_vids"]
    conv([(k, (value(rng), ts_of(rng))) for k in keys[700:800]])
    cmds([[b"TREG", b"GET", k] for k in keys[690:800]]
         + [[b"SYSTEM", b"DIGEST"], [b"SYSTEM", b"DIGEST", b"TYPES"]])
    dump_and_compare()
    assert calls[-1] == "_drain" and calls.count("_drain_dense") == 2


def test_set_threshold_drain_and_database_routing():
    """A SET that fills the pending window drains inline (sync path) in
    both packages; the Database serves TREG, TLOG, UJSON and TENSOR beside
    the counters, in the JAX registry's order."""
    from jylis_tpu_torch.models import database as tdb

    jrepo = jrt.RepoTREG(1, mesh=None, engine="python")
    trepo = rt.RepoTREG(1, device="cpu")
    jout, tout = bytearray(), bytearray()
    for i in range(rt.PENDING_DRAIN_THRESHOLD):
        args = [b"SET", b"k%d" % i, b"v%d" % (i % 7), b"%d" % (i * 977)]
        assert trepo.may_drain(args) == jrepo.may_drain(args)
        jrepo.apply(jresp.Respond(jout.extend), args)
        trepo.apply(tresp.Respond(tout.extend), args)
    assert trepo._tbl.pend_count() == jrepo._tbl.pend_count() == 0
    assert trepo._cache == jrepo._cache and len(trepo._cache) == 4096
    assert_same_state(trepo._state, jrepo._state)
    assert bytes(tout) == bytes(jout)
    db = tdb.Database(1, device="cpu")
    out = bytearray()
    r = tresp.Respond(out.extend)
    db.apply(r, [b"TREG", b"SET", b"a", b"x", b"3"])
    db.apply(r, [b"TREG", b"GET", b"a"])
    db.apply(r, [b"TREG", b"SET", b"a", b"x"])
    assert bytes(out).startswith(
        b"+OK\r\n*2\r\n$1\r\nx\r\n:3\r\n-BADCOMMAND (could not parse command)\n"
        b"This operation expects the arguments in the following form:\n"
        b"TREG SET key value timestamp\r\n"
    )
    assert [m.decode() for m in db._map] == [
        "TREG", "TLOG", "GCOUNT", "PNCOUNT", "UJSON", "TENSOR", "MAP", "BCOUNT", "SYSTEM"]
