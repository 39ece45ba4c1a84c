"""The staged, unrouted sparse drains against the JAX package's routed
drains, on the CPU.

The port's counter and TREG repos drain through
``parallel.drain_unrouted_g`` / ``_pn`` / ``_treg``: the batch's global
rows go to each card as they are (the kernels find each slot's shard in
the card's shard table, ops/staging.py), with one staged copy in, one
launch and one copy out per card, and every result comes back at its
slot's index. The JAX package routes instead (``route_drain`` pads every
shard to one power-of-two width) and drains each shard
(``drain_sharded_g`` / ``_pn`` / ``_treg``). The same seeded rows and
deltas go through both, and every comparison is exact (tolerance 0:
integer lattices): the per-slot results in slot order and the gathered
state after each batch.

* u64 state and deltas over the full range (half of them >= 2^63, so
  the sums wrap); TREG timestamps and ranks from a pool of repeats, so
  the select meets ties, and unset registers;
* 1, 2, 4 and 8 shards, all on one card (one table, no routing at all)
  or spread over several "cards" (on the CPU a card is a device name,
  ``cpu:i``: the shards on one name form one table, and the host orders
  the slots by card with one counting pass);
* batches with a shard that gets no slot, every slot in one shard, and
  a single slot;
* the repos: a mesh drain makes one staged copy per card and direction,
  hands each card only its own slots (no pads), and never routes.
"""

import functools

import numpy as np
import pytest
import torch

import jylis_tpu  # noqa: F401
from jylis_tpu import parallel as jpar
from jylis_tpu.ops import planes as jplanes
from jylis_tpu_torch import parallel as tpar
from jylis_tpu_torch.models import repo_counters as rc
from jylis_tpu_torch.models import repo_treg as rt
from jylis_tpu_torch.ops import gcount, pncount, staging, treg
from jylis_tpu_torch.ops.staging import ShardTable, Stage
from jylis_tpu_torch.parallel import sharded as tsharded

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

U64 = (1 << 64) - 1
TS_POOL = np.array([0, 1, 7, 1 << 63, (1 << 63) + 5, U64], np.uint64)
K, R = 64, 8

# (shards, the device of each shard): "one" puts every shard on one
# card; "each" gives every shard its own; "pairs" two shards a card;
# "single" is a single-device keyspace (no mesh)
LAYOUTS = {
    "single-1": (1, None),
    "one-1": (1, ["cpu"]),
    "one-2": (2, ["cpu"] * 2),
    "each-2": (2, ["cpu:0", "cpu:1"]),
    "one-4": (4, ["cpu"] * 4),
    "pairs-4": (4, ["cpu:0", "cpu:0", "cpu:1", "cpu:1"]),
    "one-8": (8, ["cpu"] * 8),
    "each-8": (8, [f"cpu:{i}" for i in range(8)]),
}


@functools.lru_cache(maxsize=None)
def jmesh(n):
    return jpar.make_mesh(n)


def keyspace(layout, state):
    n, devs = LAYOUTS[layout]
    mesh = None if devs is None else tpar.make_mesh(n, devices=devs)
    ks = tpar.Keyspace(mesh, "cpu")
    ks.place(state)
    return ks


def u64(rng, shape):
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def batches(rng, n):
    """Row batches: random rows; rows that leave shard 1 empty (with
    more than one shard); every row in the last shard; a single row."""
    shard_of = np.arange(K) // (K // n)
    yield rng.choice(K, int(rng.integers(2, K // 2)), replace=False)
    if n > 1:
        yield rng.permutation(np.flatnonzero(shard_of != 1))[:K // 3]
    yield rng.permutation(np.flatnonzero(shard_of == n - 1))
    yield rng.choice(K, 1)


def jax_order(rows, slots):
    """For each of our slots, its routed slot on the JAX side."""
    at = {int(r): j for j, r in enumerate(slots) if r >= 0}
    return np.array([at[int(r)] for r in rows], np.int64)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("pn", [False, True], ids=["gcount", "pncount"])
def test_unrouted_counter_drains_match_jax(layout, pn):
    n = LAYOUTS[layout][0]
    rng = np.random.default_rng(len(layout) * 7 + pn)
    pols = [u64(rng, (K, R)) for _ in range(1 + pn)]
    mod = pncount if pn else gcount
    ks = keyspace(layout, mod.from_counts(*pols, device="cpu"))
    jm = jmesh(n)
    jst = [jpar.shard_plane(jm, x) for p in pols for x in jplanes.split64_np(p)]
    for rows in batches(rng, n):
        rows = rows.astype(np.int64)
        deltas = u64(rng, (len(rows), R * (1 + pn)))
        cols = [deltas[:, i * R:(i + 1) * R] for i in range(1 + pn)]
        if pn:
            sums = tpar.drain_unrouted_pn(ks, rows, tpar.fill_from(*cols))
        else:
            sums = tpar.drain_unrouted_g(ks, rows, tpar.fill_from(*cols))
        jlr, dh, dl, slots = jpar.route_drain(rows, deltas, n, K // n)
        *jst, jsums = (jpar.drain_sharded_pn if pn else jpar.drain_sharded_g)(
            jm, *jst, jlr, dh, dl)
        jsums = np.asarray(jsums)
        assert sums.dtype == np.int64 and len(sums) == len(rows)
        np.testing.assert_array_equal(sums.view(np.uint64),
                                      jsums.view(np.uint64)[jax_order(rows, slots)])
        got = mod.to_counts(ks.whole())
        for g, (h, lo) in zip(got if pn else (got,), zip(jst[::2], jst[1::2])):
            np.testing.assert_array_equal(
                g, jplanes.combine64_np(np.asarray(h), np.asarray(lo)))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unrouted_treg_drain_matches_jax(layout):
    n = LAYOUTS[layout][0]
    rng = np.random.default_rng(len(layout) * 11)
    ts = TS_POOL[rng.integers(0, len(TS_POOL), K)]
    rank = TS_POOL[rng.integers(0, len(TS_POOL), K)]
    vid = rng.integers(-1, 40, K).astype(np.int32)
    ts[vid < 0], rank[vid < 0] = 0, 0
    ks = keyspace(layout, treg.TRegState(
        torch.from_numpy(ts.view(np.int64).copy()),
        torch.from_numpy(rank.view(np.int64).copy()), torch.from_numpy(vid.copy())))
    jm = jmesh(n)
    jst = [jpar.shard_vec(jm, x) for x in (
        *jplanes.split64_np(ts), *jplanes.split64_np(rank), vid.copy())]
    ties = 0
    for rows in batches(rng, n):
        rows = rows.astype(np.int64)
        b = len(rows)
        d_ts = TS_POOL[rng.integers(0, len(TS_POOL), b)]
        d_rank = TS_POOL[rng.integers(0, len(TS_POOL), b)]
        d_vid = rng.integers(0, 50, b).astype(np.int32)
        same = rng.random(b) < 1 / 3  # a third copy their row's ts and rank
        cur = ks.whole()
        d_ts[same] = cur.ts.numpy().view(np.uint64)[rows[same]]
        d_rank[same] = cur.rank.numpy().view(np.uint64)[rows[same]]
        tie, out_ts, out_vid = tpar.drain_unrouted_treg(
            ks, rows, tpar.fill_from(d_ts, d_rank, d_vid))
        payload = np.stack([d_ts, d_rank, d_vid.astype(np.uint64)], 1)
        jlr, dh, dl, slots = jpar.route_drain(rows, payload, n, K // n)
        jout = jpar.drain_sharded_treg(jm, *jst, jlr, dh, dl)
        jst = list(jout[:5])
        at = jax_order(rows, slots)
        assert tie.dtype == np.bool_ and out_ts.dtype == np.int64 and out_vid.dtype == np.int32
        np.testing.assert_array_equal(tie, np.asarray(jout[5])[at])
        np.testing.assert_array_equal(
            out_ts.view(np.uint64),
            jplanes.combine64_np(np.asarray(jout[6]), np.asarray(jout[7]))[at])
        np.testing.assert_array_equal(out_vid, np.asarray(jout[8])[at])
        whole = ks.whole()
        np.testing.assert_array_equal(whole.ts.numpy().view(np.uint64),
                                      jplanes.combine64_np(*map(np.asarray, jst[:2])))
        np.testing.assert_array_equal(whole.rank.numpy().view(np.uint64),
                                      jplanes.combine64_np(*map(np.asarray, jst[2:4])))
        np.testing.assert_array_equal(whole.vid.numpy(), np.asarray(jst[4]))
        ties += int(tie.sum())
    assert ties > 0


def test_staged_layout_and_buffer_reuse():
    """Regions start 16-byte aligned; the buffers grow by powers of two
    and are reused; the views write through to what the step reads."""
    regions, total = staging.layout(3, [(np.int32, ()), (np.uint64, (2,)), (np.uint64, (2,))])
    assert [o for o, _, _ in regions] == [0, 16, 64] and total == 112
    st = Stage("cpu")
    ri, p = st.host_in(3, [(np.int32, ()), (np.uint64, (2,))])
    ri[...] = [5, 6, 7]
    p[...] = [[1, U64], [3, 4], [5, 6]]
    buf = st._bufs["host_in"]
    assert buf.numel() == 4096
    ki, d = st.upload()
    assert ki.dtype == torch.int32 and ki.tolist() == [5, 6, 7]
    assert d.dtype == torch.int64 and d.shape == (3, 2) and d[0, 1].item() == -1
    st.host_in(600, [(np.int32, ()), (np.uint64, (2,))])
    assert st._bufs["host_in"].numel() == 16384  # 2,400 + 9,600 bytes, bucketed
    st.host_in(3, [(np.int32, ()), (np.uint64, (2,))])
    assert st._bufs["host_in"].numel() == 16384  # kept, not shrunk


@pytest.mark.parametrize("layout", ["single-1", "pairs-4"])
def test_a_drain_past_the_staging_cap_runs_in_rounds(monkeypatch, layout):
    """Past MAX_STAGE_BYTES a card's slots go in staged calls of at most
    ``max_slots`` each: the sums and the state are those of one call,
    and no buffer grows past the cap."""
    rng = np.random.default_rng(11)
    p, n = u64(rng, (K, R)), u64(rng, (K, R))
    rows = rng.permutation(K)
    fill = tpar.fill_from(u64(rng, (K, R)), u64(rng, (K, R)))
    whole = keyspace(layout, pncount.from_counts(p, n, "cpu"))
    want = tpar.drain_unrouted_pn(whole, rows, fill)
    monkeypatch.setattr(staging, "MAX_STAGE_BYTES", 4096)
    fields = [(np.int32, ()), (np.uint64, (R,)), (np.uint64, (R,))]
    width = staging.max_slots(fields)
    assert width == (4096 - 48) // (4 + 16 * R)
    ks = keyspace(layout, pncount.from_counts(p, n, "cpu"))
    per_card = [sum(1 for r in rows if f <= r // ks.rows_per_shard < f + c)
                for f, c in ks.cards]
    u0 = Stage.uploads
    got = tpar.drain_unrouted_pn(ks, rows, fill)
    assert Stage.uploads - u0 == sum(-(-m // width) for m in per_card) > len(per_card)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(ks.whole(), whole.whole()):
        assert torch.equal(a, b)
    assert all(b.numel() <= 4096 for st in ks.stages for b in st._bufs.values())
    over = next(b for b in range(width, 4 * width) if staging.layout(b, fields)[1] > 4096)
    with pytest.raises(ValueError, match="at most 4096"):
        ks.stages[0].host_in(over, fields)


def test_one_split_rule_for_tables_and_keyspaces():
    """ShardTable.split (the plain versions') and Keyspace.split_rows
    (the repos' host patches) are one rule: unsigned 32-bit rows, shard
    g // rows_per_shard, local g % rows_per_shard; rows in no shard of
    the table are in none."""
    ks = keyspace("one-4", gcount.init(K, R, "cpu"))
    rows = np.array([0, 17, 63, 16, 40, 33], np.int64)
    got = [(int(part.counts.data_ptr()), sel.tolist(), local.tolist())
           for part, sel, local in ks.split_rows(rows)]
    want = [(int(ks.parts[s].counts.data_ptr()),
             [j for j, r in enumerate(rows) if r // 16 == s],
             [int(r % 16) for r in rows if r // 16 == s]) for s in range(4)]
    assert got == want
    table = ShardTable(ks.parts[1:3], 16, first=1)
    ki = torch.tensor([17, -1, 40, 2**31 - 1, 3, 47], dtype=torch.int32)
    assert [(sel.tolist(), local.tolist()) for _, sel, local in table.split(ki)] == [
        ([0], [1]), ([2, 5], [8, 15])]


def test_shard_table_holds_one_to_eight_shards():
    st = gcount.init(8, 2, "cpu")
    with pytest.raises(ValueError, match="1 to 8"):
        ShardTable([st] * 9, 8)
    with pytest.raises(ValueError):
        ShardTable([], 8)
    ks = keyspace("one-8", gcount.init(64, 2, "cpu"))
    assert [len(t.parts) for t in ks.tables()] == [8]
    mesh = tpar.make_mesh(16, devices=["cpu"] * 16)
    ks16 = tpar.Keyspace(mesh, "cpu")
    ks16.init(64, lambda n, d: gcount.init(n, 2, d))
    with pytest.raises(ValueError, match="1 to 8"):
        tpar.drain_unrouted_g(ks16, np.array([3]), tpar.fill_from(np.ones((1, 2), np.uint64)))


def test_unrouted_drain_refuses_rows_outside_the_keyspace():
    ks = keyspace("one-4", gcount.init(K, R, "cpu"))
    with pytest.raises(ValueError, match="rows must lie"):
        tpar.drain_unrouted_g(ks, np.array([K]), tpar.fill_from(np.ones((1, R), np.uint64)))


def test_a_single_device_state_is_a_table_of_one_shard():
    """The old call (a state, padded rows) still reads 0 at pad and
    negative slots; a table with a first shard > 0 takes only its rows."""
    rng = np.random.default_rng(3)
    p = u64(rng, (16, 4))
    st = gcount.from_counts(p, "cpu")
    ki = torch.tensor([3, 2**31 - 1, -1, 0], dtype=torch.int32)
    d = torch.from_numpy(u64(rng, (4, 4)).view(np.int64))
    sums = gcount.drain_sparse(st, ki, d)
    assert sums[1:3].tolist() == [0, 0] and sums[0].item() != 0
    part = gcount.from_counts(p[8:], "cpu")
    out = torch.full((4,), 77, dtype=torch.int64)
    rows = torch.tensor([3, 9, 15, 8], dtype=torch.int32)
    gcount.drain_sparse(ShardTable([part], 8, first=1), rows, d, out)
    assert out[0].item() == 77  # row 3 is shard 0's: nothing written
    want = np.maximum(p[[9, 15, 8]], d.numpy()[1:].view(np.uint64)).sum(1, dtype=np.uint64)
    np.testing.assert_array_equal(out[1:].numpy().view(np.uint64), want)


# ---- the repos' mesh drains ------------------------------------------------------


@pytest.fixture
def no_routing(monkeypatch):
    """Any routing call fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the unrouted drain routed its batch")

    for mod, name in ((tpar, "route_drain"), (tsharded, "route_drain"),
                      (tsharded, "_route")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(tsharded.Keyspace, "route", refuse)


def spy_steps(monkeypatch, mod, name):
    """Each launch step's batch size, card by card."""
    sizes = []
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda t, ki, *a: sizes.append(
        (t.first, len(t.parts), int(ki.shape[0]))) or orig(t, ki, *a))
    return sizes


@pytest.mark.parametrize("layout", ["one-4", "pairs-4", "each-8"])
@pytest.mark.parametrize("name", ["GCOUNT", "PNCOUNT", "TREG"])
def test_a_repo_mesh_drain_stages_once_per_card(monkeypatch, no_routing, layout, name):
    n, devs = LAYOUTS[layout]
    mesh = tpar.make_mesh(n, devices=devs)
    rng = np.random.default_rng(n)
    if name == "TREG":
        repo, single = rt.RepoTREG(1, device="cpu", mesh=mesh), rt.RepoTREG(1, device="cpu")
        steps = spy_steps(monkeypatch, rt, "_drain")
    else:
        cls = getattr(rc, f"Repo{name}")
        repo, single = cls(1, device="cpu", mesh=mesh), cls(1, device="cpu")
        steps = spy_steps(monkeypatch, rc, "_drain_g" if name == "GCOUNT" else "_drain_pn")
    keys = [b"k%04d" % i for i in rng.choice(900, 600, replace=False)]
    for key in keys:
        if name == "TREG":  # a prefix shared at equal ts: ties the host settles
            d = (b"prefix00" + b"%d" % rng.integers(0, 9), int(rng.integers(0, 3)))
        elif name == "GCOUNT":
            d = {7: int(rng.integers(1, 1 << 64, dtype=np.uint64))}
        else:
            d = ({7: int(rng.integers(1, 1 << 63))}, {9: int(rng.integers(1, 1 << 63))})
        for r in (repo, single):
            r.converge(key, d)
    u0, d0 = Stage.uploads, Stage.downloads
    repo.drain()
    rows = np.asarray([repo._tbl.find(k) for k in keys])
    rps = repo._ks.rows_per_shard
    cards = {int(repo._ks.card_of[r // rps]) for r in rows}
    assert Stage.uploads - u0 == len(cards) and Stage.downloads - d0 == len(cards)
    by_card = [(f, c) for f, c in repo._ks.cards]
    want = sorted((f, c, int(sum((rows // rps >= f) & (rows // rps < f + c))))
                  for f, c in by_card)
    assert sorted(steps) == [w for w in want if w[2]]  # only live slots, per card
    single.drain()
    assert repo.dump_state() == single.dump_state()
