"""Parity of the port's lattice ops (jylis_tpu_torch.ops) with the JAX
package's, on the CPU.

The same numpy-seeded inputs go through the JAX function and the port's
plain PyTorch version (the path every CPU tensor takes); the bit patterns
must be equal (tolerance 0: these are integer lattices). Counter values
are uniform u64, so half are >= 2^63 and row sums wrap past 2^64. The
TENSOR join is also held against the Pallas kernel it ports, run in
interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from jylis_tpu.models import repo_counters as jrc
from jylis_tpu.ops import gcount as jg
from jylis_tpu.ops import planes as jplanes
from jylis_tpu.ops import pncount as jpn
from jylis_tpu.ops import tensor as jt
from jylis_tpu_torch import convert
from jylis_tpu_torch import parallel as tpar
from jylis_tpu_torch.models import repo_counters as rc
from jylis_tpu_torch.ops import gcount, planes, pncount, staging, tensor
from jylis_tpu_torch.ops.staging import DensePlan, Stage
from jylis_tpu_torch.utils.batching import pad_rows

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

K, R, B = 64, 8, 16
SEEDS = [0, 1, 2]


def u64(rng, shape):
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def t64(x):
    """u64 ndarray -> the port's int64 bit-pattern tensor on the CPU."""
    return planes.to_tensor(x, "cpu")


def bits(t):
    return planes.to_u64_np(t)


def batch_rows(rng, live):
    """(B,) int32: ``live`` unique real rows, then distinct pad rows."""
    ki = pad_rows(B)
    ki[:live] = rng.choice(K, size=live, replace=False)
    return ki


def wraps(counts):
    """Some row's true sum exceeds 2^64 (so the test sees wrapping)."""
    return any(sum(int(v) for v in row) >= 1 << 64 for row in counts)


# ---- host helpers and unsigned order ------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_split_combine_roundtrip_and_jax_layout(seed):
    x = u64(np.random.default_rng(seed), (K, R))
    hi, lo = planes.split64_np(x)
    jhi, jlo = jplanes.split64_np(x)
    assert np.array_equal(hi, jhi) and np.array_equal(lo, jlo)
    assert np.array_equal(planes.combine64_np(hi, lo), x)
    assert np.array_equal(bits(t64(x)), x)


@pytest.mark.parametrize("seed", SEEDS)
def test_join_max_is_unsigned(seed):
    rng = np.random.default_rng(seed)
    a, b = u64(rng, (K, R)), u64(rng, (K, R))
    assert np.array_equal(bits(planes.join_max(t64(a), t64(b))), np.maximum(a, b))
    ahi, alo = jplanes.split64_np(a)
    bhi, blo = jplanes.split64_np(b)
    jhi, jlo = jplanes.join_max(ahi, alo, bhi, blo)
    want = jplanes.combine64_np(np.asarray(jhi), np.asarray(jlo))
    assert np.array_equal(bits(planes.join_max(t64(a), t64(b))), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_rowsum64_wraps_like_jax(seed):
    x = u64(np.random.default_rng(seed), (K, R))
    assert wraps(x)
    want = np.asarray(jplanes.rowsum64(*map(jnp.asarray, jplanes.split64_np(x))))
    assert np.array_equal(bits(planes.rowsum64(t64(x))), want)


# ---- GCOUNT ------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_gcount_join(seed):
    rng = np.random.default_rng(seed)
    a, b = u64(rng, (K, R)), u64(rng, (K, R))
    want = jg.to_counts(jg.join(jg.from_counts(a), jg.from_counts(b)))
    got = gcount.to_counts(
        gcount.join(gcount.from_counts(a, "cpu"), gcount.from_counts(b, "cpu"))
    )
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("live", [0, 5, B])
def test_gcount_converge_batch_with_pad_rows(seed, live):
    rng = np.random.default_rng(seed)
    s, d = u64(rng, (K, R)), u64(rng, (B, R))
    ki = batch_rows(rng, live)
    want = jg.to_counts(
        jg.converge_batch(jg.from_counts(s), jnp.asarray(ki), *map(jnp.asarray, jplanes.split64_np(d)))
    )
    st = gcount.converge_batch(gcount.from_counts(s, "cpu"), torch.from_numpy(ki), t64(d))
    assert np.array_equal(gcount.to_counts(st), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_gcount_read_and_read_all(seed):
    rng = np.random.default_rng(seed)
    s = u64(rng, (K, R))
    assert wraps(s)
    ki = rng.choice(K, size=B, replace=False).astype(np.int32)
    js, st = jg.from_counts(s), gcount.from_counts(s, "cpu")
    assert np.array_equal(
        bits(gcount.read(st, torch.from_numpy(ki))), np.asarray(jg.read(js, jnp.asarray(ki)))
    )
    assert np.array_equal(bits(gcount.read_all(st)), np.asarray(jg.read_all(js)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gcount_increment(seed):
    rng = np.random.default_rng(seed)
    s = u64(rng, (K, R))
    ki = rng.choice(K, size=B, replace=False).astype(np.int32)
    ri = rng.integers(0, R, B).astype(np.int32)
    amt = u64(rng, (B,))
    want = jg.to_counts(
        jg.increment(jg.from_counts(s), jnp.asarray(ki), jnp.asarray(ri), jnp.asarray(amt))
    )
    st = gcount.increment(
        gcount.from_counts(s, "cpu"), torch.from_numpy(ki), torch.from_numpy(ri), t64(amt)
    )
    assert np.array_equal(gcount.to_counts(st), want)


@pytest.mark.parametrize("k2,r2", [(K, R), (2 * K, R), (K, 2 * R), (4 * K, 4 * R)])
def test_gcount_grow(k2, r2):
    s = u64(np.random.default_rng(3), (K, R))
    want = jg.to_counts(jg.grow(jg.from_counts(s), k2, r2))
    got = gcount.to_counts(gcount.grow(gcount.from_counts(s, "cpu"), k2, r2))
    assert np.array_equal(got, want)


# ---- PNCOUNT -----------------------------------------------------------------


def pn_jax(p, n):
    return jpn.from_counts(p, n)


def pn_jax_counts(st):
    return (
        jplanes.combine64_np(np.asarray(st.p_hi), np.asarray(st.p_lo)),
        jplanes.combine64_np(np.asarray(st.n_hi), np.asarray(st.n_lo)),
    )


def assert_pn_equal(st, want):
    p, n = pncount.to_counts(st)
    assert np.array_equal(p, want[0]) and np.array_equal(n, want[1])


@pytest.mark.parametrize("seed", SEEDS)
def test_pncount_join(seed):
    rng = np.random.default_rng(seed)
    a = u64(rng, (K, R)), u64(rng, (K, R))
    b = u64(rng, (K, R)), u64(rng, (K, R))
    want = pn_jax_counts(jpn.join(pn_jax(*a), pn_jax(*b)))
    assert_pn_equal(
        pncount.join(pncount.from_counts(*a, "cpu"), pncount.from_counts(*b, "cpu")), want
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("live", [0, 5, B])
def test_pncount_converge_batch_with_pad_rows(seed, live):
    rng = np.random.default_rng(seed)
    p, n = u64(rng, (K, R)), u64(rng, (K, R))
    dp, dn = u64(rng, (B, R)), u64(rng, (B, R))
    ki = batch_rows(rng, live)
    want = pn_jax_counts(
        jpn.converge_batch(
            pn_jax(p, n), jnp.asarray(ki),
            *map(jnp.asarray, jplanes.split64_np(dp)),
            *map(jnp.asarray, jplanes.split64_np(dn)),
        )
    )
    st = pncount.converge_batch(
        pncount.from_counts(p, n, "cpu"), torch.from_numpy(ki), t64(dp), t64(dn)
    )
    assert_pn_equal(st, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_pncount_signed_read_and_read_all(seed):
    rng = np.random.default_rng(seed)
    p, n = u64(rng, (K, R)), u64(rng, (K, R))
    ki = rng.choice(K, size=B, replace=False).astype(np.int32)
    js, st = pn_jax(p, n), pncount.from_counts(p, n, "cpu")
    got = pncount.read(st, torch.from_numpy(ki)).numpy()
    want = np.asarray(jpn.read(js, jnp.asarray(ki)))
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want) and (want < 0).any() and (want > 0).any()
    assert np.array_equal(pncount.read_all(st).numpy(), np.asarray(jpn.read_all(js)))


@pytest.mark.parametrize("seed", SEEDS)
def test_pncount_increment_decrement(seed):
    rng = np.random.default_rng(seed)
    p, n = u64(rng, (K, R)), u64(rng, (K, R))
    ki = rng.choice(K, size=B, replace=False).astype(np.int32)
    ri = rng.integers(0, R, B).astype(np.int32)
    amt = u64(rng, (B,))
    args_j = (jnp.asarray(ki), jnp.asarray(ri), jnp.asarray(amt))
    args_t = (torch.from_numpy(ki), torch.from_numpy(ri), t64(amt))
    want = pn_jax_counts(jpn.decrement(jpn.increment(pn_jax(p, n), *args_j), *args_j))
    st = pncount.decrement(pncount.increment(pncount.from_counts(p, n, "cpu"), *args_t), *args_t)
    assert_pn_equal(st, want)


@pytest.mark.parametrize("k2,r2", [(K, R), (2 * K, 2 * R)])
def test_pncount_grow(k2, r2):
    rng = np.random.default_rng(4)
    p, n = u64(rng, (K, R)), u64(rng, (K, R))
    want = pn_jax_counts(jpn.grow(pn_jax(p, n), k2, r2))
    assert_pn_equal(pncount.grow(pncount.from_counts(p, n, "cpu"), k2, r2), want)


# ---- the four drains against jylis_tpu.models.repo_counters -------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("live", [1, 11, B])
def test_sparse_drains_match_jax(seed, live):
    """Live slots only: JAX clamps the pad-slot gather (its pad sums are
    row K-1's), the port writes 0 there, and the repos read live slots."""
    rng = np.random.default_rng(seed)
    p, n = u64(rng, (K, R)), u64(rng, (K, R))
    dp, dn = u64(rng, (B, R)), u64(rng, (B, R))
    ki = batch_rows(rng, live)

    js, jsums = jrc._drain_g(jg.from_counts(p), jnp.asarray(ki), *jplanes.split64_np(dp))
    st = gcount.from_counts(p, "cpu")
    sums = rc._drain_g(st, torch.from_numpy(ki), t64(dp))
    assert np.array_equal(gcount.to_counts(st), jg.to_counts(js))
    assert np.array_equal(bits(sums)[:live], np.asarray(jsums)[:live])
    assert not sums[live:].any()

    js, jsums = jrc._drain_pn(
        pn_jax(p, n), jnp.asarray(ki), *jplanes.split64_np(dp), *jplanes.split64_np(dn)
    )
    st = pncount.from_counts(p, n, "cpu")
    sums = rc._drain_pn(st, torch.from_numpy(ki), t64(dp), t64(dn))
    assert_pn_equal(st, pn_jax_counts(js))
    assert np.array_equal(sums.numpy()[:live], np.asarray(jsums)[:live])
    assert not sums[live:].any()


def dense_rows(rng, b: int, k: int = K) -> np.ndarray:
    """``b`` unique rows of ``k`` in no order, row k - 1 among them."""
    rows = rng.permutation(k)[:b].astype(np.int32)
    if k - 1 not in rows:
        rows[int(rng.integers(b))] = k - 1
    return rows


def whole(rows, d, k: int = K) -> np.ndarray:
    """The JAX package's delta plane for a compact batch: ``d``'s rows at
    ``rows``, zeros (the identity) everywhere else."""
    plane = np.zeros((k,) + d.shape[1:], d.dtype)
    plane[rows] = d
    return plane


def staged(arrays, outs):
    """A compact batch (the rows first, then one array per field) written
    into a CPU Stage's views as the repos stage it: (the uploaded
    tensors, the output views, one per field of ``outs``)."""
    stage = Stage("cpu")
    fields = [(a.dtype, a.shape[1:]) for a in arrays]
    for view, a in zip(stage.host_in(len(arrays[0]), fields), arrays):
        view[...] = a
    return stage.upload(), stage.device_out(len(arrays[0]), outs)


SUMS = ((np.int64, ()),)


@pytest.mark.parametrize("seed", SEEDS)
def test_dense_drains_match_jax(seed):
    """The port's dense drains on a staged compact batch (B = K / 4 and
    B = K, unsorted unique rows, row K - 1 among them) against JAX's on
    the same batch expanded to whole planes: the joined state, every
    row's sum and the slots' sums, and the slot map clean after."""
    rng = np.random.default_rng(seed)
    p, n = u64(rng, (K, R)), u64(rng, (K, R))
    for b in (K // 4, K):
        rows = dense_rows(rng, b)
        dp, dn = u64(rng, (b, R)), u64(rng, (b, R))

        js, jsums = jrc._drain_g_dense(jg.from_counts(p), *jplanes.split64_np(whole(rows, dp)))
        plan = DensePlan(gcount.from_counts(p, "cpu"))
        (ki, d), (out,) = staged((rows, dp), SUMS)
        full, got = rc._drain_g_dense(plan, ki, d, out)
        assert got is out and full is plan.full
        assert np.array_equal(gcount.to_counts(plan.state), jg.to_counts(js))
        assert np.array_equal(bits(full), np.asarray(jsums))
        assert np.array_equal(bits(out), np.asarray(jsums)[rows])
        assert (plan.slots.map == -1).all() and not plan.slots.dirty
        assert wraps(jg.to_counts(js))

        js, jsums = jrc._drain_pn_dense(
            pn_jax(p, n), *jplanes.split64_np(whole(rows, dp)),
            *jplanes.split64_np(whole(rows, dn)))
        plan = DensePlan(pncount.from_counts(p, n, "cpu"))
        (ki, dpt, dnt), (out,) = staged((rows, dp, dn), SUMS)
        full, _ = rc._drain_pn_dense(plan, ki, dpt, dnt, out)
        assert_pn_equal(plan.state, pn_jax_counts(js))
        assert np.array_equal(full.numpy(), np.asarray(jsums))
        assert np.array_equal(out.numpy(), np.asarray(jsums)[rows])
        assert (plan.slots.map == -1).all() and not plan.slots.dirty


def test_dense_drain_slot_map_stays_clean_across_a_raise_and_a_grow(monkeypatch):
    """A keyspace's dense PNCOUNT drains (parallel.drain_unrouted_pn with
    dense=True, the repos' path) against JAX's whole-plane drain: the map
    is clean after a call; a call that raises after the scatter leaves it
    dirty and the next call refills it and joins as JAX does; after
    ``grow`` the keyspace holds a clean map of the new capacity, and a
    drain over every row, row 2K - 1 among them, matches."""
    rng = np.random.default_rng(41)
    p, n = u64(rng, (K, R)), u64(rng, (K, R))
    ks = tpar.Keyspace(None, "cpu")
    ks.place(pncount.from_counts(p, n, "cpu"))
    js = pn_jax(p, n)

    def drain(rows, dp, dn, k):
        fill = tpar.fill_from(dp, dn)
        got = tpar.drain_unrouted_pn(ks, rows, fill, rc._drain_pn_dense, dense=True)
        nonlocal js
        js, jsums = jrc._drain_pn_dense(
            js, *jplanes.split64_np(whole(rows, dp, k)),
            *jplanes.split64_np(whole(rows, dn, k)))
        assert np.array_equal(got, np.asarray(jsums)[rows])
        assert np.array_equal(ks.dense_plan().full.numpy(), np.asarray(jsums))
        assert_pn_equal(ks.parts[0], pn_jax_counts(js))
        assert (ks.slots.map == -1).all() and not ks.slots.dirty

    rows = dense_rows(rng, K // 4)
    drain(rows, u64(rng, (K // 4, R)), u64(rng, (K // 4, R)), K)

    rows = dense_rows(rng, K // 2)
    dp, dn = u64(rng, (K // 2, R)), u64(rng, (K // 2, R))
    join = planes.join_max

    def fail(*a):
        raise RuntimeError("injected failure after the scatter")

    monkeypatch.setattr(planes, "join_max", fail)
    with pytest.raises(RuntimeError, match="injected"):
        tpar.drain_unrouted_pn(ks, rows, tpar.fill_from(dp, dn), rc._drain_pn_dense,
                               dense=True)
    assert ks.slots.dirty and (ks.slots.map >= 0).sum() == K // 2
    monkeypatch.setattr(planes, "join_max", join)
    drain(rows, dp, dn, K)

    ks.grow(lambda st: pncount.grow(st, 2 * K, R))
    assert ks.slots.map.shape == (2 * K,) and (ks.slots.map == -1).all()
    jp, jn = pn_jax_counts(js)
    js = pn_jax(np.concatenate([jp, np.zeros_like(jp)]),
                np.concatenate([jn, np.zeros_like(jn)]))
    rows = dense_rows(rng, 2 * K, 2 * K)
    drain(rows, u64(rng, (2 * K, R)), u64(rng, (2 * K, R)), 2 * K)


def test_dense_drain_in_staged_rounds_matches_jax(monkeypatch):
    """A dense batch larger than one Stage runs as several staged calls,
    each one dense drain: the same state and sums as JAX's one drain."""
    rng = np.random.default_rng(42)
    p = u64(rng, (K, R))
    ks = tpar.Keyspace(None, "cpu")
    ks.place(gcount.from_counts(p, "cpu"))
    rows = dense_rows(rng, K)
    d = u64(rng, (K, R))
    # room for 20 slots of (row, R counters) a call: K = 64 slots in 4 calls
    monkeypatch.setattr(staging, "MAX_STAGE_BYTES", 20 * (4 + 8 * R) + 2 * staging.ALIGN)
    calls = []
    step = lambda *a: calls.append(1) or rc._drain_g_dense(*a)  # noqa: E731
    ups = staging.Stage.uploads
    got = tpar.drain_unrouted_g(ks, rows, tpar.fill_from(d), step, dense=True)
    js, jsums = jrc._drain_g_dense(jg.from_counts(p), *jplanes.split64_np(whole(rows, d)))
    assert len(calls) == staging.Stage.uploads - ups == 4
    assert np.array_equal(got.view(np.uint64), np.asarray(jsums)[rows])
    assert np.array_equal(gcount.to_counts(ks.parts[0]), jg.to_counts(js))
    assert (ks.slots.map == -1).all()


# ---- TENSOR ------------------------------------------------------------------

TN, TD = 2048, 8  # (N*D) / 128 = 128 rows: one Pallas block


def tensor_planes(rng):
    """bench.py's delta shape (random val bits incl. NaN/negative
    patterns, zero ts_hi, ts_lo in [0, 4), rid in [0, 8)), with some
    ts_hi set so the hi stage is exercised too."""
    shape = (TN, TD)
    b = rng.integers(0, 1 << 32, size=(4,) + shape, dtype=np.uint32)
    return (b[0], b[1] & (b[1] > 0xF0000000), b[2] & 3, b[3] & 7)


@pytest.mark.parametrize("seed", SEEDS)
def test_okey_matches_jax(seed):
    u = np.random.default_rng(seed).integers(0, 1 << 32, size=4096, dtype=np.uint32)
    u[:4] = [0, 0x7FC00000, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(jt._okey(jnp.asarray(u)))
    got = tensor._okey(torch.from_numpy(u.view(np.int32))).numpy().view(np.uint32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_join_dense_matches_jax_and_pallas(seed):
    rng = np.random.default_rng(seed)
    a, b = tensor_planes(rng), tensor_planes(rng)
    want = jt.join_dense(
        jt.TensorState(*map(jnp.asarray, a)), jt.TensorState(*map(jnp.asarray, b))
    )
    want = [np.asarray(x) for x in want]
    pallas = bench._pallas_tensor_join()(
        jt.TensorState(*map(jnp.asarray, a)),
        jt.TensorState(*map(jnp.asarray, b)),
        interpret=True,
    )
    assert all(np.array_equal(np.asarray(x), w) for x, w in zip(pallas, want))
    st = tensor.join_dense(convert.tensor_from_jax(*a, device="cpu"),
                           convert.tensor_from_jax(*b, device="cpu"))
    got = convert.tensor_to_jax(st)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    # every lexicographic stage decided some cells
    assert not np.array_equal(got[0], a[0]) and not np.array_equal(got[0], b[0])


def test_tensor_init_is_the_jax_bottom():
    want = [np.asarray(x) for x in jt.init(4, 3)]
    got = convert.tensor_to_jax(tensor.init(4, 3, "cpu"))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert tensor.BOTTOM_BITS == jt.BOTTOM_BITS


# ---- carrying state across -----------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_convert_counters_both_ways(seed):
    rng = np.random.default_rng(seed)
    p, n = u64(rng, (K, R)), u64(rng, (K, R))
    js = jg.from_counts(p)
    st = convert.gcount_from_jax(np.asarray(js.hi), np.asarray(js.lo), device="cpu")
    assert np.array_equal(gcount.to_counts(st), p)
    hi, lo = convert.gcount_to_jax(st)
    assert np.array_equal(hi, np.asarray(js.hi)) and np.array_equal(lo, np.asarray(js.lo))

    jp = pn_jax(p, n)
    st = convert.pncount_from_jax(*(np.asarray(x) for x in jp), device="cpu")
    assert_pn_equal(st, (p, n))
    back = convert.pncount_to_jax(st)
    assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(back, jp))


@pytest.mark.parametrize("seed", SEEDS)
def test_convert_tensor_both_ways(seed):
    planes_u32 = tensor_planes(np.random.default_rng(seed))
    st = convert.tensor_from_jax(*planes_u32, device="cpu")
    assert all(p.dtype == torch.int32 for p in st)
    back = convert.tensor_to_jax(st)
    assert all(np.array_equal(x, y) for x, y in zip(back, planes_u32))
