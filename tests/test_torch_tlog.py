"""Parity of the port's TLOG ops (jylis_tpu_torch/ops/tlog.py) with the JAX
package's (jylis_tpu/ops/tlog.py), on the CPU.

The same numpy-seeded inputs go through the JAX functions and the port's
plain PyTorch versions (the path every CPU tensor takes), and the planes
must be equal bit for bit through convert.py (tolerance 0: an integer
lattice). States are built by JAX's own converge_batch from init, so
every row is canonical. Timestamps come from small pools, so deltas hold
duplicates inside themselves and against the state; wide cases draw ts
>= 2^32 and the extreme 2^64-1 (CLR's wrap). The port's drains leave
rows they flag as overflow untouched where JAX returns them merged and
truncated (and its caller discards them), so overflowed rows are checked
to be untouched, and the retry after ``grow`` is checked to land on
JAX's planes. Pad slots are compared on live slots only: the port
reports 0 there, JAX clamps its gathers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jylis_tpu.ops import tlog as jtlog
from jylis_tpu_torch import convert
from jylis_tpu_torch.ops import planes, tlog
from jylis_tpu_torch.utils.batching import pad_rows

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

K, L = 12, 16
U64 = (1 << 64) - 1
NOOP = tlog.TRIM_NOOP
NARROW_TS = np.arange(1, 40, dtype=np.uint64) * 3
WIDE_TS = np.array([0, 1, 5, (1 << 32) - 1, 1 << 32, (1 << 32) + 7, 1 << 40,
                    (1 << 63) + 3, U64 - 1, U64], np.uint64)


def to_port(js) -> tlog.TLogState:
    return convert.tlog_from_jax(
        None if js.nth is None else np.asarray(js.nth), np.asarray(js.ntl),
        np.asarray(js.nv), np.asarray(js.length), np.asarray(js.cutoff), "cpu")


def host(st):
    """Every plane of a state (either package's) as numpy, via the JAX
    layout."""
    if isinstance(st, tlog.TLogState):
        return convert.tlog_to_jax(st)
    return tuple(None if p is None else np.asarray(p) for p in st)


def assert_rows_equal(port, jax, rows=None):
    for got, want in zip(host(port), host(jax)):
        assert (got is None) == (want is None)
        if got is None:
            continue
        if rows is not None:
            got, want = got[rows], want[rows]
        assert np.array_equal(got, want)


def draw_delta(rng, n, ld, wide, live_frac=0.8):
    """(ts u64, vid int64, cutoff u64) delta rows: ts from a small pool
    (duplicates), vid -1 in some slots, a few raised cutoffs."""
    pool = WIDE_TS if wide else NARROW_TS
    ts = pool[rng.integers(0, len(pool), (n, ld))]
    vid = rng.integers(0, 5, (n, ld)).astype(np.int64)
    vid[rng.random((n, ld)) > live_frac] = -1
    cut = np.where(rng.random(n) < 0.25, pool[rng.integers(0, len(pool), n)], 0)
    return ts.astype(np.uint64), vid, cut.astype(np.uint64)


def t64(x):
    """A u64 or int64 ndarray as the port's int64 tensor (same bits)."""
    x = np.asarray(x)
    if x.dtype == np.uint64:
        return planes.to_tensor(x, "cpu")
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))


def canonical_state(rng, wide, rounds=3, k=K, length=L):
    """A JAX state filled by JAX's converge_batch (no overflow)."""
    js = jtlog.init(k, length, wide)
    for _ in range(rounds):
        ts, vid, cut = draw_delta(rng, k, 4, wide)
        new, ovf = jtlog.converge_batch(js, jnp.arange(k, dtype=jnp.int32),
                                        ts, vid, cut)
        if not np.asarray(ovf).any():
            js = new
    return js


def counts_of(rng, n):
    """Every kind of trim count: no-op sentinel, CLR, in range, above
    the length, negative."""
    kinds = np.array([NOOP, NOOP, 0, 1, 2, 3, 7, L, L + 5, -1, NOOP + 1])
    return kinds[rng.integers(0, len(kinds), n)].astype(np.int64)


# ---- the sparse drain ------------------------------------------------------------


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("seed", range(6))
def test_sparse_converge_then_trim_matches_jax(seed, wide):
    rng = np.random.default_rng(seed)
    js = canonical_state(rng, wide)
    ps = to_port(js)
    for step in range(5):
        b, ld = 8, int(rng.integers(1, 6))
        live = int(rng.integers(1, b + 1))
        ki = pad_rows(b)
        ki[:live] = rng.choice(K, live, replace=False)
        ts, vid, cut = draw_delta(rng, b, ld, wide)
        counts = counts_of(rng, b)
        jn, jovf = jtlog.converge_then_trim(js, ki, ts, vid, cut, ki, counts)
        ovf, out_len, out_cut = tlog.drain_sparse(
            ps, torch.from_numpy(ki), t64(ts), t64(vid), t64(cut), t64(counts))
        jovf = np.asarray(jovf)
        assert np.array_equal(ovf.numpy()[:live], jovf[:live])
        assert not ovf[live:].any() and not out_len[live:].any()
        assert not out_cut[live:].any()
        ok = ki[:live][~jovf[:live]]
        assert_rows_equal(ps, jn, ok)
        jl = np.asarray(jn.length)[ki[:live]]
        jc = np.asarray(jn.cutoff)[ki[:live]]
        okslot = ~jovf[:live]
        assert np.array_equal(out_len.numpy()[:live][okslot], jl[okslot])
        assert np.array_equal(planes.to_u64_np(out_cut)[:live][okslot], jc[okslot])
        if jovf.any():
            # flagged rows untouched; the retry on the grown state lands
            # on JAX's retry from its retained pre-merge state
            bad = ki[:live][jovf[:live]]
            assert_rows_equal(ps, js, bad)
            js = jtlog.grow(js, K, 2 * js.shape[1])
            ps = tlog.grow(ps, K, 2 * ps.shape[1])
            jn, jovf = jtlog.converge_then_trim(js, ki, ts, vid, cut, ki, counts)
            ovf, _, _ = tlog.drain_sparse(ps, torch.from_numpy(ki), t64(ts),
                                          t64(vid), t64(cut), t64(counts))
            assert not np.asarray(jovf)[:live].any() and not ovf.any()
        assert_rows_equal(ps, jn)
        js = jn


def test_duplicates_inside_the_delta_and_against_the_state():
    rng = np.random.default_rng(7)
    js = canonical_state(rng, False)
    ki = np.arange(4, dtype=np.int32)
    row = np.asarray(jtlog.read_row(js, 0)[0])
    ts = np.array([[900, 900, 900, 900, 1200, 1200]] * 4, np.uint64)
    ts[0, :2] = row[:2]  # entries the state already holds
    vid = np.array([[1, 1, 1, 2, 3, 3]] * 4, np.int64)
    vid[0, :2] = np.asarray(jtlog.read_row(js, 0)[1])[:2]
    cut = np.zeros(4, np.uint64)
    counts = np.full(4, NOOP, np.int64)
    jn, _ = jtlog.converge_then_trim(js, ki, ts, vid, cut, ki, counts)
    ps = to_port(js)
    tlog.drain_sparse(ps, torch.from_numpy(ki), t64(ts), t64(vid), t64(cut),
                      t64(counts))
    assert_rows_equal(ps, jn)
    # (900, 1), (900, 2), (1200, 3) join each row once
    got = np.asarray(jn.length)[1:4] - np.asarray(js.length)[1:4]
    assert got.tolist() == [3, 3, 3]


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_sparse_overflow_rule_is_merged_length_over_L(wide):
    """m_len > L flags (jylis_tpu/ops/tlog.py:275); m_len == L does not."""
    k, length = 4, 8
    ki = np.arange(k, dtype=np.int32)
    ts = np.tile(np.arange(1, 9, dtype=np.uint64), (k, 1))
    vid = np.full((k, 8), 1, np.int64)
    js = jtlog.converge_batch(jtlog.init(k, length, wide), ki, ts[:, :4],
                              vid[:, :4], np.zeros(k, np.uint64))[0]
    ps = to_port(js)
    before = host(ps)
    # rows 0/1 get 4 fresh entries (m = 8 = L), rows 2/3 get 5 (m = 9)
    fresh = ts[0, 4:]
    d_ts = np.stack([np.r_[fresh, 0], np.r_[fresh, 0], np.r_[fresh, 99],
                     np.r_[fresh, 98]]).astype(np.uint64)
    d_vid = np.full((k, 5), 2, np.int64)
    d_vid[:2, 4] = -1
    cut = np.zeros(k, np.uint64)
    jn, jovf = jtlog.converge_batch(js, ki, d_ts, d_vid, cut)
    ps2, ovf = tlog.converge_batch(ps, torch.from_numpy(ki), t64(d_ts),
                                   t64(d_vid), t64(cut))
    assert ps2 is ps
    assert ovf.tolist() == np.asarray(jovf).tolist() == [False, False, True, True]
    assert_rows_equal(ps, jn, [0, 1])
    for got, want in zip(host(ps), before):
        if got is not None:
            assert np.array_equal(got[2:], want[2:])


# ---- the dense drain -------------------------------------------------------------


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("seed", range(5))
def test_dense_converge_then_trim_and_tail_overflow_match_jax(seed, wide):
    rng = np.random.default_rng(100 + seed)
    js = canonical_state(rng, wide, rounds=int(rng.integers(1, 4)))
    ps = to_port(js)
    flagged = 0
    for step in range(4):
        ld = int(rng.integers(1, 9))
        ts, vid, cut = draw_delta(rng, K, ld, wide, live_frac=0.5)
        quiet = rng.random(K) < 0.3  # rows with no delta at all
        vid[quiet], cut[quiet] = -1, 0
        trim_ki = pad_rows(16)
        counts = np.full(16, NOOP, np.int64)
        trim_ki[0] = rng.integers(0, K)
        counts[0] = counts_of(rng, 1)[0]
        jn, jovf = jtlog.converge_then_trim(js, None, ts, vid, cut, trim_ki, counts)
        ovf = tlog.drain_dense(ps, t64(ts), t64(vid), t64(cut),
                               torch.from_numpy(trim_ki), t64(counts))
        jovf = np.asarray(jovf)
        # the conservative rule on EVERY row, delta or not
        assert np.array_equal(ovf.numpy(), jovf)
        assert np.array_equal(jovf, np.asarray(js.length) > js.shape[1] - ld)
        assert_rows_equal(ps, jn, np.flatnonzero(~jovf))
        if jovf.any():
            flagged += 1
            assert_rows_equal(ps, js, np.flatnonzero(jovf))
            js = jtlog.grow(js, K, 2 * js.shape[1])
            ps = tlog.grow(ps, K, 2 * ps.shape[1])
            jn, jovf = jtlog.converge_then_trim(js, None, ts, vid, cut,
                                                trim_ki, counts)
            ovf = tlog.drain_dense(ps, t64(ts), t64(vid), t64(cut),
                                   torch.from_numpy(trim_ki), t64(counts))
            assert np.array_equal(ovf.numpy(), np.asarray(jovf))
            assert_rows_equal(ps, jn, np.flatnonzero(~np.asarray(jovf)))
            if np.asarray(jovf).any():
                js, ps = jn, to_port(jn)  # JAX discards too: resync
                continue
        assert_rows_equal(ps, jn)
        js = jn
    if seed == 0:
        assert flagged


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_dense_and_sparse_paths_agree(wide):
    rng = np.random.default_rng(31)
    js = canonical_state(rng, wide, rounds=1, length=32)
    ts, vid, cut = draw_delta(rng, K, 6, wide)
    dense, sparse = to_port(js), to_port(js)
    ovf = tlog.converge_batch(dense, None, t64(ts), t64(vid), t64(cut))[1]
    ovf2 = tlog.converge_batch(sparse, torch.arange(K, dtype=torch.int32),
                               t64(ts), t64(vid), t64(cut))[1]
    assert not ovf.any() and not ovf2.any()
    assert_rows_equal(dense, sparse)
    assert_rows_equal(dense, jtlog.converge_batch(js, None, ts, vid, cut)[0])


# ---- the class boundaries of csrc/tlog_drain.cu ---------------------------------

SMEM_MAX = 232_448  # dynamic shared memory an H100 block may use


@pytest.mark.parametrize("b,length,ld,nplanes,kind,rpc,smem,grid,scratch,cluster", [
    # chip_smoke.py's shapes: config 4 (B = K = 16,384, L = 1,024; the
    # sparse rounds' Ld = 128, the dense ones' Ld = 64, and L = 512)
    (16384, 1024, 128, 2, "warp", 2, 19_456, 8192, 0, 1),
    (16384, 1024, 128, 3, "warp", 8, 114_688, 2048, 0, 1),
    (16384, 1024, 64, 2, "warp", 5, 44_800, 3277, 0, 1),
    (16384, 1024, 64, 3, "warp", 8, 106_496, 2048, 0, 1),
    (16384, 512, 64, 2, "warp", 5, 24_320, 3277, 0, 1),
    (16, 1024, 1, 2, "warp", 1, 8_576, 16, 0, 1),  # a socket TRIM
    (16, 1024, 1, 3, "warp", 1, 12_800, 16, 0, 1),
    # past shared memory: a cluster of 16, a CTA's share 4,096 delta and
    # 4,096 state slots
    (4, 65536, 65536, 3, "cluster", 1, 180_224, 64, 0, 16),
    (4, 65536, 65536, 2, "cluster", 1, 131_072, 64, 0, 16),
    (4096, 1024, 128, 3, "warp", 8, 114_688, 512, 0, 1),  # a mesh shard's launch
    (2048, 1024, 256, 2, "warp", 5, 56_320, 410, 0, 1),  # 8 delta entries a lane
    (2048, 1024, 257, 2, "cta", 1, 14_336, 2048, 0, 1),  # past a warp's registers
    # the crossovers (WARP_ROW_BYTES = 36 KiB) and one step past each
    (2048, 4416, 128, 2, "warp", 3, 110_592, 683, 0, 1),
    (2048, 4420, 128, 2, "cta", 1, 36_896, 2048, 0, 1),
    (2048, 2900, 128, 3, "warp", 3, 110_544, 683, 0, 1),
    (2048, 2904, 128, 3, "cta", 1, 36_896, 2048, 0, 1),
    (2048, 4512, 64, 2, "warp", 3, 110_592, 683, 0, 1),
    (2048, 4516, 64, 2, "cta", 1, 36_896, 2048, 0, 1),
    # the widest rows the CTA class takes (CTA_ROW_BYTES = SMEM_LIMIT) at
    # Ld = 1,024 and the next L: a cluster of 8 covers the card with 8 rows
    (8, 24064, 1024, 2, "cta", 1, 204_800, 8, 0, 1),
    (8, 24068, 1024, 2, "cluster", 1, 27_168, 64, 0, 8),
    (8, 15700, 1024, 3, "cta", 1, 204_784, 8, 0, 1),
    (8, 15704, 1024, 3, "cluster", 1, 27_664, 64, 0, 8),
    # a TRIM's drain of long rows (Ld = 1: a delta slot a CTA), a share
    # past 8 CTAs (16), and one past 16 (the shares in device scratch)
    (16, 65536, 1, 3, "cluster", 1, 98_336, 128, 0, 8),
    (2, 32768, 32768, 3, "cluster", 1, 180_224, 16, 0, 8),
    (4, 131072, 131072, 3, "cluster", 1, 0, 64, 23_068_672, 16),
])
def test_drain_plan_at_every_chip_shape_and_crossover(b, length, ld, nplanes, kind, rpc,
                                                     smem, grid, scratch, cluster):
    """drain_plan's class, rows a CTA, shared memory, grid and scratch at
    the shapes chip_smoke.py runs and at each crossover: the kernel's
    work buffers hold L + the delta's slots, a multiple of 4 per plane."""
    plan = tlog.drain_plan(b, length, ld, nplanes)
    r = plan.rows
    assert (r.kind, r.rows_per_cta, r.smem, r.grid, r.scratch, r.cluster) == (
        kind, rpc, smem, grid, scratch, cluster)
    assert r.smem <= SMEM_MAX and r.threads == (32 * rpc if kind == "warp" else 256)
    if kind == "cluster":
        # CTA q's share: delta slots [q * ldp, (q + 1) * ldp) (a power of
        # two), state slots [q * slice, (q + 1) * slice)
        p, pa = plan.ldp, plan.slice
        assert p & (p - 1) == 0 and p * cluster >= ld and pa % 4 == 0
        assert pa * cluster >= length and grid % cluster == 0
        share = 4 * (2 * nplanes * p + 2 * p + nplanes * pa)
        assert r.stride >= share and (scratch == grid * r.stride if scratch
                                      else smem == share <= SMEM_MAX)
        return
    assert plan.slice % 4 == 0 and plan.slice >= length + plan.ldp >= length + ld
    row_bytes = 4 * (nplanes * plan.slice + -(-plan.ldp // 4) * 4)  # + the bounds
    assert r.stride == row_bytes
    if kind == "warp":
        assert plan.ldp == 32 << plan.log_e and 0 <= plan.log_e <= 3
    if kind == "warp":
        assert r.smem == rpc * row_bytes <= tlog.WARP_ROW_BYTES * rpc


def port_state(rng, wide, k, length, rounds=3, ld=64):
    """A canonical state filled by the port's plain drain, and the same
    planes as a JAX state."""
    ps = tlog.init(k, length, wide, "cpu")
    ki = torch.arange(k, dtype=torch.int32)
    for _ in range(rounds):
        ts, vid, cut = draw_delta(rng, k, ld, wide)
        tlog.drain_sparse(ps, ki, t64(ts), t64(vid), t64(cut), t64(np.full(k, NOOP)))
    js = jtlog.TLogState(*(None if p is None else jnp.asarray(p)
                           for p in convert.tlog_to_jax(ps)))
    return ps, js


def drain_both(rng, ps, js, k, b, ld, wide):
    """One sparse drain with trims through JAX and the port: overflow
    flags equal, unflagged rows equal, flagged rows untouched."""
    live = b - 2
    ki = pad_rows(b)
    ki[:live] = rng.choice(k, live, replace=False)
    ts, vid, cut = draw_delta(rng, b, ld, wide)
    counts = counts_of(rng, b)
    before = host(ps)
    jn, jovf = jtlog.converge_then_trim(js, ki, ts, vid, cut, ki, counts)
    ovf, out_len, out_cut = tlog.drain_sparse(
        ps, torch.from_numpy(ki), t64(ts), t64(vid), t64(cut), t64(counts))
    jovf = np.asarray(jovf)[:live]
    assert np.array_equal(ovf.numpy()[:live], jovf)
    assert not ovf[live:].any() and not out_len[live:].any() and not out_cut[live:].any()
    ok, bad = ki[:live][~jovf], ki[:live][jovf]
    assert_rows_equal(ps, jn, ok)
    for got, want in zip(host(ps), before):
        if got is not None:
            assert np.array_equal(got[bad], want[bad])
    assert np.array_equal(out_len.numpy()[:live][~jovf], np.asarray(jn.length)[ok])
    assert np.array_equal(planes.to_u64_np(out_cut)[:live][~jovf],
                          np.asarray(jn.cutoff)[ok])
    return ovf


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("ld", [1, 31, 32, 33, 128])
def test_sparse_drain_matches_jax_where_ld_splits_the_kernel(ld, wide):
    """Ld = 1, 31 and 32 hold one delta entry a lane of the warp class,
    33 two, 128 four: the plain drain (the card tests' oracle) against
    JAX at each, rows of up to ~190 entries at L = 256, every kind of
    trim count."""
    rng = np.random.default_rng(40 + ld + wide)
    ps, js = port_state(rng, wide, K, 256)
    assert int(ps.length.max()) > 32
    drain_both(rng, ps, js, K, 8, ld, wide)


def warp_max_len(nplanes: int, ld: int, b: int = 2048) -> int:
    """The widest L (a multiple of 4) the warp class takes at Ld in a
    launch of b slots: its work buffer (nplanes x (L + 32 x E) u32 and
    32 x E ints) within WARP_ROW_BYTES."""
    wl = max(32, ld)
    length = (tlog.WARP_ROW_BYTES // 4 - wl) // nplanes - wl
    length -= length % 4
    assert tlog.drain_plan(b, length, ld, nplanes).rows.kind == "warp"
    assert tlog.drain_plan(b, length + 4, ld, nplanes).rows.kind == "cta"
    return length


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("step", [0, 4], ids=["at", "past"])
def test_sparse_drain_matches_jax_at_the_warp_cta_crossover(step, wide):
    """The widest L the warp class takes at Ld = 128, and the next: the
    plain drain against JAX there, both layouts."""
    length = warp_max_len(3 if wide else 2, 128) + step
    rng = np.random.default_rng(60 + step + wide)
    ps, js = port_state(rng, wide, 4, length, rounds=2, ld=128)
    drain_both(rng, ps, js, 4, 4, 128, wide)


# ---- trim, trimat, clear -------------------------------------------------------


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_trim_trimat_and_clear_match_jax(wide):
    rng = np.random.default_rng(55)
    js = canonical_state(rng, wide, rounds=4)
    ki = np.arange(K, dtype=np.int32)
    counts = np.array([0, 1, 2, 3, 5, 16, 17, -1, -5, NOOP, 4, 0], np.int64)
    jt = jtlog.trim_batch(js, ki, counts)
    pt = tlog.trim_batch(to_port(js), torch.from_numpy(ki), t64(counts))
    assert_rows_equal(pt, jt)
    pool = WIDE_TS if wide else NARROW_TS
    t = pool[rng.integers(0, len(pool), K)].astype(np.uint64)
    assert_rows_equal(tlog.trimat_batch(to_port(js), torch.from_numpy(ki), t64(t)),
                      jtlog.trimat_batch(js, ki, t))
    assert_rows_equal(tlog.clear_batch(to_port(js), torch.from_numpy(ki)),
                      jtlog.clear_batch(js, ki))
    # a trim row outside the drain's rows takes a second launch
    dk = np.array([1, 2], np.int32)
    ts, vid, cut = draw_delta(rng, 2, 3, wide)
    tk = np.array([5, 6], np.int32)
    jn = jtlog.converge_then_trim(js, dk, ts, vid, cut, tk, counts[:2])[0]
    pn = tlog.converge_then_trim(to_port(js), torch.from_numpy(dk), t64(ts),
                                 t64(vid), t64(cut), torch.from_numpy(tk),
                                 t64(counts[:2]))[0]
    assert_rows_equal(pn, jn)


def test_clr_at_the_largest_timestamp_wraps_to_zero():
    """CLR's target latest+1 wraps to 0 at 2^64-1, so the row keeps its
    entries and its cutoff (tlog.py trim_batch)."""
    ki = np.array([0, 1], np.int32)
    ts = np.array([[U64, 5], [U64 - 1, 5]], np.uint64)
    vid = np.array([[3, 4], [3, 4]], np.int64)
    js = jtlog.converge_batch(jtlog.init(2, 4, True), ki, ts, vid,
                              np.zeros(2, np.uint64))[0]
    jc = jtlog.clear_batch(js, ki)
    pc = tlog.clear_batch(to_port(js), torch.from_numpy(ki))
    assert_rows_equal(pc, jc)
    assert pc.length.tolist() == [2, 0]
    assert planes.to_u64_np(pc.cutoff).tolist() == [0, U64]


# ---- layout, growth, reads -------------------------------------------------------


def test_widen_grow_init_and_insert_match_jax():
    rng = np.random.default_rng(3)
    js = canonical_state(rng, False)
    assert_rows_equal(tlog.widen(to_port(js)), jtlog.widen(js))
    assert_rows_equal(tlog.grow(to_port(js), 40, 64), jtlog.grow(js, 40, 64))
    assert_rows_equal(tlog.init(5, 8, True, "cpu"), jtlog.init(5, 8, True))
    assert_rows_equal(tlog.init(5, 8, False, "cpu"), jtlog.init(5, 8, False))
    p = to_port(js)
    assert tlog.grow(p, K, L) is p and tlog.widen(tlog.widen(p)).wide
    # a narrow state widened mid-stream then fed 64-bit ts
    w_j, w_p = jtlog.widen(js), tlog.widen(to_port(js))
    ki = np.array([0, 3, 7], np.int32)
    ts = np.array([1 << 40, 5, U64], np.uint64)
    vid = np.array([1, 2, 3], np.int64)
    assert_rows_equal(tlog.insert_batch(w_p, torch.from_numpy(ki), t64(ts), t64(vid))[0],
                      jtlog.insert_batch(w_j, ki, ts, vid)[0])
    back = convert.tlog_to_jax(p)
    again = convert.tlog_from_jax(*back, device="cpu")
    for x, y in zip(p, again):
        if x is not None:
            assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_read_row_and_host_decoders_match_jax(wide):
    rng = np.random.default_rng(11)
    js = canonical_state(rng, wide)
    ps = to_port(js)
    for k in (0, 5, K - 1):
        jts, jvid, jlen = jtlog.read_row(js, k)
        pts, pvid, plen = tlog.read_row(ps, k)
        assert np.array_equal(planes.to_u64_np(pts), np.asarray(jts))
        assert np.array_equal(pvid.numpy(), np.asarray(jvid))
        assert int(plen) == int(jlen)
    nth = None if ps.nth is None else ps.nth.numpy()
    assert np.array_equal(
        tlog.decode_ts_np(nth, ps.ntl.numpy()),
        jtlog.decode_ts_np(None if js.nth is None else np.asarray(js.nth),
                           np.asarray(js.ntl)))
    assert np.array_equal(tlog.decode_vid_np(ps.nv.numpy()),
                          jtlog.decode_vid_np(np.asarray(js.nv)))
    vids = np.array([-1, 0, 5, (1 << 31) - 2], np.int64)
    assert np.array_equal(tlog.encode_vid_np(vids), jtlog.encode_vid_np(vids))


def test_pad_and_negative_slots_write_nothing():
    """Rows >= K and negative rows are pads: no state written, overflow,
    length and cutoff 0 (JAX clamps their gathers instead; a negative
    index there even wraps to a real row, so the repo never sends one)."""
    rng = np.random.default_rng(4)
    ps = to_port(canonical_state(rng, True))
    before = host(ps)
    ki = np.array([K, K + 5, -1, -7, (1 << 31) - 1], np.int32)
    ts, vid, cut = draw_delta(rng, 5, 3, True)
    ovf, out_len, out_cut = tlog.drain_sparse(
        ps, torch.from_numpy(ki), t64(ts), t64(vid), t64(cut),
        t64(np.zeros(5, np.int64)))
    assert not ovf.any() and not out_len.any() and not out_cut.any()
    for got, want in zip(host(ps), before):
        assert np.array_equal(got, want)
