"""Parity of the port's UJSON device ops (jylis_tpu_torch/ops/ujson_device.py
and the fused drains of ops/ujson_resident.py) with the JAX package's, on
the CPU.

The same documents, made from a numpy seed with the JAX tests' own
``random_mutations`` (tests/test_ops_ujson_device.py), are encoded once
by the host encoder; the planes go through the JAX functions and through
the port's plain PyTorch versions (the path every CPU tensor takes), and
every output plane must be equal bit for bit through convert.py
(tolerance 0: dots, payload ids, version vectors and clouds, pads
included), narrow (int32, shift 28) and wide (u64, shift 32). The flat
fold runs through ``fold_join_subset`` at D <= 64 and the pairwise tree
at D > 64. Hand-made planes hold one dot under two payload ids (the
flat fold keeps the last copy in flat order, the tree the first) and
u32 version vectors at the wrap. A test-local model of the flat fold
kernel's rule (csrc/ujson_fold_flat.cu: kept flags, per-row prefix
counts, co-rank placement, no sort) is held against JAX's flat fold on
random delta stacks, and the kernel's launch plans are checked at the
shapes chip_smoke.py launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jylis_tpu.ops import ujson_device as jdev
from jylis_tpu.ops import ujson_resident as jres
from jylis_tpu.ops.ujson_host import UJSON as JaxUJSON
from jylis_tpu_torch import convert
from jylis_tpu_torch.ops import ujson_device as tdev
from jylis_tpu_torch.ops import ujson_resident as tres
from jylis_tpu_torch.ops.ujson_host import UJSON
from test_ops_ujson_device import PayInterner, random_mutations

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

N_REP = 8
SHIFTS = [jdev.narrow_shift(N_REP), 32]
SHIFT_IDS = ["narrow", "wide"]


def docs_np(seed: int, n: int, shift: int, n_ops: int = 6, pay=None, rid_cols=None):
    """n random documents from writers 1..5, encoded by the JAX encoder
    (host planes in the JAX dtypes)."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        d = JaxUJSON()
        random_mutations(rng, d, replica=i % 5 + 1, n_ops=n_ops)
        docs.append(d)
    pay = PayInterner() if pay is None else pay
    rid_cols = {} if rid_cols is None else rid_cols
    return jdev._encode_docs_np(docs, rid_cols, pay, N_REP, shift)


def delta_stacks(seed: int, k: int, d: int, shift: int, pad_keys: int = 0):
    """A (k + pad_keys, d, W) grid of delta documents: each key's writers
    mutate a shared document and ship each step as a delta; the pad keys'
    segments are identity documents."""
    rng = np.random.default_rng(seed)
    flat = []
    for key in range(k):
        writer = JaxUJSON()
        random_mutations(rng, writer, replica=9, n_ops=3)
        for j in range(d):
            delta = JaxUJSON()
            random_mutations(rng, writer, replica=1 + (key + j) % 7, n_ops=1, delta=delta)
            flat.append(delta)
    flat += [JaxUJSON()] * (pad_keys * d)
    b = jdev._encode_docs_np(flat, {}, PayInterner(), N_REP, shift)
    return jdev.DocBatch(*(p.reshape((k + pad_keys, d) + p.shape[1:]) for p in b))


def jx(b):
    return jdev.DocBatch(*(jnp.asarray(p) for p in b))


def pt(b):
    return convert.docbatch_from_jax(*b, device="cpu")


def rows(b, sl):
    return type(b)(*(p[sl] for p in b))


def assert_same(port, jax_out):
    got = convert.docbatch_to_jax(port)
    want = tuple(np.asarray(p) for p in jax_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_encode_decode_and_convert_match_jax(shift):
    rng = np.random.default_rng(5)
    docs = []
    for i in range(12):
        d = UJSON()
        random_mutations(rng, d, replica=i % 4 + 1, n_ops=7)
        docs.append(d)
    jpay, tpay = PayInterner(), PayInterner()
    jcols, tcols = {}, {}
    want = jdev._encode_docs_np(docs, jcols, jpay, N_REP, shift)
    got = tdev._encode_docs_np(docs, tcols, tpay, N_REP, shift)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert jcols == tcols and jpay.rev == tpay.rev
    batch = tdev.encode_docs(docs, dict(tcols), PayInterner(), N_REP, shift, device="cpu")
    assert_same(batch, want)
    assert np.shares_memory(convert.docbatch_to_jax(batch)[0], want[0]) is False
    cols_rid = {c: r for r, c in tcols.items()}
    mine = tdev.decode_batch(batch, cols_rid, tpay.lookup, shift=shift)
    theirs = jdev.decode_batch(jx(want), cols_rid, jpay.lookup, shift=shift)
    assert [d.render() for d in mine] == [d.render() for d in theirs]
    assert [(d.entries, d.ctx.vv, d.ctx.cloud) for d in mine] == [
        (d.entries, d.ctx.vv, d.ctx.cloud) for d in theirs]
    assert tdev.plan_shift(docs, N_REP) == jdev.plan_shift(docs, N_REP)
    assert_same(tdev.compact(batch), jdev.compact(jx(want)))


@pytest.mark.parametrize("big_seq", [False, True], ids=["fits", "overflows"])
def test_auto_layout_policies_match_jax(big_seq):
    """Narrow first, u64/32 when a seq does not fit (or prefer=32), for
    one list, several lists under one layout, and key groups."""
    rng = np.random.default_rng(7 + big_seq)
    docs = []
    for i in range(6):
        d = UJSON()
        random_mutations(rng, d, replica=i + 1, n_ops=5)
        docs.append(d)
    if big_seq:
        docs[3].ctx.vv[9] = (1 << 28) + 1
    groups = [docs[:2], docs[2:5], [], docs[5:]]
    for prefer in (None, 32):
        want, jshift = jdev.encode_docs_auto(docs, {}, PayInterner(), N_REP, prefer=prefer)
        got, tshift = tdev.encode_docs_auto(docs, {}, PayInterner(), N_REP, prefer=prefer,
                                            device="cpu")
        assert tshift == jshift == (32 if big_seq or prefer else 28)
        assert_same(got, want)
        want, jshift = jdev.encode_doc_lists_auto([docs[:3], docs[3:]], {}, PayInterner(),
                                                  N_REP, prefer=prefer)
        got, tshift = tdev.encode_doc_lists_auto([docs[:3], docs[3:]], {}, PayInterner(),
                                                 N_REP, prefer=prefer, device="cpu")
        assert tshift == jshift
        for g, w in zip(got, want):
            assert_same(g, w)
        want, jshift = jdev.encode_doc_groups_auto(groups, {}, PayInterner(), N_REP,
                                                   prefer=prefer)
        got, tshift = tdev.encode_doc_groups_auto(groups, {}, PayInterner(), N_REP,
                                                  prefer=prefer, device="cpu")
        assert tshift == jshift
        assert_same(got, want)


@pytest.mark.parametrize("sort_output", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_join_batch_matches_jax(shift, sort_output):
    b = docs_np(11, 24, shift)
    a_np, b_np = rows(b, slice(0, 12)), rows(b, slice(12, 24))
    before = tdev.join_rows.launches
    got = tdev.join_batch(pt(a_np), pt(b_np), shift=shift, sort_output=sort_output)
    assert tdev.join_rows.launches == before  # CPU tensors: the plain version
    assert_same(got, jdev.join_batch(jx(a_np), jx(b_np), shift=shift,
                                     sort_output=sort_output))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 70])
@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_fold_deltas_matches_jax(shift, n):
    g = delta_stacks(20 + n, 1, n, shift)
    flat = rows(g, 0)
    assert_same(tdev.fold_deltas(pt(flat), shift), jdev.fold_deltas(jx(flat), shift=shift))


@pytest.mark.parametrize("k,d", [(4, 3), (3, 9), (2, 70)])
@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_fold_segments_matches_jax(shift, k, d):
    g = delta_stacks(30 + d, k, d, shift)
    assert_same(tdev.fold_segments(pt(g), shift), jdev.fold_segments(jx(g), shift=shift))


@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_broadcast_joins_match_jax(shift):
    reps = docs_np(41, 6, shift)
    g = delta_stacks(42, 1, 11, shift)
    one = jdev.fold_deltas(jx(rows(g, 0)), shift=shift)
    for sort_output in (True, False):
        assert_same(
            tdev.broadcast_join(pt(reps), pt([np.asarray(p) for p in one]), shift, sort_output),
            jdev.broadcast_join(jx(reps), one, shift=shift, sort_output=sort_output))
        assert_same(
            tdev.fold_and_broadcast(pt(reps), pt(rows(g, 0)), shift, sort_output),
            jdev.fold_and_broadcast(jx(reps), jx(rows(g, 0)), shift=shift,
                                    sort_output=sort_output))


def resident_np(seed: int, cap: int, shift: int):
    """A resident batch: identity row 0, documents in rows 1..cap-1."""
    b = docs_np(seed, cap - 1, shift, n_ops=8)
    ident = jdev._encode_docs_np([JaxUJSON()], {}, PayInterner(), N_REP, shift)
    ident = jres._pad_planes_np(ident, b.dots.shape[1], b.cloud.shape[1])
    return jdev.DocBatch(*(np.concatenate([x, y]) for x, y in zip(ident, b)))


@pytest.mark.parametrize("d", [1, 5, 64, 65, 130], ids=lambda d: f"D{d}")
@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_fold_join_subset_matches_jax(shift, d):
    """The flat rule at D <= 64 and the tree above it, joined into the
    gathered resident rows with the epilogue, at widths that grow, keep
    and shrink the planes; padded slots point at identity row 0 with
    identity segments."""
    res = resident_np(50 + d, 10, shift)
    grid = delta_stacks(60 + d, 5, d, shift, pad_keys=3)
    idx = np.array([3, 7, 1, 9, 4, 0, 0, 0], np.int32)
    lw = res.dots.shape[1]
    lc = res.cloud.shape[1]
    for out_w, out_c in ((lw, lc), (4 * lw, 2 * lc), (64, 64)):
        j_out, j_live = jres.fold_join_subset(jx(res), jx(grid), jnp.asarray(idx),
                                              shift=shift, out_w=out_w, out_c=out_c)
        port_res = pt(res)
        t_out, t_live = tres.fold_join_subset(port_res, pt(grid), torch.from_numpy(idx),
                                              shift=shift, out_w=out_w, out_c=out_c)
        assert_same(t_out, j_out)
        assert t_live.dtype == torch.int32
        assert np.array_equal(t_live.numpy(), np.asarray(j_live))
        if (out_w, out_c) == (lw, lc):  # the widths held: joined in place
            assert t_out.dots.data_ptr() == port_res.dots.data_ptr()


@pytest.mark.parametrize("d", [7, 64, 100], ids=lambda d: f"D{d}")
@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_fold_broadcast_rows_matches_jax(shift, d):
    res = resident_np(70 + d, 8, shift)
    deltas = rows(delta_stacks(80 + d, 1, d, shift), 0)
    occ = np.array([False, True, True, False, True, True, True, False])
    lw, lc = res.dots.shape[1], res.cloud.shape[1]
    for out_w, out_c in ((lw, lc), (2 * lw, 4 * lc)):
        j_out, j_live = jres.fold_broadcast_rows(jx(res), jx(deltas), jnp.asarray(occ),
                                                 shift=shift, out_w=out_w, out_c=out_c)
        t_out, t_live = tres.fold_broadcast_rows(pt(res), pt(deltas), torch.from_numpy(occ),
                                                 shift=shift, out_w=out_w, out_c=out_c)
        assert_same(t_out, j_out)
        assert np.array_equal(t_live.numpy(), np.asarray(j_live))


def test_duplicated_dot_tie_break_matches_jax():
    """One dot under two payload ids in two deltas of one key: the flat
    fold keeps the LAST copy in flat (delta, slot) order, the tree the
    FIRST (add_b excludes b-dots a holds); both held to JAX, narrow and
    wide, through fold_join_subset, fold_segments and join_batch."""
    for shift in SHIFTS:
        dt = np.int32 if shift < 32 else np.uint64
        pad = jdev._pad_of(dt)
        dot = lambda col, seq: (col << shift) | seq  # noqa: E731
        for d in (3, 66):
            dots = np.full((1, d, 4), pad, dt)
            pay = np.full((1, d, 4), -1, np.int32)
            dots[0, 0, :2] = [dot(1, 5), dot(2, 3)]
            pay[0, 0, :2] = [10, 11]
            dots[0, d - 1, :2] = [dot(1, 5), dot(3, 9)]  # dot (1, 5) again
            pay[0, d - 1, :2] = [20, 21]
            vv = np.zeros((1, d, N_REP), np.uint32)
            cloud = np.full((1, d, 4), pad, dt)
            cloud[0, 1, 0] = dot(4, 2)
            grid = jdev.DocBatch(dots, pay, vv, cloud)
            assert_same(tdev.fold_segments(pt(grid), shift),
                        jdev.fold_segments(jx(grid), shift=shift))
            res = jdev.DocBatch(np.full((2, 4), pad, dt), np.full((2, 4), -1, np.int32),
                                np.zeros((2, N_REP), np.uint32), np.full((2, 4), pad, dt))
            idx = np.array([1], np.int32)
            j_out, _ = jres.fold_join_subset(jx(res), jx(grid), jnp.asarray(idx),
                                             shift=shift, out_w=8, out_c=4)
            t_out, _ = tres.fold_join_subset(pt(res), pt(grid), torch.from_numpy(idx),
                                             shift=shift, out_w=8, out_c=4)
            assert_same(t_out, j_out)
            kept = convert.docbatch_to_jax(t_out)[1][1, 0]
            assert kept == (20 if d <= 64 else 10)
        a = jdev.DocBatch(dots[0, :1], pay[0, :1], vv[0, :1], cloud[0, :1])
        b = jdev.DocBatch(dots[0, -1:], pay[0, -1:], vv[0, -1:], cloud[0, -1:])
        assert_same(tdev.join_batch(pt(a), pt(b), shift), jdev.join_batch(jx(a), jx(b), shift=shift))


@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_compact_ctx_row_matches_jax(shift):
    """Random sorted, duplicate-free clouds over a few columns against
    version vectors that cover part of each column, touch it, or sit at
    the u32 wrap (vv + rank + 1 wraps)."""
    rng = np.random.default_rng(90 + shift)
    dt = np.int32 if shift < 32 else np.uint64
    pad = jdev._pad_of(dt)
    n, c = 16, 24
    vv = rng.integers(0, 12, (n, N_REP)).astype(np.uint32)
    vv[0, :] = 0xFFFFFFFF
    vv[1, 2] = 0xFFFFFFFE
    cloud = np.full((n, c), pad, dt)
    seq_hi = (1 << min(shift, 32)) - 2
    for i in range(n):
        vals = set()
        for _ in range(int(rng.integers(0, c + 1))):
            col = int(rng.integers(0, N_REP))
            seq = int(rng.integers(1, 20)) if i > 1 else int(rng.integers(0, 3))
            if i == 1 and col == 2:
                seq = [0xFFFFFFFF, 0, 1][len(vals) % 3] if shift == 32 else int(
                    rng.integers(1, seq_hi))
            vals.add((col << shift) | seq)
        vals = sorted(vals)[:c]
        cloud[i, : len(vals)] = vals
    want = jax.vmap(lambda v, cl: jres._compact_ctx_row(v, cl, shift))(
        jnp.asarray(vv), jnp.asarray(cloud))
    port = pt((np.zeros((n, 1), dt), np.zeros((n, 1), np.int32), vv, cloud))
    got_vv, got_cloud = tdev.compact_ctx_rows(port.vv, port.cloud, shift)
    assert np.array_equal(got_vv.numpy().view(np.uint32), np.asarray(want[0]))
    assert np.array_equal(convert.docbatch_to_jax(
        port._replace(cloud=got_cloud))[3], np.asarray(want[1]))
    assert not np.array_equal(np.asarray(want[0]), vv)  # something absorbed


@pytest.mark.parametrize("case", ["join", "compaction"])
def test_bit63_columns_match_jax_join_and_compaction(case):
    """Wide dots whose column field is 2^31 or more (bit 63 set; no
    encoder mints one). JAX's join (`_covered`) and context compaction
    (`_compact_ctx_row`) look vv up through a column mask, so such a
    column matches none: its vv entry reads 0 and nothing absorbs into
    it, though an absorbable run still leaves the cloud. The port's plain
    join and compaction (``tdev._mask_col_seq``) decode them the same,
    at tolerance 0."""
    g = flat_planes_np(300, 16, 2, 16, 16, 32)
    if case == "join":
        a, b = rows(g, (slice(None), 0)), rows(g, (slice(None), 1))
        assert_same(tdev.join_batch(pt(a), pt(b), shift=32),
                    jdev.join_batch(jx(a), jx(b), shift=32))
        return
    vv, cloud = g.vv[:, 0].copy(), g.cloud[:, 0].copy()
    pad = jdev._pad_of(cloud.dtype)
    # runs that absorb: above vv[7] in column 7, and above 0 in the
    # unmatched columns 2^31 and 2^32 - 2
    vv[0, 7] = 4
    run = [(7 << 32) | s for s in (5, 6, 9)] + [(2**31 << 32) | s for s in (1, 2)] + [
        ((2**32 - 2) << 32) | s for s in (1, 3)]
    cloud[0] = pad
    cloud[0, : len(run)] = np.array(run, np.uint64)
    cols = cloud[cloud != pad] >> np.uint64(32)
    assert (cols >= 2**31).any()
    want = jax.vmap(lambda v, cl: jres._compact_ctx_row(v, cl, 32))(
        jnp.asarray(vv), jnp.asarray(cloud))
    port = pt((np.zeros((16, 1), np.uint64), np.zeros((16, 1), np.int32), vv, cloud))
    got_vv, got_cloud = tdev.compact_ctx_rows(port.vv, port.cloud, 32)
    assert np.array_equal(got_vv.numpy().view(np.uint32), np.asarray(want[0]))
    assert np.array_equal(convert.docbatch_to_jax(
        port._replace(cloud=got_cloud))[3], np.asarray(want[1]))
    assert np.asarray(want[0])[0, 7] == 6  # 5 and 6 absorbed, 9 kept
    assert list(np.asarray(want[1])[0, :2]) == [(7 << 32) | 9, ((2**32 - 2) << 32) | 3]


@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_layout_helpers_match_jax(shift):
    res = resident_np(95, 12, shift)
    j, t = jx(res), pt(res)
    assert_same(tres.slice_widths(t, 4, 8), jres.slice_widths(j, w=4, c=8))
    assert_same(tres.slice_widths(t, 64, 32), jres.slice_widths(j, w=64, c=32))
    assert np.array_equal(tres.live_widths(t).numpy(), np.asarray(jres.live_widths(j)))
    mask = np.arange(12) % 3 == 1
    assert_same(tres.clear_rows(t, torch.from_numpy(mask)), jres.clear_rows(j, jnp.asarray(mask)))
    table = np.random.default_rng(1).permutation(int(res.pay.max()) + 1).astype(np.int32)
    assert_same(tres.remap_pay(t, torch.from_numpy(table)), jres.remap_pay(j, jnp.asarray(table)))
    assert_same(tres.grow_capacity(t, 24), jres.grow_capacity(j, rows=24))
    assert_same(tres.grow_reps(t, 16), jres.grow_reps(j, n_rep=16))
    new = docs_np(96, 3, shift)
    new = jres._pad_planes_np(new, res.dots.shape[1], res.cloud.shape[1])
    new = jdev.DocBatch(new.dots[:, : res.dots.shape[1]], new.pay[:, : res.dots.shape[1]],
                        new.vv, new.cloud[:, : res.cloud.shape[1]])
    idx = np.array([2, 5, 11], np.int32)
    assert_same(tres.place_rows(pt(res), pt(new), torch.from_numpy(idx)),
                jres.place_rows(j, jx(new), jnp.asarray(idx)))
    if shift < 32:
        assert_same(tres.widen_rows(t, shift), jres.widen_rows(j, old_shift=shift))
        s2 = jdev.narrow_shift(32)
        assert_same(tres.repack_narrow(t, shift, s2),
                    jres.repack_narrow(j, old_shift=shift, new_shift=s2))


def test_wide_pad_decodes_to_the_last_column():
    """The wide pad is -1 as int64 bits: its column field is 0xFFFFFFFF,
    -1 as JAX's int32 column. The flat fold indexes vv with it from the
    end (R-1, the last column); the join's column mask matches no column
    (-1, vv reads 0); it sorts after every dot."""
    big = (((2**32 - 3) << 32) | 5) - 2**64  # bit 63 set, as int64 bits
    x = torch.tensor([[-1, (3 << 32) | 7, big]], dtype=torch.int64)
    col, seq = tres._flat_col_seq(x, 32, N_REP)
    assert col.tolist() == [[N_REP - 1, 3, N_REP - 3]]
    assert seq.tolist() == [[0xFFFFFFFF, 7, 5]]
    col, seq = tdev._mask_col_seq(x, 32, N_REP)
    assert col.tolist() == [[-1, 3, -3]] and seq.tolist() == [[0xFFFFFFFF, 7, 5]]
    vv = torch.arange(1, N_REP + 1, dtype=torch.int32)[None]
    assert tdev._vv_at(vv, col).tolist() == [[0, 4, 0]]
    assert tdev._sort_rows(x)[0].tolist() == [[(3 << 32) | 7, big, -1]]


def test_cpu_wrappers_take_the_plain_versions():
    shift = SHIFTS[0]
    g = pt(delta_stacks(99, 2, 4, shift))
    before = (tdev.join_rows.launches, tres.fold_flat.launches)
    for x, y in zip(tres.fold_flat(g, shift), tres.fold_flat_plain(g, shift)):
        assert torch.equal(x, y)
    flat = tdev.DocBatch(*(p[:, 0] for p in g))
    for x, y in zip(tdev.join_rows(flat, flat, shift), tdev.join_rows_plain(flat, flat, shift)):
        assert torch.equal(x, y)
    assert (tdev.join_rows.launches, tres.fold_flat.launches) == before
    with pytest.raises(ValueError):
        tdev.join_rows(flat, flat, shift, a_idx=torch.zeros(2, dtype=torch.int32))


# ---- the class boundaries of csrc/ujson_join.cu ---------------------------------

SMEM_MAX = 232_448  # dynamic shared memory an H100 block may use


@pytest.mark.parametrize("n,la,lb,ca,cb,r,tsize,kind,rpc,smem,grid,scratch,cluster", [
    # chip_smoke.py's shapes: the 5b tree's first, seventh and last
    # levels (narrow), its sixth and seventh (wide), config 5's tree where
    # it leaves shared memory, the 5b subset join, config 5's broadcast
    (16384, 4, 4, 4, 4, 8, 4, "warp", 8, 2_432, 2048, 0, 1),
    (256, 256, 256, 256, 256, 8, 4, "cta", 1, 10_880, 256, 0, 1),
    (64, 1024, 1024, 1024, 1024, 8, 4, "cta", 1, 43_136, 64, 0, 1),
    (512, 128, 128, 128, 128, 8, 8, "warp", 4, 34_304, 128, 0, 1),
    (256, 256, 256, 256, 256, 8, 8, "cta", 1, 17_024, 256, 0, 1),
    (8, 4096, 4096, 4096, 4096, 32, 4, "cta", 1, 172_544, 8, 0, 1),
    (4, 8192, 8192, 8192, 8192, 32, 4, "cluster", 1, 33_536, 32, 0, 8),
    (64, 4096, 2048, 4, 2048, 8, 4, "cta", 1, 80_048, 64, 0, 1),
    (64, 4, 65536, 4, 65536, 32, 4, "cluster", 1, 132_640, 512, 0, 8),
    (64, 4, 65536, 4, 65536, 32, 8, "cluster", 1, 198_176, 512, 0, 8),
    (1, 32768, 32768, 32768, 32768, 32, 8, "cluster", 1, 198_144, 8, 0, 8),
    # the crossovers (WARP_ROW_BYTES = 16 KiB, WARP_MIN_ROWS = 512) and
    # one step past each
    (1024, 384, 384, 384, 384, 8, 4, "warp", 7, 113_792, 147, 0, 1),
    (1024, 388, 388, 388, 388, 8, 4, "cta", 1, 16_432, 1024, 0, 1),
    (1024, 244, 244, 244, 244, 8, 8, "warp", 7, 113_680, 147, 0, 1),
    (1024, 248, 248, 248, 248, 8, 8, "cta", 1, 16_496, 1024, 0, 1),
    (512, 64, 64, 64, 64, 8, 4, "warp", 4, 11_264, 128, 0, 1),
    (256, 64, 64, 64, 64, 8, 4, "cta", 1, 2_816, 256, 0, 1),
    # the widest rows the CTA class takes (CTA_ROW_BYTES = SMEM_LIMIT) and
    # the next width: a cluster of 8 covers the card with 8 rows
    (8, 4864, 4864, 4864, 4864, 32, 4, "cta", 1, 204_800, 8, 0, 1),
    (8, 4868, 4868, 4868, 4868, 32, 4, "cluster", 1, 20_144, 64, 0, 8),
    (8, 3092, 3092, 3092, 3092, 32, 8, "cta", 1, 204_592, 8, 0, 1),
    (8, 3096, 3096, 3096, 3096, 32, 8, "cluster", 1, 19_200, 64, 0, 8),
    # a share past 8 CTAs' shared memory: 16 (non-portable); past 16: the
    # shares in device scratch
    (2, 4, 98304, 4, 98304, 32, 8, "cluster", 1, 148_768, 32, 0, 16),
    (2, 4, 262144, 4, 262144, 32, 8, "cluster", 1, 0, 32, 12_673_024, 16),
])
def test_join_plan_at_every_chip_shape(n, la, lb, ca, cb, r, tsize, kind, rpc, smem, grid,
                                       scratch, cluster):
    plan = tdev.plan_join(n, tsize, la, lb, ca, cb, r)
    assert (plan.kind, plan.rows_per_cta, plan.smem, plan.grid, plan.scratch,
            plan.cluster) == (kind, rpc, smem, grid, scratch, cluster)
    assert plan.smem <= SMEM_MAX and plan.stride % 16 == 0
    assert plan.threads == (32 * rpc if kind == "warp" else 256)
    wb = tdev.join_work_bytes(tsize, la, lb, ca, cb, r)
    if kind == "cluster":
        pd, pc, share = tdev.join_share(tsize, la, lb, ca, cb, r, cluster)
        # every CTA's window holds its share of the merged dots and cloud
        assert pd * cluster >= la + lb and pc * cluster >= ca + cb
        assert grid % cluster == 0 and wb > tdev.row_plan.SMEM_LIMIT
        if scratch:
            assert plan.stride >= share and scratch == grid * plan.stride
        else:
            assert smem == share <= tdev.row_plan.SMEM_LIMIT


def warp_max_width(tsize: int, n: int = 1024) -> int:
    """The widest W (a multiple of 4) at which the warp class takes n
    rows of W dots and W cloud entries joined with the same (R = N_REP)."""
    def kind(w):
        return tdev.join_plan(n, tdev.join_work_bytes(tsize, w, w, w, w, N_REP)).kind

    w = 4
    while kind(w + 4) == "warp":
        w += 4
    assert kind(w) == "warp" and kind(w + 4) == "cta"
    assert tdev.join_work_bytes(tsize, w, w, w, w, N_REP) <= tdev.WARP_ROW_BYTES
    return w


@pytest.mark.parametrize("step", [0, 4], ids=["at", "past"])
@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_join_batch_matches_jax_at_the_warp_cta_crossover(shift, step):
    """Rows as wide as the warp class takes, and one step wider: the
    plain join (the card tests' oracle) against JAX's join_batch there,
    sorted, on documents padded out to those widths."""
    width = warp_max_width(4 if shift < 32 else 8) + step
    b = jres._pad_planes_np(docs_np(70 + step, 8, shift, n_ops=9), width, width)
    assert b.dots.shape[1] == width and b.cloud.shape[1] == width
    a_np, b_np = rows(b, slice(0, 4)), rows(b, slice(4, 8))
    assert tdev.join_plan(1024, tdev.join_work_bytes(
        b.dots.dtype.itemsize, width, width, width, width, N_REP)).kind == (
            "warp" if step == 0 else "cta")
    assert_same(tdev.join_batch(pt(a_np), pt(b_np), shift=shift),
                jdev.join_batch(jx(a_np), jx(b_np), shift=shift))


# ---- the flat fold kernel's rule and launch plans (csrc/ujson_fold_flat.cu) -----


def flat_planes_np(seed: int, k: int, d: int, w: int, c: int, shift: int):
    """(k, d, w) random delta stacks in the JAX dtypes: per delta a random
    share of sorted, duplicate-free dots (dots repeat across deltas under
    other payload ids) and cloud entries, pads after; wide dots mix seqs
    near 2^32 and columns past 2^31 (bit 63 set: 2^31 and 2^31 + 1, which
    wrap to indices below -R, and 2^32 - 4 to 2^32 - 2, which count from
    the end); a few vv entries sit at the u32 wrap. Key 0 is empty; key 1
    holds the least dot (0) in every delta under other payload ids; every
    entry of key 2 dies (its delta 0 holds no dots and its vv covers every
    dot); key 3 is one delta and d - 1 identity deltas."""
    rng = np.random.default_rng(seed)
    n, wide = k * d, shift == 32
    dt = np.uint64 if wide else np.int64
    pad = np.uint64(2**64 - 1) if wide else 0x7FFFFFFF

    def plane(width):
        col = rng.integers(0, N_REP, (n, width)).astype(dt)
        seq = rng.integers(1, 40, (n, width)).astype(dt)
        if wide:
            seq = np.where(rng.random((n, width)) < 0.2, dt(2**32 - 3) + seq % 3, seq)
            col = np.where(rng.random((n, width)) < 0.05, dt(2**31) + col % 2, col)
            col = np.where(rng.random((n, width)) < 0.05, dt(2**32 - 2) - col % 3, col)
        v = np.where(rng.random((n, width)) < rng.random((n, 1)) * 1.2,
                     (col << dt(shift)) | seq, pad)
        v.sort(1)
        v[:, 1:][v[:, 1:] == v[:, :-1]] = pad
        v.sort(1)
        return (v if wide else v.astype(np.int32)).reshape(k, d, width)

    dots, cloud = plane(w), plane(c)
    pay = np.where(dots != pad, rng.integers(0, 200, (k, d, w)), -1).astype(np.int32)
    vv = rng.integers(0, 30, (k, d, N_REP)).astype(np.uint32)
    vv[rng.random((k, d, N_REP)) < 0.03] = 0xFFFFFFFF
    dots[0], pay[0], vv[0], cloud[0] = pad, -1, 0, pad
    dots[1, :, 0], pay[1, :, 0] = 0, 1000 + np.arange(d)
    vv[2], dots[2, 0], pay[2, 0] = 0xFFFFFFFF, pad, -1
    dots[3, 1:], pay[3, 1:], vv[3, 1:], cloud[3, 1:] = pad, -1, 0, pad
    return jdev.DocBatch(dots, pay, vv, cloud)


def corank_fold(g, shift: int):
    """The kernel's rule in plain torch on a (k, d, w) grid: entry (i, s)
    with dot x is kept iff no delta j != i covers x without holding it and
    no delta j > i holds it; its slot is sum_j P_j[lb_j(x)] (P_j the
    exclusive prefix count of row j's kept flags); a cloud entry is kept
    iff no earlier row holds it, placed the same way. A dot's vv column
    is decoded as JAX's fold indexes it (tres._flat_col_seq: the u32
    column wrapped to int32, negative indices from the end, then clamped
    to 0)."""
    k, d, w = g.dots.shape
    c, r = g.cloud.shape[-1], g.vv.shape[-1]
    pad, key = tdev.pad_of(g.dots), tdev._key

    def place(rows, first):
        width = rows.shape[-1]
        x = rows.reshape(k, 1, d * width).expand(k, d, d * width)
        lb = torch.searchsorted(key(rows).contiguous(), key(x).contiguous())
        has = torch.gather(rows, 2, lb.clamp(max=width - 1)) == x
        j, i = torch.arange(d)[:, None], (torch.arange(d * width) // width)[None, :]
        return x, lb, has, (j > i) if first else (j < i)

    def slots(kept, lb, width):
        pre = F.pad(torch.cumsum(kept.reshape(k, d, width).long(), -1), (1, 0))
        return torch.gather(pre, 2, lb).sum(1)

    x, lb, has, later = place(g.dots, True)
    col, seq = tres._flat_col_seq(x, shift, r)
    cover = (seq <= torch.gather(tdev._u32(g.vv), 2, col)) | tdev._member(
        g.cloud.reshape(k * d, c), x.reshape(k * d, d * w)).reshape(k, d, d * w)
    own = later.logical_not() & (torch.arange(d)[:, None] == (torch.arange(d * w) // w))
    kept = (x[:, 0] != pad) & ~((has & later) | (~has & cover & ~own)).any(1)
    y, clb, chas, earlier = place(g.cloud, False)
    ckept = (y[:, 0] != pad) & ~(chas & earlier).any(1)
    out = [torch.full((k, d * w), pad, dtype=g.dots.dtype), torch.full((k, d * w), -1, dtype=torch.int32),
           tdev._i32(tdev._u32(g.vv).max(1).values),
           torch.full((k, d * c), pad, dtype=g.dots.dtype)]
    kk = torch.arange(k)[:, None]
    for o, src, m, at in ((0, x[:, 0], kept, slots(kept, lb, w)),
                          (1, g.pay.reshape(k, d * w), kept, slots(kept, lb, w)),
                          (3, y[:, 0], ckept, slots(ckept, clb, c))):
        out[o][kk.expand_as(m)[m], at[m]] = src[m].to(out[o].dtype)
    return tdev.DocBatch(*out)


_JAX_FOLD = jax.jit(jres._fold_grid, static_argnums=1)


@pytest.mark.parametrize("k,d,w,c", [(6, 7, 16, 8), (5, 64, 8, 8)], ids=["D7", "D64"])
@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_corank_rule_matches_jax_flat_fold(shift, k, d, w, c):
    """The port's plain fold (which the card tests hold the kernel to) and
    the kernel's co-rank rule, each against JAX's `_fold_grid` (the flat
    rule, D <= 64) at tolerance 0, on stacks whose wide dots carry
    columns past 2^31 (bit 63 set), which both decode as JAX does. Key 3's
    one delta folds alone (D = 1) to its row of the D-deep fold. JAX
    compiles its fold at these two shapes only."""
    g_np = flat_planes_np(100 + d + shift, k, d, w, c, shift)
    want = _JAX_FOLD(jx(g_np), shift)
    g = pt(g_np)
    assert_same(tres.fold_flat_plain(g, shift), want)
    assert_same(corank_fold(g, shift), want)
    one = corank_fold(tdev.DocBatch(*(p[3:4, :1] for p in g)), shift)
    got = [np.asarray(p) for p in want]
    assert_same(one, (got[0][3:4, :w], got[1][3:4, :w], got[2][3:4], got[3][3:4, :c]))
    pad = jdev._pad_of(g_np.dots.dtype)
    assert (got[0][0] == pad).all() and (got[0][2] == pad).all()  # empty, all dropped
    assert got[0][1, 0] == 0 and got[1][1, 0] == 1000 + d - 1  # the last copy's id
    assert (got[0][3, w:] == pad).all()
    if shift == 32:  # dots with bit 63 set take part: both kinds of wrapped column
        cols = g_np.dots[g_np.dots != pad] >> np.uint64(32)
        assert (cols == 2**31).any() and ((cols >= 2**32 - 4) & (cols <= 2**32 - 2)).any()


@pytest.mark.parametrize("k,tsize,d,w,c,r,kind,rpc,smem,grid,cluster,scratch", [
    # chip_smoke.py's shapes: the flat leg (4,096 keys) and its first 64
    # keys, narrow and wide; a mesh shard's launch of the flat leg; the
    # node's wide flat round; random planes of 2 keys x 512 dots a delta
    (4096, 4, 64, 4, 4, 32, "warp", 5, 72_960, 820, 1, 0),
    (4096, 8, 64, 4, 4, 32, "warp", 1, 16_640, 4096, 1, 0),
    (64, 4, 64, 4, 4, 32, "warp", 1, 14_592, 64, 1, 0),
    (64, 8, 64, 4, 4, 32, "warp", 1, 16_640, 64, 1, 0),
    (1024, 4, 64, 4, 4, 32, "warp", 5, 72_960, 205, 1, 0),
    (512, 8, 64, 4, 4, 32, "warp", 1, 16_640, 512, 1, 0),
    (2, 4, 64, 512, 64, 8, "cluster", 1, 80, 16, 8, 20_480),
    (2, 8, 64, 512, 64, 8, "cluster", 1, 80, 16, 8, 20_480),
    # the class boundaries and one step past each: the widest deltas the
    # warp class takes (8 dots); the widest key a CTA takes in a
    # launch of 16 keys (FLAT_SPREAD_BYTES); the widest a CTA's shared
    # memory holds (row_plan.SMEM_LIMIT)
    (4096, 4, 64, 8, 8, 8, "warp", 5, 72_960, 820, 1, 0),
    (4096, 4, 64, 12, 12, 8, "cta", 1, 10_768, 4096, 1, 0),
    (16, 4, 64, 28, 16, 8, "cta", 1, 15_888, 16, 1, 0),
    (16, 4, 64, 32, 16, 8, "cluster", 1, 80, 128, 8, 32_768),
    (132, 4, 64, 720, 16, 8, "cta", 1, 204_304, 132, 1, 0),
    (132, 4, 64, 724, 16, 8, "cluster", 1, 272, 264, 2, 1_757_184),
    (4096, 8, 64, 8, 8, 8, "warp", 6, 112_128, 683, 1, 0),
    (4096, 8, 64, 12, 12, 8, "cta", 1, 16_912, 4096, 1, 0),
    (16, 8, 64, 4, 16, 8, "cta", 1, 14_864, 16, 1, 0),
    (16, 8, 64, 8, 16, 8, "cluster", 1, 80, 128, 8, 32_768),
    (132, 8, 64, 360, 16, 8, "cta", 1, 202_768, 132, 1, 0),
    (132, 8, 64, 364, 16, 8, "cluster", 1, 272, 264, 2, 1_013_760),
])
def test_flat_plan_at_every_chip_shape(k, tsize, d, w, c, r, kind, rpc, smem, grid, cluster,
                                       scratch):
    """The launch plan of csrc/ujson_fold_flat.cu at every shape
    chip_smoke.py launches it at: the class, keys a CTA, shared memory,
    CTAs, CTAs a key and device scratch."""
    plan = tres.flat_plan(k, tsize, d, w, c, r)
    assert (plan.kind, plan.rows_per_cta, plan.smem, plan.grid, plan.cluster, plan.scratch) == (
        kind, rpc, smem, grid, cluster, scratch)
    assert plan.smem <= SMEM_MAX and plan.stride % 16 == 0
    assert plan.threads == (32 * rpc if kind == "warp" else 256)
    if kind == "cluster":  # every CTA of a cluster takes deltas; the grid is whole clusters
        assert plan.grid % cluster == 0 and plan.held * (cluster - 1) < d <= plan.held * cluster
    else:
        assert plan.held == d


@pytest.mark.parametrize("tsize", [4, 8], ids=SHIFT_IDS)
def test_flat_plan_boundaries_are_chip_smokes(tsize):
    """chip_smoke.py's UJ_FLAT_BOUNDARIES are flat_plan's class boundaries
    and one step past each: each pair differs in width by 4, and the
    class changes across it (a warp to a CTA; a CTA to a cluster at 16
    and at 132 keys)."""
    import chip_smoke

    shapes = chip_smoke.UJ_FLAT_BOUNDARIES[tsize]
    kinds = [tres.flat_plan(k, tsize, d, w, c, r).kind for k, d, w, c, r in shapes]
    assert kinds == ["warp", "cta", "cta", "cluster", "cta", "cluster"]
    for (k0, d0, w0, c0, r0), (k1, d1, w1, c1, r1) in zip(shapes[::2], shapes[1::2]):
        assert (k1, d1, r1, w1) == (k0, d0, r0, w0 + 4) and c1 in (c0, w1)
