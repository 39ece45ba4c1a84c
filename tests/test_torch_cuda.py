"""The port's CUDA kernels against their plain PyTorch versions.

The kernel tests need an NVIDIA GPU and skip without one; they cover the
shapes the full-size run in chip_smoke.py does not: small and wide
replica counts, the node's serving shapes (R = 16), cell counts that are
not a multiple of four (the TENSOR tail), unaligned TENSOR planes, pad
and negative batch rows, and what the counter wrappers refuse (odd
replica counts, unaligned planes); for TREG, timestamps and ranks
>= 2^63, ties and unset registers; for the gathered TENSOR join, pads,
NaN bits and what its wrapper refuses (D not a multiple of 4, unaligned
planes); for the TLOG drains, narrow and wide rows, duplicates inside a
delta and against the state, raised cutoffs, every kind of trim count,
CLR at ts 2^64-1, both overflow rules, pads, and rows wider than shared
memory holds (a thread-block cluster per row); every class of each row
kernel (a warp per row, a CTA per row and a cluster per row, its shares
in shared memory or in device scratch, forced in turn) at the widths
that split them, and the cluster's partition edges (trim targets and
cutoffs in the first and last CTA's share, deltas of repeats, twin dots
and cloud entries split across CTAs); for the UJSON join
and flat fold, narrow and wide rows (wide ones with seqs near 2^32 and
columns past 2^31, so dots with bit 63 set), empty rows, pads, one dot
under several payload ids (the flat fold's last-copy rule), version
vectors at the u32 wrap, the epilogue in place and refitted, the
broadcast with free rows, the tree's levels, and rows wider than shared
memory (a cluster per row); for the mesh, replica_join at even and odd S with columns at 0,
2^64-1 and >= 2^63 (and what its wrapper refuses), join_replica_axis,
the routed GCOUNT / PNCOUNT / TREG / TLOG drains on [cuda] * 4 against
the same drains on [cpu] * 4 (one launch per shard), the row-aligned
UJSON fold, and the dryrun on one card; for the staged sparse drains,
the counter and TREG kernels over a shard table of 1 and of 4 shards on
one card given live rows only (results at the slots; a table of the
last shards writes only theirs), the unrouted drains on [cuda] * 4
against [cpu] * 4 (one staged copy each way and one launch) and, on a
host with several cards, over every card (one or two shards a card;
the test skips on one card), and the
misaligned or wrong-typed buffers the wrappers refuse. Integer lattices,
so every comparison is exact. On a machine with a GPU (where JAX need
not be installed, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from jylis_tpu_torch.ops import gcount, planes, pncount, row_plan, tensor, tlog, treg
from jylis_tpu_torch.ops import ujson_device as udev
from jylis_tpu_torch.ops import ujson_resident as ures
from jylis_tpu_torch.ops.staging import DensePlan
from jylis_tpu_torch.utils.batching import pad_rows

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _u64(rng, shape):
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def _state(mod, rng, k, r, dev):
    if mod is gcount:
        return gcount.from_counts(_u64(rng, (k, r)), dev)
    return pncount.from_counts(_u64(rng, (k, r)), _u64(rng, (k, r)), dev)


def _clone(st):
    return type(st)(*(None if x is None else x.clone() for x in st))


def _equal(a, b):
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


# (K, R): R < 64 leaves lanes idle, R > 64 makes each lane loop;
# (131072, 16) is the node's shape at 100k keys x 8 replica ids
COUNTER_SHAPES = [(64, 64), (37, 2), (1000, 34), (5, 16), (300, 130),
                  (131072, 16)]


def _dense_rows(rng, k, b):
    """``b`` unique rows of ``k`` in no order, row k - 1 among them, as
    an int32 tensor's numpy source."""
    rows = rng.permutation(k)[:b].astype(np.int32)
    if k - 1 not in rows:
        rows[0] = k - 1
    return rows


def _dense_batches(k):
    """The dense drain's batch sizes at ``k`` keys: K / 4, K / 2 and K."""
    return sorted({max(1, k // 4), max(1, k // 2), k})


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [gcount, pncount], ids=["G", "PN"])
@pytest.mark.parametrize("k,r", COUNTER_SHAPES)
def test_drain_dense_matches_plain(dev, mod, k, r):
    """The staged dense drain at B = K / 4, K / 2 and K (unsorted unique
    rows, K - 1 among them; uniform u64, so values >= 2^63 and wrapping
    sums): state, every row's sum and the slots' sums bit for bit, each
    plan's slot map clean after, one launch a call."""
    rng = np.random.default_rng(k * 131 + r)
    st = _state(mod, rng, k, r, dev)
    pk, pp = DensePlan(_clone(st)), DensePlan(_clone(st))
    for b in _dense_batches(k):
        rows = _dense_rows(rng, k, b)
        ki = torch.from_numpy(rows).to(dev)
        deltas = [planes.to_tensor(_u64(rng, (b, r)), dev) for _ in st]
        before = mod.drain_dense.launches
        full_k, out_k = mod.drain_dense(pk, ki, *deltas)
        full_p, out_p = mod.drain_dense_plain(pp, ki, *deltas)
        torch.cuda.synchronize()
        assert mod.drain_dense.launches == before + 1
        assert torch.equal(full_k, full_p) and torch.equal(out_k, out_p)
        assert _equal(pk.state, pp.state)
        assert (pk.slots.map == -1).all() and not pk.slots.dirty


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [gcount, pncount], ids=["G", "PN"])
@pytest.mark.parametrize("k,r,live,b", [
    (64, 8, 3, 16), (1000, 6, 100, 128), (64, 8, 0, 16), (2048, 64, 1024, 1024),
    (131072, 16, 400, 512),  # the node's sparse drain of 400 keys
])
def test_drain_sparse_matches_plain(dev, mod, k, r, live, b):
    rng = np.random.default_rng(k + r + live + b)
    st = _state(mod, rng, k, r, dev)
    ki = (2**31 - 1 - np.arange(b)).astype(np.int32)
    ki[:live] = rng.choice(k, size=live, replace=False)
    if live < b:
        ki[-1] = -1  # a negative row is a pad slot too
    ki = torch.from_numpy(ki).to(dev)
    deltas = [planes.to_tensor(_u64(rng, (b, r)), dev) for _ in st]
    sk, sp = _clone(st), _clone(st)
    sums_k = mod.drain_sparse(sk, ki, *deltas)
    sums_p = mod.drain_sparse_plain(sp, ki, *deltas)
    torch.cuda.synchronize()
    assert torch.equal(sums_k, sums_p) and _equal(sk, sp)
    assert not sums_k[live:].any()


def _tensor_state(rng, n, d, dev):
    def bits():
        return rng.integers(0, 1 << 32, size=(n, d), dtype=np.uint32)

    raw = (bits(), bits() & 1, bits() & 3, bits() & 7)
    return tensor.TensorState(
        *(torch.from_numpy(x.view(np.int32)).to(dev) for x in raw)
    )


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(2048, 8), (33, 7), (1, 3), (1000, 64)])
def test_tensor_join_matches_plain(dev, n, d):
    rng = np.random.default_rng(n * d)
    st, dl = _tensor_state(rng, n, d, dev), _tensor_state(rng, n, d, dev)
    sk, sp = _clone(st), _clone(st)
    before = tensor.join_dense.launches
    tensor.join_dense(sk, dl)
    tensor.join_dense_plain(sp, dl)
    torch.cuda.synchronize()
    assert tensor.join_dense.launches == before + 1
    assert _equal(sk, sp)


@pytest.mark.cuda
def test_unaligned_planes_take_the_scalar_path(dev):
    rng = np.random.default_rng(7)
    # views one element into a buffer: 4 bytes off the 16-byte boundary,
    # so the TENSOR launch passes vec = 0
    t = _tensor_state(rng, 9, 5, dev)
    shifted = tensor.TensorState(
        *(torch.cat([p.new_zeros(1), p.flatten()])[1:].view(9, 5) for p in t)
    )
    assert shifted.val.data_ptr() % 16 != 0
    dl = _tensor_state(rng, 9, 5, dev)
    want = tensor.join_dense_plain(_clone(shifted), dl)
    got = tensor.join_dense(shifted, dl)
    assert _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [gcount, pncount], ids=["G", "PN"])
def test_counter_drains_reject_odd_rows_and_unaligned_planes(dev, mod):
    """The counter kernels load 16-byte vectors only; a plane they cannot
    take that way is refused before any launch."""
    rng = np.random.default_rng(7)
    odd = _state(mod, rng, 37, 7, dev)
    d_odd = [planes.to_tensor(_u64(rng, (37, 7)), dev) for _ in odd]
    ki = torch.zeros(4, dtype=torch.int32, device=dev)
    b_odd = [planes.to_tensor(_u64(rng, (4, 7)), dev) for _ in odd]
    # a view one element into a buffer: 8 bytes off the 16-byte boundary
    buf = planes.to_tensor(_u64(rng, (64 * 8 + 1,)), dev)
    shifted = type(odd)(*(buf[1:].view(64, 8) for _ in odd))
    assert shifted[0].data_ptr() % 16 != 0
    d8 = [planes.to_tensor(_u64(rng, (64, 8)), dev) for _ in odd]
    before = (mod.drain_dense.launches, mod.drain_sparse.launches)
    with pytest.raises(ValueError, match="odd"):
        mod.drain_dense(odd, ki, *b_odd)
    with pytest.raises(ValueError, match="odd"):
        mod.drain_sparse(odd, ki, *b_odd)
    with pytest.raises(ValueError, match="aligned"):
        mod.drain_dense(shifted, ki, *(d[:4] for d in d8))
    with pytest.raises(ValueError, match="aligned"):  # a staged view off 16 bytes
        mod.drain_dense(mod.init(64, 8, dev), ki[:1],
                        *(buf[1:9].view(1, 8) for _ in odd))
    with pytest.raises(ValueError, match="aligned"):
        mod.drain_sparse(mod.init(64, 8, dev), ki[:1],
                         *(buf[1:9].view(1, 8) for _ in odd))
    assert (mod.drain_dense.launches, mod.drain_sparse.launches) == before


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    st = gcount.init(16, 8, dev)
    ki = torch.arange(16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        gcount.drain_dense(st, ki, torch.zeros((16, 8), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        gcount.drain_dense(st, ki, torch.zeros((16, 4), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="aliases"):
        gcount.drain_dense(st, ki, st.counts)  # delta aliases state
    with pytest.raises(ValueError):
        gcount.drain_dense(st, ki.long(), torch.zeros((16, 8), dtype=torch.int64, device=dev))
    ki64 = torch.zeros(16, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        gcount.drain_sparse(st, ki64, torch.zeros((16, 8), dtype=torch.int64, device=dev))
    ts = tensor.init(4, 4, dev)
    with pytest.raises(ValueError):
        tensor.join_dense(ts, tensor.init(4, 2, dev))


def _treg(rng, n, dev, like=None):
    """(ts, rank, vid) planes from small pools (>= 2^63, repeats); with
    ``like`` = (state, rows), half the registers copy those rows' ts and
    rank, so ties and the presence tie-break occur."""
    pool = np.array([0, 1, 1 << 63, (1 << 64) - 1], np.uint64)
    ts = pool[rng.integers(0, 4, n)]
    rank = np.where(rng.random(n) < 0.5, pool[rng.integers(0, 4, n)],
                    _u64(rng, n)).astype(np.uint64)
    vid = rng.integers(-1, 3, n).astype(np.int32)
    if like is not None:
        st, rows = like
        copy = rng.random(n) < 0.5
        ts[copy] = planes.to_u64_np(st.ts)[rows[copy]]
        rank[copy] = planes.to_u64_np(st.rank)[rows[copy]]
    return (planes.to_tensor(ts, dev), planes.to_tensor(rank, dev),
            torch.from_numpy(vid).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 300, 4096, 70001])
def test_treg_drain_dense_matches_plain(dev, k):
    """The staged dense drain at B = K / 4, K / 2 and K (K not a multiple
    of 16: the clear's scalar tail), a half of the deltas at their row's
    ts and rank: the state, every key's tie flag (the last call's only)
    and the slots' (tie, ts, vid) bit for bit, no slot map, one launch a
    call."""
    rng = np.random.default_rng(k)
    st = treg.TRegState(*_treg(rng, k, dev))
    pk, pp = DensePlan(_clone(st)), DensePlan(_clone(st))
    for b in _dense_batches(k):
        rows = _dense_rows(rng, k, b)
        d = _treg(rng, b, dev, like=(pk.state, rows))
        ki = torch.from_numpy(rows).to(dev)
        before = treg.drain_dense.launches
        tie_k, out_k = treg.drain_dense(pk, ki, *d)
        tie_p, out_p = treg.drain_dense_plain(pp, ki, *d)
        torch.cuda.synchronize()
        assert treg.drain_dense.launches == before + 1
        assert torch.equal(tie_k, tie_p) and _equal(out_k, out_p)
        assert _equal(pk.state, pp.state)
        assert pk.slots is None
        if b >= 300:
            assert tie_k.any()


@pytest.mark.cuda
@pytest.mark.parametrize("k,b,live", [(64, 16, 16), (64, 16, 5), (1000, 128, 0),
                                      (1 << 20, 8192, 5000)])
def test_treg_drain_sparse_matches_plain(dev, k, b, live):
    rng = np.random.default_rng(k + b + live)
    st = treg.TRegState(*_treg(rng, k, dev))
    ki = pad_rows(b)
    ki[:live] = rng.choice(k, live, replace=False)
    if live < b:
        ki[-1] = -1  # a negative row is a pad slot too
    rows = np.where((ki >= 0) & (ki < k), ki, 0)
    d = _treg(rng, b, dev, like=(st, rows))
    ki = torch.from_numpy(ki).to(dev)
    sk, sp = _clone(st), _clone(st)
    out_k = treg.drain_sparse(sk, ki, *d)
    out_p = treg.drain_sparse_plain(sp, ki, *d)
    torch.cuda.synchronize()
    assert _equal(out_k, out_p) and _equal(sk, sp)
    assert not any(x[live:].any() for x in out_k)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b,live", [(64, 8, 16, 16), (64, 8, 16, 3),
                                        (1000, 4, 256, 200), (131072, 64, 512, 400),
                                        (100, 32, 16, 0)])
def test_tensor_converge_batch_matches_plain(dev, n, d, b, live):
    rng = np.random.default_rng(n + d + b + live)
    st = _tensor_state(rng, n, d, dev)
    dl = _tensor_state(rng, b, d, dev)
    nan = torch.tensor([0x7FC00000, -0x400000, 0, -(1 << 31)], dtype=torch.int32,
                       device=dev)
    dl.val[:, :4] = nan  # NaN bits, +0.0 and -0.0
    ki = pad_rows(b)
    ki[:live] = rng.choice(n, live, replace=False)
    if live < b:
        ki[-1] = -1
    ki = torch.from_numpy(ki).to(dev)
    sk, sp = _clone(st), _clone(st)
    before = tensor.converge_batch.launches
    tensor.converge_batch(sk, ki, *dl)
    tensor.converge_batch_plain(sp, ki, *dl)
    torch.cuda.synchronize()
    assert tensor.converge_batch.launches == before + 1
    assert _equal(sk, sp)


@pytest.mark.cuda
def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    st = tensor.init(16, 6, dev)  # D = 6: not whole 16-byte vectors
    ki = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        tensor.converge_batch(st, ki, *tensor.init(2, 6, dev))
    buf = torch.zeros(8 * 8 + 1, dtype=torch.int32, device=dev)
    shifted = tensor.TensorState(*(buf[1:].view(8, 8) for _ in range(4)))
    with pytest.raises(ValueError, match="aligned"):
        tensor.converge_batch(tensor.init(8, 8, dev), ki, *(
            p[:2] for p in shifted))
    with pytest.raises(ValueError):
        tensor.converge_batch(tensor.init(8, 8, dev), ki.long(),
                              *tensor.init(2, 8, dev))
    rs = treg.init(8, dev)
    k8 = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="aliases"):
        treg.drain_dense(rs, k8, rs.ts, rs.rank, rs.vid)  # delta aliases state
    with pytest.raises(ValueError):
        treg.drain_dense(rs, k8, *(p[:4] for p in treg.init(8, dev)))
    with pytest.raises(ValueError):
        treg.drain_sparse(rs, ki.long(), *(p[:2] for p in treg.init(8, dev)))
    with pytest.raises(ValueError):
        treg.drain_dense(rs, k8, *(p.int() for p in treg.init(8, dev)))
    # tie flags off a 16-byte boundary: the plan refuses them (the kernel
    # clears them 16 bytes at a time); a state 8 bytes off one is taken
    # (one key a thread)
    plan = DensePlan(treg.init(8, dev))
    plan.full = torch.zeros(17, dtype=torch.bool, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        treg.drain_dense(plan, k8, *treg.init(8, dev))
    buf = torch.zeros(17, dtype=torch.int64, device=dev)
    shifted = treg.TRegState(buf[1:9], rs.rank.clone(), rs.vid.clone())
    treg.drain_dense(shifted, k8, *treg.init(8, dev))


U64 = (1 << 64) - 1


def _tlog_state(rng, k, length, lens, wide, dev):
    """A canonical TLOG state: row r holds lens[r] entries, ts
    non-increasing (runs of equal ts) with vids strictly decreasing;
    row 0 of a wide state starts at ts 2^64-1. Also returns the (k, L)
    ts and vids the rows were cut from (for deltas)."""
    gaps = rng.integers(0, 3, (k, length)).astype(np.uint64)
    hi = (1 << 62) if wide else (1 << 32) - 2
    top = rng.integers(4 * length, hi, k).astype(np.uint64)
    if wide:
        top[0], gaps[0, 0] = U64, 0
    ts = top[:, None] - np.cumsum(gaps, 1, dtype=np.uint64)
    vid = (np.arange(length - 1, -1, -1)[None, :]
           + length * rng.integers(0, 1000, k)[:, None]).astype(np.int64)
    live = np.arange(length)[None, :] < np.asarray(lens)[:, None]
    nt = ~ts
    pl = [(nt >> np.uint64(32)).astype(np.uint32), nt.astype(np.uint32),
          tlog.encode_vid_np(vid)]
    pl = [np.where(live, p, np.uint32(0xFFFFFFFF)).view(np.int32) for p in pl]
    last = ts[np.arange(k), np.maximum(np.asarray(lens) - 1, 0)]
    cut = np.where((np.asarray(lens) > 0) & (rng.random(k) < 0.5), last, 0)
    st = tlog.TLogState(
        torch.from_numpy(pl[0]).to(dev) if wide else None,
        torch.from_numpy(pl[1]).to(dev), torch.from_numpy(pl[2]).to(dev),
        torch.from_numpy(np.asarray(lens, np.int32)).to(dev),
        planes.to_tensor(cut.astype(np.uint64), dev))
    return st, ts, vid


def _tlog_delta(rng, ts, vid, lens, rows, ld, dev):
    """(d_ts, d_vid, d_cut) for ``rows``: fresh entries near the row's
    own ts (some below its cutoff), copies of state entries, copies of
    earlier delta columns, invalid slots, and some raised cutoffs."""
    n, length = len(rows), ts.shape[1]
    pick = rng.integers(0, length, (n, ld))
    d_ts = ts[rows[:, None], pick] + rng.integers(0, 3, (n, ld)).astype(np.uint64)
    d_vid = rng.integers(0, 1 << 30, (n, ld)).astype(np.int64)
    lens = np.asarray(lens)[rows]
    kind = rng.random((n, ld))
    own = (kind < 0.3) & (lens[:, None] > 0)
    at = (rng.random((n, ld)) * np.maximum(lens, 1)[:, None]).astype(np.int64)
    d_ts[own] = ts[rows[:, None], at][own]
    d_vid[own] = vid[rows[:, None], at][own]
    if ld > 1:
        rep = (kind >= 0.3) & (kind < 0.45)
        rep[:, 0] = False
        src = np.where(rep)
        d_ts[src], d_vid[src] = d_ts[src[0], src[1] - 1], d_vid[src[0], src[1] - 1]
    d_vid[kind > 0.9] = -1
    raise_ = rng.random(n) < 0.2
    d_cut = np.where(raise_, ts[rows, (rng.random(n) * np.maximum(lens, 1)).astype(
        np.int64)], 0).astype(np.uint64)
    return (planes.to_tensor(d_ts, dev), torch.from_numpy(d_vid).to(dev),
            planes.to_tensor(d_cut, dev))


def _tlog_counts(rng, n, dev):
    kinds = np.array([tlog.TRIM_NOOP] * 6 + [0, 1, 2, 5, 40, 1 << 20, -1,
                                             tlog.TRIM_NOOP + 9], np.int64)
    return torch.from_numpy(kinds[rng.integers(0, len(kinds), n)]).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("k,length,b,live,ld", [
    (8, 16, 16, 8, 4), (64, 64, 32, 20, 1), (300, 256, 128, 100, 33),
    (16384, 1024, 16, 1, 1),  # a socket TRIM's drain at config 4's shape
    (2048, 1024, 2048, 1500, 128),
    (3, 65536, 4, 3, 65536),  # wider than shared memory: a cluster of 16
])
def test_tlog_drain_sparse_matches_plain(dev, wide, k, length, b, live, ld):
    rng = np.random.default_rng(k + length + b + ld + wide)
    lens = rng.integers(0, length // 3 + 1, k)
    lens[: k // 4] = length - rng.integers(0, 2, k // 4)  # near full: overflow
    st, ts, vid = _tlog_state(rng, k, length, lens, wide, dev)
    ki = pad_rows(b)
    ki[:live] = rng.choice(k, live, replace=False)
    if live < b:
        ki[-1] = -1  # a negative row is a pad slot too
    rows = np.where((ki >= 0) & (ki < k), ki, 0)
    d = _tlog_delta(rng, ts, vid, lens, rows, ld, dev)
    counts = _tlog_counts(rng, b, dev)
    ki = torch.from_numpy(ki).to(dev)
    sk, sp = _clone(st), _clone(st)
    before = tlog.drain_sparse.launches
    out_k = tlog.drain_sparse(sk, ki, *d, counts)
    out_p = tlog.drain_sparse_plain(sp, ki, *d, counts)
    torch.cuda.synchronize()
    assert tlog.drain_sparse.launches == before + 1
    assert _equal(out_k, out_p) and _equal(sk, sp)
    assert not any(x[live:].any() for x in out_k)
    if live >= 100:
        assert out_k[0].any() and not out_k[0].all()


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("k,length,ld", [
    (8, 16, 4), (100, 64, 64), (1000, 512, 7), (4, 65536, 8192)])
def test_tlog_drain_dense_matches_plain(dev, wide, k, length, ld):
    rng = np.random.default_rng(k * 7 + length + ld + wide)
    lens = rng.integers(0, length - ld + 1, k)
    lens[: max(1, k // 5)] = length - rng.integers(0, ld, max(1, k // 5))
    st, ts, vid = _tlog_state(rng, k, length, lens, wide, dev)
    d = _tlog_delta(rng, ts, vid, lens, np.arange(k), ld, dev)
    quiet = torch.from_numpy(rng.random(k) < 0.3).to(dev)
    d[1][quiet] = -1  # rows with no delta still face the overflow rule
    trim_ki = torch.from_numpy(np.r_[rng.choice(k, min(k, 8), replace=False),
                                     pad_rows(8)].astype(np.int32)).to(dev)
    counts = _tlog_counts(rng, trim_ki.shape[0], dev)
    sk, sp = _clone(st), _clone(st)
    before = tlog.drain_dense.launches
    ovf_k = tlog.drain_dense(sk, *d, trim_ki, counts)
    ovf_p = tlog.drain_dense_plain(sp, *d, trim_ki, counts)
    torch.cuda.synchronize()
    assert tlog.drain_dense.launches == before + 1
    assert torch.equal(ovf_k, ovf_p) and _equal(sk, sp)
    assert ovf_k.any() and not ovf_k.all()


def _force_class(monkeypatch, mod, klass):
    """Make a row kernel's wrapper take the warp class wherever the
    kernel has one ("warp"), a CTA per row ("cta"), or a thread-block
    cluster per row, its shares in shared memory ("cluster") or in device
    scratch ("scratch"); returns the class the wrapper counts."""
    monkeypatch.setattr(mod, "WARP_ROW_BYTES", (1 << 40) if klass == "warp" else 0)
    monkeypatch.setattr(mod, "WARP_MIN_ROWS", 1, raising=False)
    monkeypatch.setattr(mod, "CTA_ROW_BYTES",
                        row_plan.SMEM_LIMIT if klass in ("warp", "cta") else 0)
    if klass == "scratch":  # the cluster class with its shares in device scratch
        monkeypatch.setattr(row_plan, "SMEM_LIMIT", 512)
    return "cluster" if klass == "scratch" else klass


@pytest.mark.cuda
@pytest.mark.parametrize("klass", ["warp", "cta", "cluster", "scratch"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("k,length,b,live,ld,all_pad", [
    (64, 64, 64, 60, 1, False), (64, 64, 64, 60, 31, False), (64, 64, 64, 60, 32, False),
    (64, 64, 64, 60, 33, False), (64, 30, 64, 60, 5, False),  # L % 4 != 0: scalar copies
    (300, 256, 128, 100, 128, False), (300, 512, 128, 100, 256, False),
    (40, 1024, 32, 30, 257, False),  # Ld past the warp's registers: a CTA per row
    (200, 128, 256, 150, 8, True),  # no entry at all: trims and raised cutoffs only
    (16384, 1024, 16, 1, 1, True),  # a socket TRIM's drain
])
def test_tlog_drain_sparse_classes_match_plain(dev, monkeypatch, klass, wide, k, length,
                                               b, live, ld, all_pad):
    """Every class of tlog_drain at the widths that split them (Ld = 1,
    31, 32, 33: one delta entry a lane, 2; 256: 8; 257: the CTA class),
    bit for bit against the plain drain, with rows the sparse rule flags,
    pad and negative slots, and deltas that carry no entry."""
    klass = _force_class(monkeypatch, tlog, klass)
    nplanes = 3 if wide else 2
    want = "cta" if klass == "warp" and ld > tlog.WARP_MAX_LD else klass
    assert tlog.drain_plan(b, length, ld, nplanes).rows.kind == want
    rng = np.random.default_rng(k + length + ld + 7 * wide)
    lens = rng.integers(0, length // 3 + 1, k)
    lens[: k // 4] = length - rng.integers(0, 2, k // 4)
    st, ts, vid = _tlog_state(rng, k, length, lens, wide, dev)
    ki = pad_rows(b)
    ki[:live] = rng.choice(k, live, replace=False)
    if live < b:
        ki[-1] = -1
    rows = np.where((ki >= 0) & (ki < k), ki, 0)
    d = _tlog_delta(rng, ts, vid, lens, rows, ld, dev)
    if all_pad:
        d[1][:] = -1
    counts = _tlog_counts(rng, b, dev)
    ki = torch.from_numpy(ki).to(dev)
    sk, sp = _clone(st), _clone(st)
    before = tlog.drain_sparse.classes.get(want, 0)
    out_k = tlog.drain_sparse(sk, ki, *d, counts)
    out_p = tlog.drain_sparse_plain(sp, ki, *d, counts)
    torch.cuda.synchronize()
    assert tlog.drain_sparse.classes[want] == before + 1
    assert _equal(out_k, out_p) and _equal(sk, sp)
    assert not any(x[live:].any() for x in out_k)
    if live >= 100 and not all_pad:
        assert out_k[0].any() and not out_k[0].all()


@pytest.mark.cuda
@pytest.mark.parametrize("klass", ["warp", "cta", "cluster", "scratch"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("k,length,ld", [
    (100, 64, 1), (100, 64, 33), (300, 512, 128), (50, 1024, 256), (30, 1024, 300)])
def test_tlog_drain_dense_classes_match_plain(dev, monkeypatch, klass, wide, k, length, ld):
    """Every class of the dense drain, rows the dense rule flags (with
    and without a delta) among them, bit for bit against the plain drain."""
    klass = _force_class(monkeypatch, tlog, klass)
    want = "cta" if klass == "warp" and ld > tlog.WARP_MAX_LD else klass
    assert tlog.drain_plan(k, length, ld, 3 if wide else 2).rows.kind == want
    rng = np.random.default_rng(k * 3 + length + ld + wide)
    lens = rng.integers(0, max(1, length - ld) + 1, k)
    lens[: max(1, k // 5)] = length - rng.integers(0, min(ld, length), max(1, k // 5))
    st, ts, vid = _tlog_state(rng, k, length, lens, wide, dev)
    d = _tlog_delta(rng, ts, vid, lens, np.arange(k), ld, dev)
    quiet = torch.from_numpy(rng.random(k) < 0.3).to(dev)
    d[1][quiet] = -1
    trim_ki = torch.from_numpy(np.r_[rng.choice(k, min(k, 8), replace=False),
                                     pad_rows(8)].astype(np.int32)).to(dev)
    counts = _tlog_counts(rng, trim_ki.shape[0], dev)
    sk, sp = _clone(st), _clone(st)
    ovf_k = tlog.drain_dense(sk, *d, trim_ki, counts)
    ovf_p = tlog.drain_dense_plain(sp, *d, trim_ki, counts)
    torch.cuda.synchronize()
    assert torch.equal(ovf_k, ovf_p) and _equal(sk, sp)
    assert ovf_k.any()


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("case", ["trim_first", "trim_last", "clr", "cut_first",
                                  "cut_last", "repeats", "overflow"])
def test_tlog_drain_cluster_partition_edges(dev, monkeypatch, wide, case):
    """The cluster class at its partition edges (4 rows of L = Ld = 256 in
    clusters of 8: 32 delta slots and 32 state slots a CTA): the trim's
    target at the merged row's first entry (TRIM 1, CLR) and at its last,
    a raised cutoff at the first and at the last merged entry, a delta
    of a few entries repeated over every CTA's share (the dedup compares
    across the edges), and rows the sparse rule flags; bit for bit
    against the plain drain."""
    _force_class(monkeypatch, tlog, "cluster")
    k, length, ld = 4, 256, 256
    plan = tlog.drain_plan(k, length, ld, 3 if wide else 2)
    assert plan.rows.kind == "cluster" and plan.rows.cluster == 8 and plan.ldp == 32
    rng = np.random.default_rng(len(case) + 11 * wide)
    lens = np.array([0, 40, 100, 200 if case == "overflow" else 150])
    st, ts, vid = _tlog_state(rng, k, length, lens, wide, dev)
    rows = np.arange(k)
    d_ts, d_vid, d_cut = _tlog_delta(rng, ts, vid, lens, rows, ld, dev)
    d_cut.zero_()
    if case == "repeats":  # three entries over all 256 columns
        pick = torch.from_numpy(rng.integers(0, 3, (k, ld))).to(dev)
        d_ts.copy_(torch.gather(d_ts[:, :3], 1, pick))
        d_vid.copy_(torch.gather(d_vid[:, :3].abs(), 1, pick))
    ki = torch.arange(k, dtype=torch.int32, device=dev)
    noop = torch.full((k,), tlog.TRIM_NOOP, dtype=torch.int64, device=dev)
    merged = _clone(st)
    tlog.drain_sparse_plain(merged, ki, d_ts, d_vid, d_cut, noop)
    m = merged.length.long()
    counts = noop
    if case == "trim_first":
        counts = torch.ones(k, dtype=torch.int64, device=dev)
    elif case == "trim_last":
        counts = m.clone()
    elif case == "clr":
        counts = torch.zeros(k, dtype=torch.int64, device=dev)
    elif case in ("cut_first", "cut_last"):
        # ts of the merged row's first (latest) or last (oldest) entry
        at = torch.zeros_like(m) if case == "cut_first" else (m - 1).clamp(min=0)
        pl = [p for p in merged[:3] if p is not None]
        low = (~pl[-2].long().gather(1, at[:, None])[:, 0]) & 0xFFFFFFFF
        hi = ((~pl[0].long().gather(1, at[:, None])[:, 0]) & 0xFFFFFFFF) if wide else 0
        d_cut.copy_(torch.where(m > 0, (hi << 32) | low, torch.zeros_like(low)))
    sk, sp = _clone(st), _clone(st)
    out_k = tlog.drain_sparse(sk, ki, d_ts, d_vid, d_cut, counts)
    out_p = tlog.drain_sparse_plain(sp, ki, d_ts, d_vid, d_cut, counts)
    torch.cuda.synchronize()
    assert _equal(out_k, out_p) and _equal(sk, sp)
    if case == "overflow":
        assert out_k[0].any()
    if case == "repeats":
        assert (sk.length.long() - torch.from_numpy(lens).to(dev) <= 3).all()


@pytest.mark.cuda
def test_tlog_wrappers_reject_what_the_kernel_does_not_take(dev):
    st = tlog.init(8, 16, False, dev)
    ki = torch.zeros(2, dtype=torch.int32, device=dev)
    d_ts = torch.zeros((2, 4), dtype=torch.int64, device=dev)
    cnt = torch.zeros(2, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        tlog.drain_sparse(st, ki.long(), d_ts, d_ts, cnt, cnt)
    with pytest.raises(ValueError):
        tlog.drain_sparse(st, ki, d_ts.int(), d_ts, cnt, cnt)
    with pytest.raises(ValueError):
        tlog.drain_sparse(st, ki, d_ts[:, :0], d_ts[:, :0], cnt, cnt)
    with pytest.raises(ValueError):
        tlog.drain_dense(st, d_ts, d_ts, cnt, ki, cnt)  # 2 rows, K = 8


def test_cpu_tensors_run_the_plain_versions():
    """A CPU state never reaches a kernel: the launch counts stay put."""
    before = (gcount.drain_dense.launches, pncount.drain_sparse.launches,
              tensor.join_dense.launches, tensor.converge_batch.launches,
              treg.drain_dense.launches, treg.drain_sparse.launches,
              tlog.drain_dense.launches, tlog.drain_sparse.launches)
    st = gcount.init(8, 4, "cpu")
    every = torch.arange(8, dtype=torch.int32)
    gcount.drain_dense(st, every, torch.ones((8, 4), dtype=torch.int64))
    pn = pncount.init(8, 4, "cpu")
    ki = torch.tensor([1, 2**31 - 1], dtype=torch.int32)
    z = torch.ones((2, 4), dtype=torch.int64)
    assert pncount.drain_sparse(pn, ki, z, z).tolist() == [0, 0]
    tensor.join_dense(tensor.init(2, 4, "cpu"), tensor.init(2, 4, "cpu"))
    tensor.converge_batch(tensor.init(2, 8, "cpu"), ki, *tensor.init(2, 8, "cpu"))
    rs = treg.init(4, "cpu")
    treg.drain_dense(rs, every[:4], *treg.init(4, "cpu"))
    treg.drain_sparse(rs, ki, *treg.init(2, "cpu"))
    ls = tlog.init(4, 8, True, "cpu")
    one = torch.ones((4, 1), dtype=torch.int64)
    tlog.drain_dense(ls, one, one, one[:, 0], ki, one[:2, 0])
    tlog.drain_sparse(ls, ki, one[:2], one[:2], one[:2, 0], one[:2, 0])
    uj = (udev.join_rows.launches, ures.fold_flat.launches)
    grid = _ujson_planes(np.random.default_rng(1), (2, 3), 4, 4, 4, 29, "cpu")
    ures.fold_flat(grid, 29)
    udev.join_rows(udev.DocBatch(*(p[:, 0] for p in grid)),
                   udev.DocBatch(*(p[:, 1] for p in grid)), 29)
    assert (udev.join_rows.launches, ures.fold_flat.launches) == uj
    assert (gcount.drain_dense.launches, pncount.drain_sparse.launches,
            tensor.join_dense.launches) == before[:3]
    assert (tensor.converge_batch.launches, treg.drain_dense.launches,
            treg.drain_sparse.launches, tlog.drain_dense.launches,
            tlog.drain_sparse.launches) == before[3:]
    assert ls.length.tolist() == [1, 1, 1, 1]
    assert st.counts.sum().item() == 32


# ---- UJSON -------------------------------------------------------------------


def _ujson_planes(rng, lead, l, c, r, shift, device, empty=(), wrap=False):
    """Random DocBatch planes shaped lead + (width,): per row a random
    share of sorted, duplicate-free dots (random payload ids) and cloud
    entries, pads after; rows in ``empty`` hold nothing. Wide rows mix
    seqs near 2^32 and columns past 2^31 (bit 63 set), with ``wrap`` also
    columns 2^32 - 4 to 2^32 - 2 (the flat fold indexes vv from its end
    with them, the join matches no column); a few vv entries sit at the
    u32 wrap."""
    n = int(np.prod(lead))
    wide = shift == 32
    dt = np.uint64 if wide else np.int64
    pad = np.uint64(2**64 - 1) if wide else 0x7FFFFFFF

    def row_plane(width):
        col = rng.integers(0, r, (n, width)).astype(dt)
        seq = rng.integers(1, 40, (n, width)).astype(dt)
        if wide:
            seq = np.where(rng.random((n, width)) < 0.2, dt(2**32 - 3) + seq % 3, seq)
            col = np.where(rng.random((n, width)) < 0.05, dt(2**31) + col % 2, col)
            if wrap:  # columns the flat fold indexes from the end of vv
                col = np.where(rng.random((n, width)) < 0.05, dt(2**32 - 2) - col % 3, col)
        v = (col << dt(shift)) | seq
        keep = rng.random((n, width)) < rng.random((n, 1)) * 1.2
        keep[list(empty)] = False
        v = np.where(keep, v, pad)
        v.sort(1)
        v[:, 1:][v[:, 1:] == v[:, :-1]] = pad
        v.sort(1)
        return v.view(np.int64) if wide else v.astype(np.int32)

    dots, cloud = row_plane(l), row_plane(c)
    pad_t = -1 if wide else 0x7FFFFFFF
    pay = np.where(dots != pad_t, rng.integers(0, 200, (n, l)), -1).astype(np.int32)
    vv = rng.integers(0, 30, (n, r)).astype(np.uint32)
    vv[rng.random((n, r)) < 0.03] = 0xFFFFFFFF
    vv[list(empty)] = 0
    out = (dots, pay, vv.view(np.int32), cloud)
    return udev.DocBatch(*(torch.from_numpy(x.reshape(tuple(lead) + x.shape[1:])).to(device)
                           for x in out))


def _uj_equal(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


UJ_SHIFT = {"narrow": lambda r: udev.narrow_shift(r), "wide": lambda r: 32}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("n,la,lb,ca,cb,r", [
    (64, 8, 8, 4, 4, 8), (37, 16, 4, 8, 32, 12), (5, 300, 260, 64, 40, 4),
    (3, 16384, 16384, 64, 64, 8),  # rows past shared memory: a cluster of 8
])
def test_ujson_join_matches_plain(dev, layout, n, la, lb, ca, cb, r):
    rng = np.random.default_rng(n + la + r)
    shift = UJ_SHIFT[layout](r)
    a = _ujson_planes(rng, (n,), la, ca, r, shift, dev, empty=[0], wrap=True)
    b = _ujson_planes(rng, (n,), lb, cb, r, shift, dev, empty=[1 % n], wrap=True)
    if la == 16384:
        assert udev.join_work_bytes(4, la, lb, ca, cb, r) > udev.SMEM_LIMIT
    for sort_output in (True, False):
        before = udev.join_rows.launches
        got = udev.join_rows(a, b, shift, sort_output=sort_output)
        want = udev.join_rows_plain(a, b, shift, sort_output=sort_output)
        torch.cuda.synchronize()
        assert udev.join_rows.launches == before + 1
        assert _uj_equal(got, want)
    one = udev.DocBatch(*(p[:1] for p in b))  # the broadcast of one row
    assert _uj_equal(udev.join_rows(a, one, shift), udev.join_rows_plain(a, one, shift))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("cap,n,l,c,lf,cf,r", [
    (40, 16, 16, 8, 8, 8, 8), (9, 8, 64, 32, 128, 64, 16), (4, 4, 4, 4, 12000, 9000, 4),
])
def test_ujson_join_epilogue_matches_plain(dev, layout, cap, n, l, c, lf, cf, r):
    """The subset join with the compaction + fit epilogue, written in
    place (widths kept) and into refitted planes (grown and shrunk), pad
    slots at identity row 0; then the broadcast with free rows."""
    rng = np.random.default_rng(cap * n + lf)
    shift = UJ_SHIFT[layout](r)
    res = _ujson_planes(rng, (cap,), l, c, r, shift, dev, empty=[0], wrap=True)
    live = min(n - 1, cap - 1)
    folded = _ujson_planes(rng, (n,), lf, cf, r, shift, dev, empty=range(live, n),
                           wrap=True)
    idx = np.zeros(n, np.int32)
    idx[:live] = rng.choice(np.arange(1, cap), live, replace=False)
    idx = torch.from_numpy(idx).to(dev)
    for out_w, out_c in ((l, c), (2 * l, c // 2), (l // 2, 4 * c)):
        rk = udev.DocBatch(*(p.clone() for p in res))
        rp = udev.DocBatch(*(p.clone() for p in res))
        got = udev.join_rows(rk, folded, shift, a_idx=idx, finish=(out_w, out_c),
                             out=ures.slice_widths(rk, out_w, out_c))
        want = udev.join_rows_plain(rp, folded, shift, a_idx=idx, finish=(out_w, out_c),
                                    out=ures.slice_widths(rp, out_w, out_c))
        torch.cuda.synchronize()
        assert _uj_equal(got, want)
        if (out_w, out_c) == (l, c):
            assert got.dots.data_ptr() == rk.dots.data_ptr()  # in place
    occ = torch.from_numpy(rng.random(cap) < 0.7).to(dev)
    occ[0] = False
    one = udev.DocBatch(*(p[:1] for p in folded))
    for fn in (udev.join_rows, udev.join_rows_plain):
        r_ = udev.DocBatch(*(p.clone() for p in res))
        out = fn(r_, one, shift, finish=(l, c), occupied=occ,
                 out=ures.slice_widths(r_, l, c))
        if fn is udev.join_rows:
            got = out
    assert _uj_equal(got, out)
    assert not got.vv[~occ].any()


def _flat_grid(rng, k, d, w, c, r, shift, dev):
    """Random delta stacks (dots repeat across deltas under other payload
    ids, so the last-copy rule decides) with key 0 empty (it folds to the
    identity); with k >= 3 and d >= 2, key 1 holds the least dot in every
    delta under other ids (it survives, and the last delta's id is kept),
    and every entry of key 2 dies (its delta 0 holds no dots and covers
    every dot: vv at the u32 wrap)."""
    g = _ujson_planes(rng, (k, d), w, c, r, shift, "cpu", empty=range(d), wrap=True)
    if k >= 3 and d >= 2:
        g.dots[1, :, 0] = 0
        g.pay[1, :, 0] = torch.arange(d, dtype=torch.int32) + 1000
        g.vv[2] = -1
        g.dots[2, 0] = udev.pad_of(g.dots)
        g.pay[2, 0] = -1
    return udev.DocBatch(*(p.to(dev) for p in g))


def _check_flat(grid, shift, klass=None):
    before = ures.fold_flat.launches
    n_class = ures.fold_flat.classes.get(klass, 0)
    got = ures.fold_flat(grid, shift)
    want = ures.fold_flat_plain(grid, shift)
    torch.cuda.synchronize()
    assert ures.fold_flat.launches == before + 1
    if klass is not None:
        assert ures.fold_flat.classes[klass] == n_class + 1
    assert _uj_equal(got, want)
    pad = udev.pad_of(grid.dots)
    assert (got.dots[0] == pad).all() and (got.pay[0] == -1).all()
    k, d = grid.dots.shape[:2]
    if k >= 3 and d >= 2:
        assert got.dots[1, 0].item() == 0 and got.pay[1, 0].item() == 1000 + d - 1
        assert (got.dots[2] == pad).all()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("k,d,w,c,r", [
    (9, 1, 4, 4, 8), (40, 7, 4, 8, 8), (16, 64, 4, 4, 12), (3, 64, 8, 16, 4),
    (5, 33, 40, 36, 8),  # two 32-entry words a row
    (2, 64, 512, 64, 8), (2, 64, 1024, 64, 8),  # few wide keys: a cluster of 8
    (2, 64, 8192, 64, 8),  # past one CTA's shared memory
    (4096, 64, 4, 4, 32), (64, 64, 4, 4, 32),  # the flat leg's keys
])
def test_ujson_fold_flat_matches_plain(dev, layout, k, d, w, c, r):
    """The flat fold in the class flat_plan picks, bit for bit against
    the plain fold: empty keys fold to the identity, a dot held by every
    delta keeps the last delta's payload id, a key whose entries all die
    folds to pads."""
    rng = np.random.default_rng(k * d + w)
    shift = UJ_SHIFT[layout](r)
    grid = _flat_grid(rng, k, d, w, c, r, shift, dev)
    plan = ures.flat_plan(k, grid.dots.element_size(), d, w, c, r)
    if w >= 512:
        assert plan.kind == "cluster" and plan.cluster == 8
    if w == 8192:
        assert ures.flat_work_bytes(4, d, w, c, r) > udev.SMEM_LIMIT
    _check_flat(grid, shift, plan.kind)


FLAT_REG_SHAPES = [(9, 1, 4, 4, 8), (40, 7, 4, 8, 8), (70, 64, 4, 4, 32), (6, 64, 8, 8, 8),
                   (5, 40, 3, 5, 4)]
FLAT_WIDE_SHAPES = [(5, 33, 40, 36, 8), (3, 20, 64, 40, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("klass,k,d,w,c,r", [
    (klass, *shape) for klass in ("warp", "cta", "cluster")
    for shape in FLAT_REG_SHAPES + ([] if klass == "warp" else FLAT_WIDE_SHAPES)])
def test_ujson_fold_flat_classes_match_plain(dev, monkeypatch, klass, layout, k, d, w, c, r):
    """Each class of ujson_fold_flat forced in turn (a warp per key with
    its deltas in registers, a CTA with its rows in shared memory, a
    cluster of CTAs reading device memory), bit for bit against the plain
    fold; the clusters stride over several keys each."""
    from jylis_tpu_torch.ops import row_plan

    monkeypatch.setattr(ures, "FLAT_CLASS", klass)
    rng = np.random.default_rng(k * d + w + len(klass))
    shift = UJ_SHIFT[layout](r)
    grid = _flat_grid(rng, k, d, w, c, r, shift, dev)
    plan = ures.flat_plan(k, grid.dots.element_size(), d, w, c, r)
    if klass == "cluster":  # two clusters: each folds several keys
        monkeypatch.setattr(row_plan, "SCRATCH_LIMIT", 2 * plan.stride)
        plan = ures.flat_plan(k, grid.dots.element_size(), d, w, c, r)
        assert plan.grid == 2 * plan.cluster
    assert plan.kind == klass
    _check_flat(grid, shift, klass)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("step", range(6))
def test_ujson_fold_flat_at_the_class_boundaries(dev, layout, step):
    """The flat fold at chip_smoke.py's class boundaries of flat_plan and
    one step past each (a warp, then a CTA; a CTA, then a cluster, at 16
    and at 132 keys), bit for bit against the plain fold."""
    import chip_smoke

    k, d, w, c, r = chip_smoke.UJ_FLAT_BOUNDARIES[4 if layout == "narrow" else 8][step]
    rng = np.random.default_rng(k + w + step)
    shift = UJ_SHIFT[layout](r)
    grid = _flat_grid(rng, k, d, w, c, r, shift, dev)
    plan = ures.flat_plan(k, grid.dots.element_size(), d, w, c, r)
    assert plan.kind == ["warp", "cta", "cta", "cluster", "cta", "cluster"][step]
    _check_flat(grid, shift, plan.kind)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("k,d", [(4, 70), (2, 130)])
def test_ujson_tree_fold_matches_plain(dev, layout, k, d):
    """fold_segments' levels (one join launch each) against the same
    levels in plain torch on the CPU."""
    rng = np.random.default_rng(k * d)
    shift = UJ_SHIFT[layout](8)
    grid = _ujson_planes(rng, (k, d), 4, 4, 8, shift, dev)
    before = udev.join_rows.launches
    got = udev.fold_segments(grid, shift)
    want = udev.fold_segments(udev.DocBatch(*(p.cpu() for p in grid)), shift)
    assert udev.join_rows.launches > before
    assert _uj_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("klass", ["warp", "cta", "cluster", "scratch"])
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("n,la,lb,ca,cb,r", [
    (64, 4, 4, 4, 4, 8), (37, 16, 4, 8, 32, 12), (9, 200, 260, 64, 40, 4),
    (3, 2048, 2048, 64, 64, 8),  # a warp's slice of 38 KB narrow: 3 rows a CTA
])
def test_ujson_join_classes_match_plain(dev, monkeypatch, klass, layout, n, la, lb, ca,
                                        cb, r):
    """Every class of ujson_join, bit for bit against the plain join:
    sorted and unsorted, the broadcast of one row (b step 0), the
    epilogue written in place at a subset of rows (a_idx, pad slots at
    the identity row 0) and into refitted planes, and the broadcast
    with free rows (occupied)."""
    rng = np.random.default_rng(n + la + r + len(klass))
    klass = _force_class(monkeypatch, udev, klass)
    shift = UJ_SHIFT[layout](r)
    a = _ujson_planes(rng, (n,), la, ca, r, shift, dev, empty=[0])
    b = _ujson_planes(rng, (n,), lb, cb, r, shift, dev, empty=[1 % n])
    assert udev.plan_join(n, a.dots.element_size(), la, lb, ca, cb, r).kind == klass
    for sort_output in (True, False):
        before = udev.join_rows.classes.get(klass, 0)
        got = udev.join_rows(a, b, shift, sort_output=sort_output)
        want = udev.join_rows_plain(a, b, shift, sort_output=sort_output)
        torch.cuda.synchronize()
        assert udev.join_rows.classes[klass] == before + 1
        assert _uj_equal(got, want)
    one = udev.DocBatch(*(p[:1] for p in b))
    assert _uj_equal(udev.join_rows(a, one, shift), udev.join_rows_plain(a, one, shift))
    cap = n + 3
    res = _ujson_planes(rng, (cap,), la, ca, r, shift, dev, empty=[0])
    live = n - 1
    folded = _ujson_planes(rng, (n,), lb, cb, r, shift, dev, empty=range(live, n))
    idx = np.zeros(n, np.int32)
    idx[:live] = rng.choice(np.arange(1, cap), live, replace=False)
    idx = torch.from_numpy(idx).to(dev)
    for out_w, out_c in ((la, ca), (la + lb, max(1, ca // 2))):
        rk = udev.DocBatch(*(p.clone() for p in res))
        rp = udev.DocBatch(*(p.clone() for p in res))
        got = udev.join_rows(rk, folded, shift, a_idx=idx, finish=(out_w, out_c),
                             out=ures.slice_widths(rk, out_w, out_c))
        want = udev.join_rows_plain(rp, folded, shift, a_idx=idx, finish=(out_w, out_c),
                                    out=ures.slice_widths(rp, out_w, out_c))
        torch.cuda.synchronize()
        assert _uj_equal(got, want)
        if (out_w, out_c) == (la, ca):
            assert got.dots.data_ptr() == rk.dots.data_ptr()  # in place
    occ = torch.from_numpy(rng.random(cap) < 0.6).to(dev)
    occ[0] = False
    one = udev.DocBatch(*(p[:1] for p in folded))
    outs = []
    for fn in (udev.join_rows, udev.join_rows_plain):
        r_ = udev.DocBatch(*(p.clone() for p in res))
        outs.append(fn(r_, one, shift, finish=(la, ca), occupied=occ,
                       out=ures.slice_widths(r_, la, ca)))
    assert _uj_equal(*outs)
    assert not outs[0].vv[~occ].any()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("live", [7, 13, 64])
def test_ujson_join_cluster_partition_edges(dev, monkeypatch, layout, live):
    """The cluster class where its partition edges split twins: b's rows
    hold a's dots and cloud entries (and some of their own), so the merge
    alternates equal entries and an odd window puts a dot and its twin,
    or a cloud entry and its repeat, in neighbouring CTAs; sorted and
    unsorted, the epilogue in place at a subset of rows (a_idx), and the
    broadcast into free and occupied rows, bit for bit against the plain
    join."""
    _force_class(monkeypatch, udev, "cluster")
    rng = np.random.default_rng(live + len(layout))
    r, n, width = 8, 6, 64
    shift = UJ_SHIFT[layout](r)
    a = _ujson_planes(rng, (n,), width, width, r, shift, dev, empty=[0])
    b = _ujson_planes(rng, (n,), width, width, r, shift, dev)
    pad = udev.pad_of(a.dots)
    bias = (1 << 63) if layout == "wide" else 0  # wide rows sort unsigned

    def sort_rows(x):
        return torch.gather(x, 1, (x ^ bias).sort(1).indices)

    for x, y in ((a.dots, b.dots), (a.cloud, b.cloud)):
        # b: a's first `live` entries, then b's own, sorted and deduplicated
        both = sort_rows(torch.cat([x[:, :live], y[:, : width - live]], 1))
        both[:, 1:][both[:, 1:] == both[:, :-1]] = pad
        y.copy_(sort_rows(both))
    b.pay.copy_(torch.where(b.dots == pad, -1, b.pay.abs()))
    a.vv.zero_()
    plan = udev.plan_join(n, a.dots.element_size(), width, width, width, width, r)
    assert plan.kind == "cluster" and plan.cluster == 8
    for sort_output in (True, False):
        got = udev.join_rows(a, b, shift, sort_output=sort_output)
        want = udev.join_rows_plain(a, b, shift, sort_output=sort_output)
        assert _uj_equal(got, want)
    idx = torch.tensor([3, 1, 4, 2, 5, 0], dtype=torch.int32, device=dev)
    rk = udev.DocBatch(*(p.clone() for p in a))
    rp = udev.DocBatch(*(p.clone() for p in a))
    got = udev.join_rows(rk, b, shift, a_idx=idx, finish=(width, width), out=rk)
    want = udev.join_rows_plain(rp, b, shift, a_idx=idx, finish=(width, width), out=rp)
    torch.cuda.synchronize()
    assert got.dots.data_ptr() == rk.dots.data_ptr()  # in place: out is a
    assert _uj_equal(got, want)
    occ = torch.tensor([False, True, True, False, True, True], device=dev)
    one = udev.DocBatch(*(p[2:3] for p in b))
    outs = []
    for fn in (udev.join_rows, udev.join_rows_plain):
        r_ = udev.DocBatch(*(p.clone() for p in a))
        outs.append(fn(r_, one, shift, finish=(width // 2, 2 * width), occupied=occ,
                       out=ures.slice_widths(r_, width // 2, 2 * width)))
    torch.cuda.synchronize()
    assert _uj_equal(*outs)


@pytest.mark.cuda
def test_ujson_wrappers_reject_what_the_kernels_do_not_take(dev):
    a = _ujson_planes(np.random.default_rng(2), (4,), 8, 4, 8, 28, dev)
    with pytest.raises(ValueError):
        udev.join_rows(a, a, 32)  # int32 dots at the wide shift
    with pytest.raises(ValueError):
        udev.join_rows(a, a, 28, a_idx=torch.zeros(4, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        udev.join_rows(a, udev.DocBatch(*(p[:2] for p in a)), 28)
    t = udev.DocBatch(a.dots.t().contiguous().t(), *a[1:])
    with pytest.raises(ValueError):
        udev.join_rows(t, a, 28)
    g = udev.DocBatch(*(p[None] for p in a))
    with pytest.raises(ValueError):
        ures.fold_flat(g, 32)


# ---- the mesh: replica_join and the per-shard routes -----------------------------


def _cpu_and_cuda_meshes(n, rep=1):
    from jylis_tpu_torch.parallel import make_mesh

    return (make_mesh(n, rep=rep, devices=["cpu"] * n),
            make_mesh(n, rep=rep, devices=["cuda"] * n))


@pytest.mark.cuda
@pytest.mark.parametrize("s,k", [(1, 1), (7, 1000), (7, 1001), (8, 4099), (64, 3000),
                                 (9, 70001)])
def test_replica_join_matches_plain(dev, s, k):
    """Columns at 0 and 2^64-1 and half the values >= 2^63: the kernel's
    unsigned max against the plain version's biased signed one."""
    from jylis_tpu_torch.parallel import replica_join, replica_join_plain

    rng = np.random.default_rng(s * k)
    x = _u64(rng, (s, k))
    x[:, 0] = 0
    if k > 1:
        x[-1, 1] = np.uint64(2**64 - 1)
    xt = planes.to_tensor(x, dev)
    before = replica_join.launches
    got = replica_join(xt)
    torch.cuda.synchronize()
    assert replica_join.launches == before + 1
    assert got.shape == (k,) and torch.equal(got, replica_join_plain(xt))
    np.testing.assert_array_equal(planes.to_u64_np(got), x.max(axis=0))


@pytest.mark.cuda
def test_replica_join_rejects_what_the_kernel_does_not_take(dev):
    from jylis_tpu_torch.parallel import replica_join

    x = torch.zeros((4, 6), dtype=torch.int64, device=dev)
    for bad in (x.to(torch.int32), x.t(), x[:0], x[0]):
        with pytest.raises(ValueError):
            replica_join(bad)


@pytest.mark.cuda
@pytest.mark.parametrize("s,rep,n", [(8, 4, 8), (12, 4, 8), (7, 1, 4), (64, 1, 4)])
def test_join_replica_axis_on_a_cuda_mesh(dev, s, rep, n):
    from jylis_tpu_torch import parallel as tpar

    rng = np.random.default_rng(s + rep)
    x = _u64(rng, (s, 16 * n))
    cm, gm = _cpu_and_cuda_meshes(n, rep)
    want = tpar.gather_grid(tpar.join_replica_axis(cm, tpar.shard_grid(cm, x)))
    before = tpar.replica_join.launches
    got = tpar.gather_grid(tpar.join_replica_axis(gm, tpar.shard_grid(gm, x)))
    launches = n if rep == 1 else n + n // rep
    assert tpar.replica_join.launches == before + launches
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_sharded_drains_on_a_cuda_mesh_match_the_cpu_mesh(dev):
    """GCOUNT, PNCOUNT, TREG and TLOG routed drains on [cuda] * 4 against
    the same drains on [cpu] * 4 (the plain versions): one launch per
    shard, per-slot outputs and the gathered states equal."""
    from jylis_tpu_torch import parallel as tpar

    rng = np.random.default_rng(12)
    n, k, r = 4, 256, 8
    cm, gm = _cpu_and_cuda_meshes(n)
    rows = rng.choice(k, 70, replace=False)
    cases = [
        (gcount, gcount.from_counts(_u64(rng, (k, r)), "cpu"), _u64(rng, (70, r)),
         tpar.drain_sharded_g, ()),
        (pncount, pncount.from_counts(_u64(rng, (k, r)), _u64(rng, (k, r)), "cpu"),
         _u64(rng, (70, 2 * r)), tpar.drain_sharded_pn, ()),
        (treg, treg.init(k, "cpu"),
         np.stack([rng.integers(0, 3, 70), rng.integers(0, 3, 70),
                   rng.integers(0, 9, 70)], 1).astype(np.uint64), tpar.drain_sharded_treg, ()),
    ]
    ld = 4
    pay = np.concatenate([rng.integers(0, 30, (70, ld)), rng.integers(0, 5, (70, ld)),
                          rng.integers(0, 4, (70, 1)),
                          np.where(rng.random((70, 1)) < 0.3, 2, tlog.TRIM_NOOP)],
                         1).astype(np.uint64)
    cases.append((tlog, tlog.init(k, 16, True, "cpu"), pay, tpar.drain_sharded_tlog, (ld,)))
    for mod, st, payload, fn, extra in cases:
        lr, p, slots = tpar.route_drain(rows, payload, n, k // n)
        sc, sg = tpar.shard_state(cm, st), tpar.shard_state(gm, st)
        before = mod.drain_sparse.launches
        got = fn(gm, sg, lr, p, *extra)
        want = fn(cm, sc, lr, p, *extra)
        assert mod.drain_sparse.launches == before + n
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)
        gs, cs = tpar.gather_state(sg), tpar.gather_state(sc)
        assert all((a is None and b is None) or torch.equal(a.cpu(), b)
                   for a, b in zip(gs, cs))


# ---- the staged, unrouted sparse drains ---------------------------------------


def _split_parts(st, n):
    """A state cut into n contiguous shards, each its own allocation."""
    rps = st[0].shape[0] // n
    return [type(st)(*(p[i * rps:(i + 1) * rps].clone() for p in st)) for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [gcount, pncount], ids=["G", "PN"])
@pytest.mark.parametrize("n", [1, 4])
def test_counter_drain_over_a_shard_table_matches_plain(dev, mod, n):
    """counter_drain_sparse over a table of n shards on one card, given
    live global rows only (B = the live rows, no pads): bit for bit
    against the plain version of the same table, results at the slots;
    then a table of the last shards alone writes only their slots."""
    from jylis_tpu_torch.ops.staging import ShardTable

    rng = np.random.default_rng(50 + n)
    k, r, b = 4096, 16, 1000
    st = _state(mod, rng, k, r, dev)
    rps = k // n
    parts, plain = _split_parts(st, n), _split_parts(st, n)
    ki = torch.from_numpy(rng.choice(k, b, replace=False).astype(np.int32)).to(dev)
    deltas = [planes.to_tensor(_u64(rng, (b, r)), dev) for _ in st]
    out = torch.full((b,), 77, dtype=torch.int64, device=dev)
    before = mod.drain_sparse.launches
    mod.drain_sparse(ShardTable(parts, rps), ki, *deltas, out)
    want = mod.drain_sparse_plain(ShardTable(plain, rps), ki, *deltas)
    torch.cuda.synchronize()
    assert mod.drain_sparse.launches == before + 1
    assert torch.equal(out, want) and all(_equal(a, c) for a, c in zip(parts, plain))
    first = n // 2
    out = torch.full((b,), 77, dtype=torch.int64, device=dev)
    mod.drain_sparse(ShardTable(parts[first:], rps, first), ki, *deltas, out)
    want = mod.drain_sparse_plain(ShardTable(plain[first:], rps, first), ki, *deltas,
                                  torch.full((b,), 77, dtype=torch.int64, device=dev))
    torch.cuda.synchronize()
    mine = (ki.long() // rps) >= first
    assert torch.equal(out, want) and (out[~mine] == 77).all()
    assert all(_equal(a, c) for a, c in zip(parts, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4])
def test_treg_drain_over_a_shard_table_matches_plain(dev, n):
    from jylis_tpu_torch.ops.staging import ShardTable

    rng = np.random.default_rng(60 + n)
    k, b = 4096, 1500
    st = treg.TRegState(*_treg(rng, k, dev))
    rps = k // n
    parts, plain = _split_parts(st, n), _split_parts(st, n)
    rows = rng.choice(k, b, replace=False)
    d = _treg(rng, b, dev, like=(st, rows))
    ki = torch.from_numpy(rows.astype(np.int32)).to(dev)
    out = (torch.zeros(b, dtype=torch.bool, device=dev),
           torch.full((b,), 77, dtype=torch.int64, device=dev),
           torch.full((b,), 77, dtype=torch.int32, device=dev))
    before = treg.drain_sparse.launches
    treg.drain_sparse(ShardTable(parts, rps), ki, *d, out)
    want = treg.drain_sparse_plain(ShardTable(plain, rps), ki, *d)
    torch.cuda.synchronize()
    assert treg.drain_sparse.launches == before + 1
    assert _equal(out, want) and all(_equal(a, c) for a, c in zip(parts, plain))
    assert out[0].any() and not (out[1] == 77).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g", "pn", "treg"])
def test_unrouted_drains_on_one_card_match_the_cpu(dev, name):
    """drain_unrouted_* over a 4-shard keyspace on [cuda] * 4 against the
    same on [cpu] * 4: one staged copy each way and one launch a drain,
    per-slot outputs and the gathered state equal."""
    from jylis_tpu_torch import parallel as tpar
    from jylis_tpu_torch.ops.staging import Stage

    rng = np.random.default_rng(70)
    n, k, r, b = 4, 1024, 8, 300
    cm, gm = _cpu_and_cuda_meshes(n)
    rows = rng.choice(k, b, replace=False)
    if name == "treg":
        mod, fn, st = treg, tpar.drain_unrouted_treg, treg.init(k, "cpu")
        fields = (rng.integers(0, 3, b).astype(np.uint64), rng.integers(0, 3, b).astype(np.uint64),
                  rng.integers(0, 9, b).astype(np.int32))
    elif name == "g":
        mod, fn = gcount, tpar.drain_unrouted_g
        st, fields = gcount.from_counts(_u64(rng, (k, r)), "cpu"), (_u64(rng, (b, r)),)
    else:
        mod, fn = pncount, tpar.drain_unrouted_pn
        st = pncount.from_counts(_u64(rng, (k, r)), _u64(rng, (k, r)), "cpu")
        fields = (_u64(rng, (b, r)), _u64(rng, (b, r)))
    ksc, ksg = tpar.Keyspace(cm, "cpu"), tpar.Keyspace(gm, "cuda")
    ksc.place(st)
    ksg.place(st)
    counts = (mod.drain_sparse.launches, Stage.uploads, Stage.downloads)
    got = fn(ksg, rows, tpar.fill_from(*fields))
    assert (mod.drain_sparse.launches, Stage.uploads, Stage.downloads) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)
    want = fn(ksc, rows, tpar.fill_from(*fields))
    for g, w in zip(got if name == "treg" else (got,), want if name == "treg" else (want,)):
        np.testing.assert_array_equal(g, w)
    assert all(torch.equal(a.cpu(), c) for a, c in zip(ksg.whole(), ksc.whole()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g", "pn", "treg"])
def test_dense_staged_drains_on_one_card_match_the_cpu(dev, monkeypatch, name):
    """The repos' dense path (drain_unrouted_* with dense=True) on a
    single-device keyspace on the card against the same on the CPU: one
    staged copy each way and one launch a call, per-slot outputs, every
    row's output and the state equal, the counters' slot map clean (TREG
    has none); a call that raised (a misaligned staged delta, a wrong vid
    type) leaves the map dirty and the next refills it; three staged
    calls when the batch overflows the Stage; after a grow a clean map
    of the new capacity on the card."""
    from jylis_tpu_torch import parallel as tpar
    from jylis_tpu_torch.ops import staging
    from jylis_tpu_torch.ops.staging import Stage

    rng = np.random.default_rng(75)
    k, r = 1024, 16
    if name == "treg":
        mod, st, per_slot = treg, treg.TRegState(*_treg(rng, k, "cpu")), 4 + 20

        def fields(b):
            ts, rank, vid = _treg(rng, b, "cpu")
            return planes.to_u64_np(ts), planes.to_u64_np(rank), vid.numpy()

        def fn(ks, rows, f):
            return tpar.drain_unrouted_treg(ks, rows, tpar.fill_from(*f), dense=True)
    else:
        mod = gcount if name == "g" else pncount
        unrouted = tpar.drain_unrouted_g if name == "g" else tpar.drain_unrouted_pn
        st = (gcount.from_counts(_u64(rng, (k, r)), "cpu") if name == "g" else
              pncount.from_counts(_u64(rng, (k, r)), _u64(rng, (k, r)), "cpu"))
        per_slot = 4 + 8 * r * len(st)

        def fields(b):
            return tuple(_u64(rng, (b, r)) for _ in st)

        def fn(ks, rows, f):
            return (unrouted(ks, rows, tpar.fill_from(*f), dense=True),)
    ksc, ksg = tpar.Keyspace(None, "cpu"), tpar.Keyspace(None, dev)
    ksc.place(_clone(st))
    ksg.place(type(st)(*(p.to(dev) for p in st)))

    def both(rows, f, calls=1):
        counts = (mod.drain_dense.launches, Stage.uploads, Stage.downloads)
        got = fn(ksg, rows, f)
        assert (mod.drain_dense.launches, Stage.uploads, Stage.downloads) == (
            counts[0] + calls, counts[1] + calls, counts[2] + calls)
        want = fn(ksc, rows, f)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert torch.equal(ksg.dense_plan().full.cpu(), ksc.dense_plan().full)
        assert all(torch.equal(a.cpu(), c) for a, c in zip(ksg.parts[0], ksc.parts[0]))
        if name == "treg":
            assert ksg.slots is None
        else:
            assert (ksg.slots.map == -1).all() and not ksg.slots.dirty

    for b in (k // 4, k):
        both(_dense_rows(rng, k, b), fields(b))
    plan = ksg.dense_plan()
    ki = torch.arange(8, dtype=torch.int32, device=dev) * 3
    if name == "treg":  # an int64 vid: the staged view's check raises
        with pytest.raises(ValueError):
            mod.drain_dense(plan, ki, *(torch.zeros(8, dtype=torch.int64, device=dev),) * 3)
    else:
        buf = torch.zeros(8 * r + 1, dtype=torch.int64, device=dev)[1:].view(8, r)
        with pytest.raises(ValueError, match="aligned"):
            mod.drain_dense(plan, ki, *(buf,) * len(st))
    if name != "treg":
        assert ksg.slots.dirty
        ksg.slots.map[ki.long()] = 5  # what a failed walk could leave behind
    both(_dense_rows(rng, k, k // 2), fields(k // 2))
    b = k // 2
    monkeypatch.setattr(staging, "MAX_STAGE_BYTES", 200 * per_slot + 8 * staging.ALIGN)
    both(_dense_rows(rng, k, b), fields(b), calls=3)
    monkeypatch.undo()
    grow = (lambda s: treg.grow(s, 2 * k)) if name == "treg" else (
        lambda s: mod.grow(s, 2 * k, r))
    ksg.grow(grow)
    ksc.grow(grow)
    if name != "treg":
        assert ksg.slots.map.shape == (2 * k,) and ksg.slots.map.device.type == "cuda"
        assert (ksg.slots.map == -1).all()
    both(_dense_rows(rng, 2 * k, 2 * k), fields(2 * k))


@pytest.mark.cuda
def test_dense_drains_on_another_card_keep_the_current_device(dev):
    """On a host with two or more cards, the dense drains of keyspaces on
    the last card, with card 0 current: the C entry sets the plan's card
    for its launches and puts card 0 back, so no device context is
    entered; results equal the same drains on the CPU, one launch each,
    the counters' slot map clean (the test skips on one card)."""
    from jylis_tpu_torch import parallel as tpar

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more GPUs: the drains run on another card")
    last = torch.device(f"cuda:{cards - 1}")
    torch.cuda.set_device(0)
    rng = np.random.default_rng(85)
    k, r = 1024, 16
    rows = _dense_rows(rng, k, k // 2)
    cases = [
        (gcount, gcount.from_counts(_u64(rng, (k, r)), "cpu"), (_u64(rng, (k // 2, r)),),
         lambda ks, f: (tpar.drain_unrouted_g(ks, rows, tpar.fill_from(*f), dense=True),)),
        (pncount, pncount.from_counts(_u64(rng, (k, r)), _u64(rng, (k, r)), "cpu"),
         (_u64(rng, (k // 2, r)), _u64(rng, (k // 2, r))),
         lambda ks, f: (tpar.drain_unrouted_pn(ks, rows, tpar.fill_from(*f), dense=True),)),
        (treg, treg.TRegState(*_treg(rng, k, "cpu")),
         tuple(x.numpy().view(np.uint64) if x.dtype == torch.int64 else x.numpy()
               for x in _treg(rng, k // 2, "cpu")),
         lambda ks, f: tpar.drain_unrouted_treg(ks, rows, tpar.fill_from(*f), dense=True)),
    ]
    for mod, st, fields, drain in cases:
        ksg, ksc = tpar.Keyspace(None, last), tpar.Keyspace(None, "cpu")
        ksg.place(type(st)(*(p.to(last) for p in st)))
        ksc.place(_clone(st))
        before = (mod.drain_dense.launches, mod.drain_dense.by_card.get(last.index, 0))
        got, want = drain(ksg, fields), drain(ksc, fields)
        torch.cuda.synchronize(last)
        assert torch.cuda.current_device() == 0
        assert (mod.drain_dense.launches, mod.drain_dense.by_card.get(last.index, 0)) == (
            before[0] + 1, before[1] + 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert all(torch.equal(a.cpu(), c) for a, c in zip(ksg.parts[0], ksc.parts[0]))
        if mod is not treg:
            assert ksg.slots.map.device == last and (ksg.slots.map == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("per_card", [1, 2])
def test_unrouted_drains_over_several_cards_match_the_cpu(dev, per_card):
    """On a host with two or more cards, a keyspace of ``per_card``
    shards on each card against the same drains on the CPU: the host
    orders the slots by card in one counting pass, and each card with
    slots gets one staged copy each way and one launch."""
    from jylis_tpu_torch import parallel as tpar
    from jylis_tpu_torch.ops.staging import Stage

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more GPUs: the slots split over cards")
    devs = [f"cuda:{i // per_card}" for i in range(cards * per_card)]
    n, k, r = len(devs), 256 * len(devs), 8
    rng = np.random.default_rng(80 + per_card)
    rows = rng.choice(k, 500, replace=False)
    rows = rows[rows // (k // n) != 1]  # shard 1 gets no slot
    live = len({int(x) // (k // n) // per_card for x in rows})
    cases = [
        (gcount, tpar.drain_unrouted_g, gcount.from_counts(_u64(rng, (k, r)), "cpu"),
         (_u64(rng, (len(rows), r)),)),
        (pncount, tpar.drain_unrouted_pn,
         pncount.from_counts(_u64(rng, (k, r)), _u64(rng, (k, r)), "cpu"),
         (_u64(rng, (len(rows), r)), _u64(rng, (len(rows), r)))),
        (treg, tpar.drain_unrouted_treg, treg.init(k, "cpu"),
         (rng.integers(0, 3, len(rows)).astype(np.uint64),
          rng.integers(0, 3, len(rows)).astype(np.uint64),
          rng.integers(0, 9, len(rows)).astype(np.int32))),
    ]
    for mod, fn, st, fields in cases:
        ksg = tpar.Keyspace(tpar.make_mesh(n, devices=devs), "cuda")
        ksc = tpar.Keyspace(tpar.make_mesh(n, devices=["cpu"] * n), "cpu")
        ksg.place(st)
        ksc.place(st)
        assert len(ksg.cards) == cards
        counts = (mod.drain_sparse.launches, Stage.uploads, Stage.downloads)
        got = fn(ksg, rows, tpar.fill_from(*fields))
        assert (mod.drain_sparse.launches, Stage.uploads, Stage.downloads) == (
            counts[0] + live, counts[1] + live, counts[2] + live)
        want = fn(ksc, rows, tpar.fill_from(*fields))
        for g, w in zip(got if mod is treg else (got,), want if mod is treg else (want,)):
            np.testing.assert_array_equal(g, w)
        assert all(torch.equal(a.cpu(), c) for a, c in zip(ksg.whole(), ksc.whole()))


@pytest.mark.cuda
def test_sparse_wrappers_reject_misaligned_or_wrong_typed_buffers(dev):
    """A misaligned delta region, a wrong type of row, delta or output
    buffer, or a misaligned shard plane raises; nothing launches and
    nothing falls back to the plain version."""
    from jylis_tpu_torch.ops.staging import ShardTable

    st = gcount.init(64, 8, dev)
    ki = torch.arange(4, dtype=torch.int32, device=dev)
    d = torch.zeros((4, 8), dtype=torch.int64, device=dev)
    out = torch.zeros(4, dtype=torch.int64, device=dev)
    shifted = torch.zeros(4 * 8 + 1, dtype=torch.int64, device=dev)[1:].view(4, 8)
    rs = treg.init(64, dev)
    td = treg.init(4, dev)
    tout = (torch.zeros(4, dtype=torch.bool, device=dev),
            torch.zeros(4, dtype=torch.int64, device=dev),
            torch.zeros(4, dtype=torch.int32, device=dev))
    before = (gcount.drain_sparse.launches, treg.drain_sparse.launches)
    for bad in (
        lambda: gcount.drain_sparse(st, ki, shifted, out),  # 8 bytes off
        lambda: gcount.drain_sparse(st, ki.long(), d, out),
        lambda: gcount.drain_sparse(st, ki, d.int(), out),
        lambda: gcount.drain_sparse(st, ki, d, out.int()),
        lambda: gcount.drain_sparse(st, ki, d.cpu(), out),
        lambda: gcount.drain_sparse(ShardTable([gcount.GCountState(
            torch.zeros(64 * 8 + 1, dtype=torch.int64, device=dev)[1:].view(64, 8))], 64),
            ki, d, out),
        lambda: treg.drain_sparse(rs, ki.long(), *td, tout),
        lambda: treg.drain_sparse(rs, ki, td.ts, td.rank, td.vid.long(), tout),
        lambda: treg.drain_sparse(rs, ki, *td, (tout[0].byte(), *tout[1:])),
        lambda: treg.drain_sparse(rs, ki, *td, (tout[0], tout[1].int(), tout[2])),
    ):
        with pytest.raises(ValueError):
            bad()
    assert (gcount.drain_sparse.launches, treg.drain_sparse.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("d", [7, 64, 70])
def test_fold_join_aligned_matches_plain(dev, layout, d):
    """The mesh's row-aligned fold: the flat fold (or the tree past 64
    deltas), then one ujson_join with no row index, epilogue in place."""
    rng = np.random.default_rng(d)
    shift = UJ_SHIFT[layout](8)
    res = _ujson_planes(rng, (6,), 16, 16, 8, shift, dev)
    grid = _ujson_planes(rng, (6, d), 4, 4, 8, shift, dev, empty=range(d))
    cpu = udev.DocBatch(*(p.cpu() for p in res))
    before = udev.join_rows.launches
    got, live = ures.fold_join_aligned(res, grid, shift, 64, 64)
    want, wlive = ures.fold_join_aligned(cpu, udev.DocBatch(*(p.cpu() for p in grid)),
                                         shift, 64, 64)
    torch.cuda.synchronize()
    assert udev.join_rows.launches > before
    assert _uj_equal(got, want) and torch.equal(live.cpu(), wlive)


@pytest.mark.cuda
def test_dryrun_multichip_on_one_card(dev):
    from jylis_tpu_torch.parallel.dryrun import dryrun_multichip

    before = (gcount.drain_sparse.launches, pncount.drain_sparse.launches,
              tlog.drain_sparse.launches)
    dryrun_multichip(["cuda"] * 4)
    after = (gcount.drain_sparse.launches, pncount.drain_sparse.launches,
             tlog.drain_sparse.launches)
    # the routed converge and TLOG drain launch once per shard; the
    # PNCOUNT repos' staged drains once per card: one GET each drains
    assert after[0] - before[0] >= 4 and after[1] - before[1] == 2
    assert after[2] - before[2] >= 4


# ---- several cards: a node keys-sharded over every visible card ----------------------


def _cards(dev, shards: int = 4) -> list[str]:
    """``shards`` shards over the visible cards, an equal run on each
    (one a card on four cards, two a card on two); skips on one card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more GPUs: {n} visible")
    n = min(n, shards)
    return [f"cuda:{i * n // shards}" for i in range(shards)]


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [4, 2])
def test_join_replica_axis_over_cards_matches_one_card(dev, rep):
    """(rep, 4 // rep) meshes of distinct cards: every block holds the
    one-card replica_join of its columns (and numpy's max); the local
    folds and the leader's fold launch on the cards that hold them."""
    from jylis_tpu_torch import parallel as tpar
    from jylis_tpu_torch.ops import _build

    devs = _cards(dev)
    rng = np.random.default_rng(rep)
    s, k = 64, 4096
    states = _u64(rng, (s, k))
    states[:, 0] = 0
    states[-1, 1] = (1 << 64) - 1
    states[:, 2] = 1 << 63
    x = planes.to_tensor(states, "cuda:0")
    want = tpar.replica_join(x).cpu()
    np.testing.assert_array_equal(planes.to_u64_np(want), states.max(axis=0))
    mesh = tpar.make_mesh(4, rep=rep, devices=devs)
    blocks = tpar.shard_grid(mesh, x)
    _build.reset(tpar.replica_join)
    out = tpar.join_replica_axis(mesh, blocks)
    nk = 4 // rep
    for r in range(rep):
        for c in range(nk):
            assert out[r][c].device == blocks[r][c].device
            assert torch.equal(out[r][c].cpu(), want[c * k // nk:(c + 1) * k // nk].expand(
                s // rep, -1))
    assert tpar.replica_join.launches == rep * nk + nk
    assert set(tpar.replica_join.by_card) == {torch.device(d).index for d in devs}


def _node_script(n_keys: int):
    """Local writes of every plane-backed type over ``n_keys`` keys, and
    reads of each."""
    cmds = []
    for i in range(n_keys):
        k = b"k%d" % i
        cmds += [[b"GCOUNT", b"INC", k, b"%d" % (i + 1)], [b"PNCOUNT", b"DEC", k, b"3"],
                 [b"TREG", b"SET", k, b"v%d" % (i % 7), b"%d" % (i % 5)],
                 [b"TLOG", b"INS", k, b"e%d" % (i % 3), b"%d" % i]]
    for i in range(0, n_keys, 3):
        k = b"k%d" % i
        cmds += [[b"GCOUNT", b"GET", k], [b"PNCOUNT", b"GET", k], [b"TREG", b"GET", k],
                 [b"TLOG", b"GET", k]]
    return cmds


def _fed_database(device, mesh, n_keys: int = 3500):
    from jylis_tpu_torch.models.database import Database
    from jylis_tpu_torch.server.resp import Respond

    db = Database(7, device=device, mesh=mesh)
    out = bytearray()
    for cmd in _node_script(n_keys):
        db.apply(Respond(out.extend), cmd)
    for name, delta in (("GCOUNT", {9: (1 << 64) - 1}), ("PNCOUNT", ({9: 1 << 63}, {8: 5})),
                        ("TREG", (b"foreign", 1 << 63))):
        db.converge(name, [(b"k%d" % i, delta) for i in range(0, n_keys, 2)])
    db.drain_all()
    return db, bytes(out)


def _digest(db) -> bytes:
    from jylis_tpu_torch.server.resp import Respond

    out = bytearray()
    db.apply(Respond(out.extend), [b"SYSTEM", b"DIGEST", b"TYPES"])
    return bytes(out)


@pytest.mark.cuda
def test_a_database_over_every_card_matches_the_cpu(dev):
    """A Database keys-sharded over the cards (its keyspaces grow from
    1,024 rows to 4,096 over them; 3,500 keys reach the last of four
    1,024-row blocks) gives the CPU Database's replies, dumps and
    digest, and drains every counter type, TREG and TLOG on every
    card."""
    from jylis_tpu_torch import parallel as tpar
    from jylis_tpu_torch.ops import _build
    from jylis_tpu_torch.utils import metrics

    devs = _cards(dev)
    wrappers = metrics.kernel_wrappers()
    _build.reset(*wrappers.values())
    cards, got = _fed_database("cuda", tpar.make_mesh(4, devices=devs))
    cpu, want = _fed_database("cpu", None)
    assert got == want
    for name in ("GCOUNT", "PNCOUNT", "TREG", "TLOG"):
        repo = cards.manager(name).repo
        assert len(repo._ks.parts) == 4 and repo._key_cap == 4096
        assert repo.dump_state() == cpu.manager(name).repo.dump_state(), name
    assert _digest(cards) == _digest(cpu)
    every = {torch.device(d).index for d in devs}
    for name in ("counter_drain_sparse<1>", "counter_drain_sparse<2>", "treg_drain_sparse",
                 "tlog_drain_sparse"):
        fn = wrappers[name]
        assert set(fn.by_card) == every and sum(fn.by_card.values()) == fn.launches, name


@pytest.mark.cuda
def test_a_snapshot_moves_between_one_card_and_every_card(dev, tmp_path):
    """Written keys-sharded over the cards, restored on cuda:1 alone;
    written there, restored over every card: one digest throughout."""
    from jylis_tpu_torch import parallel as tpar
    from jylis_tpu_torch import persist
    from jylis_tpu_torch.models.database import Database

    devs = _cards(dev)
    src, _ = _fed_database("cuda", tpar.make_mesh(4, devices=devs), 1500)
    want = _digest(src)
    persist.save_snapshot(src, str(tmp_path / "cards.jylis"))
    one = Database(7, device="cuda:1")
    assert one.mesh is None
    persist.load_snapshot(one, str(tmp_path / "cards.jylis"))
    assert _digest(one) == want
    assert one.manager("GCOUNT").repo._ks.parts[0].counts.device == torch.device("cuda:1")
    persist.save_snapshot(one, str(tmp_path / "one.jylis"))
    back = Database(7, device="cuda", mesh=tpar.make_mesh(4, devices=devs))
    persist.load_snapshot(back, str(tmp_path / "one.jylis"))
    assert _digest(back) == want


@pytest.mark.cuda
def test_warmup_on_every_card_launches_each_library_there(dev):
    """A bare ``cuda`` on several cards: warmup's Database takes the
    serving mesh, and the sparse drains and both UJSON kernels launch
    on every card before a node would listen."""
    from jylis_tpu_torch.models import database
    from jylis_tpu_torch.ops import _build
    from jylis_tpu_torch.parallel import serving_mesh
    from jylis_tpu_torch.utils import metrics

    _cards(dev)
    every = set(range(torch.cuda.device_count()))
    assert {d.index for d in serving_mesh().keys_devices} == every
    wrappers = metrics.kernel_wrappers()
    _build.reset(*wrappers.values())
    database.warmup("cuda")
    for name in ("counter_drain_sparse<1>", "counter_drain_sparse<2>", "treg_drain_sparse",
                 "tlog_drain_sparse", "ujson_join", "ujson_fold_flat"):
        assert set(wrappers[name].by_card) == every, (name, wrappers[name].by_card)
