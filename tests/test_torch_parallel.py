"""Parity of the port's mesh mode (jylis_tpu_torch/parallel) with the JAX
package's, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices with meshes
built explicitly (``make_mesh(4)``, ``make_mesh(8, rep=4)``) and passed to
its repos as ``mesh=``; the port's meshes repeat the CPU device
(``make_mesh(4, devices=["cpu"] * 4)``), which gives the same shard
layout on one device. The same seeded numpy data goes through both, and
every comparison is exact (tolerance 0: integer lattices):

* ``make_mesh`` shapes and errors, ``serving_mesh`` and ``resolve_mesh``;
* the routing against JAX ``route_batch`` / ``route_drain`` /
  ``route_drain64`` (u64 payloads against JAX's hi/lo planes);
* each sharded drain against the JAX sharded drain on a 4-device mesh:
  GCOUNT, PNCOUNT (values >= 2^63, wrapping sums), TREG (rank ties and
  ``patch_sharded_treg``), TLOG (wide, trims of every kind, an overflow:
  the port leaves a flagged row as it was, JAX returns it merged and its
  caller drops it, so flagged rows compare against the input state);
  live slots only (JAX clamps pad-slot gathers to row K-1, the port
  reads 0 there);
* ``join_replica_axis`` on ``make_mesh(8, rep=4)`` and on keys-only
  meshes, even and odd rows per shard, columns >= 2^63;
* ``fold_join_aligned``, flat and tree, narrow and wide, and the
  resident store on a mesh (the store tests of
  test_torch_ujson_resident.py rerun with both stores sharded);
* the repos in mesh mode against the JAX repos in mesh mode: the command
  and delta streams of test_torch_repo.py, test_torch_treg.py,
  test_torch_tlog_repo.py and test_torch_ujson_repo.py rerun with a mesh
  on both sides (replies, flushed deltas, dumps, device planes, grows
  past the first capacity), then the cases of tests/test_parallel.py on
  the port alone, a mesh Database against a single-device one, the
  dryrun on ``[cpu] * 4``, and a process without JAX.
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import jylis_tpu  # noqa: F401
from jylis_tpu import parallel as jpar
from jylis_tpu.ops import planes as jplanes
from jylis_tpu.ops import tlog as jtlog
from jylis_tpu.ops import treg as jtreg
from jylis_tpu.ops import ujson_resident as jres
from jylis_tpu_torch import convert
from jylis_tpu_torch import parallel as tpar
from jylis_tpu_torch.models import database as tdb
from jylis_tpu_torch.models import repo_counters as rc
from jylis_tpu_torch.models import repo_tlog as rl
from jylis_tpu_torch.models import repo_treg as rt
from jylis_tpu_torch.models import repo_ujson as ru
from jylis_tpu_torch.ops import gcount, planes, pncount, tlog, treg
from jylis_tpu_torch.ops import ujson_resident as tres
from jylis_tpu_torch.parallel.dryrun import dryrun_multichip
from jylis_tpu_torch.server import resp as tresp

import test_torch_repo
import test_torch_tlog_repo
import test_torch_treg
import test_torch_ujson_repo
import test_torch_ujson_resident
from test_torch_ujson import SHIFT_IDS, SHIFTS, assert_same, delta_stacks, jx, pt, resident_np

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

U64 = (1 << 64) - 1


def tmesh(n=4, rep=1):
    return tpar.make_mesh(n, rep=rep, devices=["cpu"] * n)


@functools.lru_cache(maxsize=None)
def jmesh(n=4, rep=1):
    """The JAX mesh of each shape, built once for the module."""
    return jpar.make_mesh(n, rep=rep)


def u64(rng, shape):
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


# ---- meshes ----------------------------------------------------------------------


@pytest.mark.parametrize("n,rep", [(8, 1), (8, 4), (4, 2), (4, 1)])
def test_mesh_shapes_match_jax(n, rep):
    m = tmesh(n, rep)
    assert m.devices.shape == jmesh(n, rep).devices.shape
    assert m.shape == {"rep": rep, "keys": n // rep}
    assert m.keys_devices == [torch.device("cpu")] * (n // rep)


@pytest.mark.parametrize("n,rep", [(8, 3), (1000, 1)])
def test_make_mesh_errors_match_jax(n, rep):
    with pytest.raises(ValueError):
        jpar.make_mesh(n, rep=rep)
    with pytest.raises(ValueError):
        tpar.make_mesh(n, rep=rep, devices=["cpu"] * 8)


def test_serving_mesh_and_resolve_mesh():
    """A node goes mesh-mode by itself only with more than one card; a
    CPU device never does; an explicit mesh passes through."""
    sm = tpar.serving_mesh()
    assert sm is tpar.serving_mesh()  # memoised
    assert (sm is None) == (torch.cuda.device_count() < 2)
    m = tmesh()
    assert tpar.resolve_mesh("auto", "cpu") is None
    assert tpar.resolve_mesh(None, "cpu") is None
    assert tpar.resolve_mesh(m, "cpu") is m
    with pytest.raises(ValueError):
        tpar.resolve_mesh("keys", "cpu")
    with pytest.raises(ValueError):
        tpar.make_mesh(devices=[])


def test_an_indexed_cuda_device_takes_no_mesh(monkeypatch):
    """On a host with four cards, "auto" shards a node over all of them
    for a bare ``cuda``, and over none for ``cuda:1``, so the node and its
    TENSOR repo stay on the card it names."""
    from jylis_tpu_torch.parallel import mesh as tmesh_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tmesh_mod, "_SERVING_MESH", [])
    assert tpar.resolve_mesh("auto", "cuda:1") is None
    assert tpar.resolve_mesh("auto", torch.device("cuda", 0)) is None
    sm = tpar.resolve_mesh("auto", "cuda")
    assert sm is tpar.serving_mesh()
    assert [str(d) for d in sm.keys_devices] == [f"cuda:{i}" for i in range(4)]


# ---- routing ---------------------------------------------------------------------


def test_route_batch_blocks_pads_and_coalesces():
    rows = np.array([0, 5, 17, 18, 33, 5], np.int32)  # 5 duplicated
    deltas = np.arange(6 * 2, dtype=np.uint64).reshape(6, 2)
    local_rows, d = tpar.route_batch(rows, deltas, n_shards=4, rows_per_shard=16)
    lr = local_rows.reshape(4, -1)
    assert lr.shape[1] == 2  # padded to the max shard load
    assert list(lr[0]) == [0, 5]
    assert list(lr[1]) == [1, 2]
    assert lr[2][0] == 1
    assert all(p > 1 << 20 for p in (lr[2][1], lr[3][0], lr[3][1]))
    for shard in lr:
        assert len(set(map(int, shard))) == len(shard)
    # duplicate row 5 max-combined: deltas[1]=[2,3], deltas[5]=[10,11]
    np.testing.assert_array_equal(d.reshape(4, 2, 2)[0, 1], [10, 11])


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_matches_jax(seed, n_shards):
    rng = np.random.default_rng(seed)
    rps = 16
    b = int(rng.integers(0, 60))
    rows = rng.integers(0, n_shards * rps, b).astype(np.int64)  # duplicates
    deltas = u64(rng, (b, 3))
    lr, pay = tpar.route_batch(rows, deltas, n_shards, rps)
    jlr, jhi, jlo = jpar.route_batch(rows, deltas, n_shards, rps)
    np.testing.assert_array_equal(lr, jlr)
    np.testing.assert_array_equal(pay, jplanes.combine64_np(jhi, jlo))
    lr, pay, slots = tpar.route_drain(rows, deltas, n_shards, rps)
    jlr, jhi, jlo, jslots = jpar.route_drain(rows, deltas, n_shards, rps)
    np.testing.assert_array_equal(lr, jlr)
    np.testing.assert_array_equal(pay, jplanes.combine64_np(jhi, jlo))
    np.testing.assert_array_equal(slots, jslots)
    jlr, jpay, jslots = jpar.route_drain64(rows, deltas, n_shards, rps)
    np.testing.assert_array_equal(lr, jlr)
    np.testing.assert_array_equal(pay, jpay)
    np.testing.assert_array_equal(slots, jslots)
    assert lr.dtype == np.int32 and len(lr) % 8 == 0


# ---- sharded drains against the JAX sharded drains ---------------------------------


def test_sharded_converge_matches_single_chip():
    rng = np.random.default_rng(0)
    k, r, b, n = 128, 8, 64, 8
    mesh, jm = tmesh(n), jmesh(n)
    reference = np.zeros((k, r), np.uint64)
    blocks = tpar.shard_plane(mesh, np.zeros((k, r), np.uint64))
    hi = jpar.shard_plane(jm, np.zeros((k, r), np.uint32))
    lo = jpar.shard_plane(jm, np.zeros((k, r), np.uint32))
    for _ in range(3):
        rows = rng.integers(0, k, b).astype(np.int32)
        deltas = u64(rng, (b, r))
        np.maximum.at(reference, rows, deltas)
        lr, d = tpar.route_batch(rows, deltas, n, k // n)
        tpar.converge_sharded(mesh, blocks, lr, d)
        jlr, dh, dl = jpar.route_batch(rows, deltas, n, k // n)
        hi, lo = jpar.converge_sharded(jm, hi, lo, jlr, dh, dl)
    got = np.concatenate([planes.to_u64_np(x) for x in blocks])
    np.testing.assert_array_equal(got, reference)
    np.testing.assert_array_equal(got, jplanes.combine64_np(np.asarray(hi), np.asarray(lo)))
    sums = tpar.read_all_sharded(mesh, blocks).view(np.uint64)
    np.testing.assert_array_equal(sums, reference.sum(axis=1, dtype=np.uint64))
    np.testing.assert_array_equal(sums, np.asarray(jpar.read_all_sharded(jm, hi, lo)))


@pytest.mark.parametrize("pn", [False, True], ids=["gcount", "pncount"])
def test_sharded_counter_drains_match_jax(pn):
    """Full-range u64 state and deltas (half >= 2^63, so sums wrap),
    three routed drains; per-slot sums at live slots, 0 at pads."""
    rng = np.random.default_rng(4 + pn)
    k, r, n = 64, 8, 4
    mesh, jm = tmesh(n), jmesh(n)
    pols = [u64(rng, (k, r)) for _ in range(1 + pn)]
    mod = pncount if pn else gcount
    shards = tpar.shard_state(mesh, mod.from_counts(*pols, device="cpu"))
    jst = [jpar.shard_plane(jm, x) for p in pols for x in jplanes.split64_np(p)]
    for _ in range(3):
        b = int(rng.integers(1, 40))
        rows = rng.choice(k, b, replace=False).astype(np.int64)
        deltas = u64(rng, (b, r * (1 + pn)))
        lr, pay, slots = tpar.route_drain(rows, deltas, n, k // n)
        jlr, dh, dl, _ = jpar.route_drain(rows, deltas, n, k // n)
        if pn:
            sums = tpar.drain_sharded_pn(mesh, shards, lr, pay)
            *jst, jsums = jpar.drain_sharded_pn(jm, *jst, jlr, dh, dl)
            jsums = np.asarray(jsums)
        else:
            sums = tpar.drain_sharded_g(mesh, shards, lr, pay)
            *jst, jsums = jpar.drain_sharded_g(jm, *jst, jlr, dh, dl)
            jsums = np.asarray(jsums).view(np.int64)
        live = slots >= 0
        np.testing.assert_array_equal(sums[live], jsums[live])
        assert not sums[~live].any()
    got = mod.to_counts(tpar.gather_state(shards))
    for g, (h, lo) in zip(got if pn else (got,), zip(jst[::2], jst[1::2])):
        np.testing.assert_array_equal(g, jplanes.combine64_np(np.asarray(h), np.asarray(lo)))


TS_POOL = np.array([0, 3, 7, 1 << 63, U64], np.uint64)


def test_sharded_treg_drain_and_patch_match_jax():
    """Timestamps and ranks from small pools (ties on both, values
    >= 2^63), vids of either order; then a routed vid patch."""
    rng = np.random.default_rng(7)
    k, n = 64, 4
    mesh, jm = tmesh(n), jmesh(n)
    shards = tpar.shard_state(mesh, treg.init(k, "cpu"))
    jst = [jpar.shard_vec(jm, p) for p in jtreg.init(k)]
    ties = 0
    for _rnd in range(4):
        b = int(rng.integers(1, 40))
        rows = rng.choice(k, b, replace=False).astype(np.int64)
        payload = np.stack([TS_POOL[rng.integers(0, len(TS_POOL), b)],
                            TS_POOL[rng.integers(0, len(TS_POOL), b)],
                            rng.integers(0, 50, b).astype(np.uint64)], 1)
        lr, pay, slots = tpar.route_drain(rows, payload, n, k // n)
        jlr, dh, dl, _ = jpar.route_drain(rows, payload, n, k // n)
        tie, ts, vid = tpar.drain_sharded_treg(mesh, shards, lr, pay)
        jout = jpar.drain_sharded_treg(jm, *jst, jlr, dh, dl)
        jst = list(jout[:5])
        live = slots >= 0
        np.testing.assert_array_equal(tie[live], np.asarray(jout[5])[live])
        np.testing.assert_array_equal(
            ts.view(np.uint64)[live],
            jplanes.combine64_np(np.asarray(jout[6]), np.asarray(jout[7]))[live])
        np.testing.assert_array_equal(vid[live], np.asarray(jout[8])[live])
        ties += int(tie[live].sum())
    assert ties > 0
    prow = rng.choice(k, 10, replace=False).astype(np.int64)
    pvid = rng.integers(0, 90, (10, 1)).astype(np.uint64)
    lr, pay, _ = tpar.route_drain(prow, pvid, n, k // n)
    tpar.patch_sharded_treg(mesh, shards, lr, pay[:, 0].astype(np.int32))
    jlr, _h, jlo, _ = jpar.route_drain(prow, pvid, n, k // n)
    jst[4] = jpar.patch_sharded_treg(jm, jst[4], jlr, jlo[:, 0].astype(np.int32))
    for g, w in zip(convert.treg_to_jax(tpar.gather_state(shards)), jst):
        np.testing.assert_array_equal(g, np.asarray(w))


def tlog_payload(rng, b: int, ld: int, counts):
    ts = rng.integers(0, 40, (b, ld)).astype(np.uint64)
    ts[rng.random((b, ld)) < 0.2] = np.uint64(1 << 40)  # past the narrow layout
    vid = rng.integers(0, 6, (b, ld)).astype(np.uint64)
    vid[rng.random((b, ld)) < 0.3] = np.uint64(U64)  # empty slots
    cut = np.where(rng.random(b) < 0.3, rng.integers(0, 20, b), 0).astype(np.uint64)
    return np.concatenate([ts, vid, cut[:, None], counts[:, None]], 1)


def test_sharded_tlog_drain_matches_jax():
    """Wide rows of L = 8, deltas of Ld = 4 (duplicates inside and
    against the state, raised cutoffs), trim counts 0 (CLR), 1, 3, past
    the length and the no-op sentinel; the last round overflows some
    rows."""
    rng = np.random.default_rng(9)
    k, L, ld, n = 32, 8, 4, 4
    mesh, jm = tmesh(n), jmesh(n)
    shards = tpar.shard_state(mesh, tlog.init(k, L, wide=True, device="cpu"))
    jst = jtlog.init(k, L, wide=True)
    jst = [jpar.shard_plane(jm, p) if p.ndim == 2 else jpar.shard_vec(jm, p)
           for p in jst]
    choices = np.array([0, 1, 3, 100, tlog.TRIM_NOOP, tlog.TRIM_NOOP], np.uint64)
    flagged = 0
    for rnd in range(6):
        b = int(rng.integers(4, 20))
        rows = rng.choice(k, b, replace=False).astype(np.int64)
        counts = choices[rng.integers(0, len(choices), b)]
        payload = tlog_payload(rng, b, ld if rnd < 5 else 2 * L, counts)
        w = (payload.shape[1] - 2) // 2
        before = convert.tlog_to_jax(tpar.gather_state(shards))
        lr, pay, slots = tpar.route_drain(rows, payload, n, k // n)
        jlr, jpay, _ = jpar.route_drain64(rows, payload, n, k // n)
        ovf, length, cut = tpar.drain_sharded_tlog(mesh, shards, lr, pay, w)
        jout = jpar.drain_sharded_tlog(jm, *jst, jlr, jnp.asarray(jpay), w)
        live = slots >= 0
        jovf = np.asarray(jout[5])
        np.testing.assert_array_equal(ovf[live], jovf[live])
        ok = live & ~jovf
        np.testing.assert_array_equal(length[ok], np.asarray(jout[6])[ok])
        np.testing.assert_array_equal(cut.view(np.uint64)[ok], np.asarray(jout[7])[ok])
        # flagged rows keep the input state; the others equal JAX's output
        bad = slots[live & jovf]
        flagged += len(bad)
        got = convert.tlog_to_jax(tpar.gather_state(shards))
        wants = []
        for g, w_new, w_old in zip(got, [np.asarray(p) for p in jout[:5]], before):
            want = w_new.copy()
            want[bad] = w_old[bad]
            np.testing.assert_array_equal(g, want)
            wants.append(want)
        # the next round starts from the port's state (a JAX caller would
        # grow and redrain instead; the ops compare round by round)
        jst = [jpar.shard_plane(jm, w) if w.ndim == 2 else jpar.shard_vec(jm, w)
               for w in wants]
    assert flagged > 0


@pytest.mark.parametrize("s,rep,n", [(8, 4, 8), (12, 4, 8), (4, 4, 8), (16, 2, 8),
                                     (7, 1, 8), (5, 1, 4)],
                         ids=["S8-rep4", "S12-rep4-odd", "S4-rep4", "S16-rep2",
                              "S7-keys8-odd", "S5-keys4-odd"])
def test_join_replica_axis_matches_jax(s, rep, n):
    rng = np.random.default_rng(s * 10 + rep)
    k = 64
    states = u64(rng, (s, k))  # half the columns' values >= 2^63
    states[:, 0] = U64
    states[:, 1] = 0
    jm = jmesh(n, rep)
    sh = NamedSharding(jm, P("rep", "keys"))
    s_hi, s_lo = jplanes.split64_np(states)
    jhi, jlo = jpar.join_replica_axis(jm, jax.device_put(s_hi, sh), jax.device_put(s_lo, sh))
    want = jplanes.combine64_np(np.asarray(jhi), np.asarray(jlo))
    np.testing.assert_array_equal(want, np.broadcast_to(states.max(axis=0), (s, k)))
    mesh = tmesh(n, rep)
    out = tpar.join_replica_axis(mesh, tpar.shard_grid(mesh, states))
    assert len(out) == rep and all(len(row) == n // rep for row in out)
    np.testing.assert_array_equal(planes.to_u64_np(tpar.gather_grid(out)), want)


def test_replica_join_plain_rows_and_cpu_wrapper():
    """The wrapper returns the one joined row; join_replica_axis gives
    JAX's (S, K) broadcast as zero-copy views of it."""
    rng = np.random.default_rng(3)
    x = planes.to_tensor(u64(rng, (9, 33)), "cpu")
    one = tpar.replica_join(x)
    assert one.shape == (33,) and torch.equal(one, tpar.replica_join_plain(x))
    np.testing.assert_array_equal(planes.to_u64_np(one), planes.to_u64_np(x).max(axis=0))
    assert tpar.replica_join.launches == 0  # a CPU tensor runs the plain version
    m = tmesh(1)
    (out,), = tpar.join_replica_axis(m, tpar.shard_grid(m, x))
    assert out.shape == (9, 33) and out.stride() == (0, 1)
    assert torch.equal(out[8], one)


def test_shard_helpers_round_trip():
    m = tmesh(4)
    st = gcount.from_counts(np.arange(16 * 8, dtype=np.uint64).reshape(16, 8), "cpu")
    shards = tpar.shard_state(m, st)
    assert [s.counts.shape for s in shards] == [(4, 8)] * 4
    assert torch.equal(tpar.gather_state(shards).counts, st.counts)
    shards[0].counts[0, 0] = 99  # a copy, not a view of the source
    assert st.counts[0, 0] == 0
    with pytest.raises(ValueError):
        tpar.shard_plane(m, np.zeros((6, 2), np.uint64))
    wide = tpar.shard_state(m, tlog.init(8, 4, wide=False, device="cpu"))
    assert all(s.nth is None for s in wide)


@pytest.mark.parametrize("n", [1, 4], ids=["single-device", "mesh4"])
def test_keyspace_layout(n):
    """The one layout type: capacity rounds to the shards, growth
    re-splits, rows locate and split by block, a plane replaces per
    block; without a mesh the one part is the state itself."""
    ks = tpar.Keyspace(tmesh(n) if n > 1 else None, "cpu")
    assert ks.key_cap == 0 and ks.round_cap(10) == -(-10 // n) * n
    ks.init(10, lambda rows, d: gcount.init(rows, 8, d))
    assert ks.key_cap == ks.round_cap(10) and len(ks.parts) == n
    ks.grow(lambda s: gcount.grow(s, 32, 8))
    assert [p.counts.shape for p in ks.parts] == [(32 // n, 8)] * n
    part, local = ks.locate(17)
    part.counts[local, 2] = 5
    assert int(ks.whole().counts[17, 2]) == 5
    if n == 1:
        assert ks.whole() is ks.parts[0]
    rows = np.array([31, 0, 9, 17])
    seen = []
    for part, sel, local in ks.split_rows(rows):
        i = next(j for j, p in enumerate(ks.parts) if p is part)
        np.testing.assert_array_equal(rows[sel], i * ks.rows_per_shard + local)
        seen += sel.tolist()
    assert sorted(seen) == [0, 1, 2, 3]
    ks.set_plane("counts", np.arange(32 * 8, dtype=np.int64).reshape(32, 8))
    assert torch.equal(ks.whole().counts, torch.arange(32 * 8).reshape(32, 8))
    lr, _pay, slots = ks.route([3, 30], np.ones((2, 8), np.uint64))
    assert sorted(slots[slots >= 0].tolist()) == [3, 30]


# ---- the UJSON row-aligned fold and the store on a mesh ----------------------------


@pytest.mark.parametrize("d,widths", [(5, "keep"), (5, "grow"), (64, "shrink"),
                                      (130, "keep")],
                         ids=["D5-keep", "D5-grow", "D64-shrink", "D130-tree"])
@pytest.mark.parametrize("shift", SHIFTS, ids=SHIFT_IDS)
def test_fold_join_aligned_matches_jax(shift, d, widths):
    """Grid row i joins resident row i: the flat rule at D <= 64 and the
    tree above it, with the epilogue at widths that keep, grow and
    shrink the planes; identity segments on the rows with no delta."""
    res = resident_np(90 + d, 8, shift)
    grid = delta_stacks(95 + d, 5, d, shift, pad_keys=3)
    lw, lc = res.dots.shape[1], res.cloud.shape[1]
    out_w, out_c = {"keep": (lw, lc), "grow": (4 * lw, 2 * lc), "shrink": (64, 64)}[widths]
    j_out, j_live = jres.fold_join_aligned(jx(res), jx(grid), shift=shift,
                                           out_w=out_w, out_c=out_c)
    port_res = pt(res)
    t_out, t_live = tres.fold_join_aligned(port_res, pt(grid), shift=shift,
                                           out_w=out_w, out_c=out_c)
    assert_same(t_out, j_out)
    assert np.array_equal(t_live.numpy(), np.asarray(j_live))
    if widths == "keep":  # the widths held: joined in place
        assert t_out.dots.data_ptr() == port_res.dots.data_ptr()


class MeshTwin(test_torch_ujson_resident.Twin):
    """Both stores sharded over 4 key shards (the JAX store through
    shard_docbatch, as its repo builds it)."""

    def __init__(self, n_rep=8):
        jm = jmesh(4)
        self.j = jres.ResidentStore(n_rep=n_rep, mesh=jm,
                                    shard_fn=lambda b: jpar.shard_docbatch(jm, b))
        self.t = tres.ResidentStore(n_rep=n_rep, device="cpu", mesh=tmesh(4))


STORE_CASES = [
    ("test_admit_and_fold_epochs_match_jax", {"fanin": 4}),
    ("test_admit_and_fold_epochs_match_jax", {"fanin": 70}),
    ("test_evict_discard_and_capacity_growth_match_jax", {}),
    ("test_narrow_repack_and_widen_match_jax", {}),
    ("test_overflow_past_u32_raises_with_rows_unchanged", {}),
    ("test_broadcast_folds_match_jax", {"monkeypatch": None}),
    ("test_full_reads_retighten_widths_and_compact_payloads", {}),
]


@pytest.mark.parametrize("case,kw", STORE_CASES,
                         ids=[f"{c[5:]}{'-' + str(k.get('fanin')) if 'fanin' in k else ''}"
                              for c, k in STORE_CASES])
def test_resident_store_on_a_mesh_matches_jax(monkeypatch, case, kw):
    """The store-against-store cases of test_torch_ujson_resident.py with
    both stores sharded: admissions and capacity growth re-split the
    rows, folds take the row-aligned path on every shard, broadcasts and
    reads run per shard; planes compare gathered."""
    monkeypatch.setattr(test_torch_ujson_resident, "Twin", MeshTwin)
    kw = {k: monkeypatch if v is None else v for k, v in kw.items()}
    getattr(test_torch_ujson_resident, case)(**kw)


# ---- the repos in mesh mode against the JAX repos in mesh mode ------------------------


def meshed(cls, mesh):
    """``cls`` constructed with ``mesh`` whatever mesh its caller asked."""

    class Meshed(cls):
        def __init__(self, *a, **kw):
            kw["mesh"] = mesh
            super().__init__(*a, **kw)

    return Meshed


@pytest.fixture
def mesh_repos(monkeypatch):
    """Every repo class of both packages, in the stream harnesses'
    modules, built on a 4-shard mesh."""
    jm, tm = jmesh(4), tmesh(4)
    from jylis_tpu.models import repo_counters as jrc
    from jylis_tpu.models import repo_tlog as jrl
    from jylis_tpu.models import repo_treg as jrt
    from jylis_tpu.models import repo_ujson as jru

    for mod, names, mesh in ((jrc, ("RepoGCOUNT", "RepoPNCOUNT"), jm),
                             (rc, ("RepoGCOUNT", "RepoPNCOUNT"), tm),
                             (jrt, ("RepoTREG",), jm), (rt, ("RepoTREG",), tm),
                             (jrl, ("RepoTLOG",), jm), (rl, ("RepoTLOG",), tm),
                             (jru, ("RepoUJSON",), jm), (ru, ("RepoUJSON",), tm)):
        for name in names:
            monkeypatch.setattr(mod, name, meshed(getattr(mod, name), mesh))
    return monkeypatch


@pytest.mark.parametrize("name", ["GCOUNT", "PNCOUNT"])
@pytest.mark.parametrize("seed,n_keys,n_rids,n_ops", [
    (0, 12, 3, 300),  # small routed drains
    (1, 600, 5, 120),  # sweeps over most of the keyspace
    (2, 2400, 12, 120),  # keyspace and replica columns both grow
])
def test_counter_streams_on_a_mesh_match_jax(mesh_repos, name, seed, n_keys, n_rids,
                                             n_ops):
    trepo, out = test_torch_repo.run_stream(name, seed, n_keys, n_rids, n_ops)
    assert b":" in out
    assert trepo._ks.mesh is not None and len(trepo._ks.parts) == 4
    if n_keys > 1024:
        assert trepo._key_cap >= 2048 and trepo._rep_cap == 16


@pytest.mark.parametrize("seed,n_keys,n_ops,weights", [
    (0, 12, 400, [4, 4, 3, 0, 0.6, 0.4]),  # routed drains and prefix ties
    (1, 900, 150, [3, 3, 2, 0.5, 0.6, 0.3]),  # sweeps over the keyspace
    (2, 2100, 80, [1, 1, 1, 1.5, 1, 0.3]),  # the keyspace grows past 2048
])
def test_treg_streams_on_a_mesh_match_jax(mesh_repos, seed, n_keys, n_ops, weights):
    trepo, _j, out = test_torch_treg.run_stream(seed, n_keys, n_ops, weights)
    assert b"*2\r\n" in out and len(trepo._ks.parts) == 4


@pytest.mark.parametrize("seed,n_keys,n_ops,weights,widen_at", [
    (0, 6, 500, [5, 3, 2, 1, 1, 1, 0.5, 3, 0, 0.5, 0.5], None),
    (1, 600, 300, [4, 2, 1, 1, 1, 1, 0.5, 2, 0.1, 0.5, 0.5], None),
    (2, 1100, 60, [2, 1, 1, 1, 1, 1, 0.5, 2, 1, 0.5, 0.5], None),
    (3, 8, 400, [5, 3, 2, 1, 1, 1, 0.5, 3, 0, 0.5, 0.5], 150),
])
def test_tlog_streams_on_a_mesh_match_jax(mesh_repos, seed, n_keys, n_ops, weights,
                                          widen_at):
    """Replies, flushes, dumps and the gathered planes; the mesh keeps
    the wide layout from the start on both sides."""
    p = test_torch_tlog_repo.run_stream(seed, n_keys, n_ops, weights, widen_at=widen_at)
    assert len(p.t._ks.parts) == 4 and p.t._ks.parts[0].wide


def test_tlog_overflow_retry_on_a_mesh_matches_jax(mesh_repos):
    """Rows of 4 slots hold 3 drained entries each; 3 more pending
    entries per row overflow them. A drain grows the slots to the worst
    case before it launches, so the retry is driven through the sharded
    drain itself: both packages flag the rows, double the slots and
    drain again (JAX from the pre-merge state, the port over the rows it
    left untouched)."""
    from jylis_tpu.models import repo_tlog as jrl

    mod = test_torch_tlog_repo
    p = mod.Pair()
    p.j = jrl.RepoTLOG(1, len_cap=4, engine="python")
    p.t = rl.RepoTLOG(1, len_cap=4, device="cpu")
    keys = [b"log%d" % i for i in range(10)]
    for k in keys:
        p.converge(k, ([(b"e%d" % t, t + 1) for t in range(3)], 0))
    p.drain()
    for k in keys:
        p.converge(k, ([(b"f%d" % t, 100 + t) for t in range(3)], 2))
    calls = []
    orig = rl.drain_sharded_tlog
    mesh_repos.setattr(rl, "drain_sharded_tlog", lambda *a: calls.append(1) or orig(*a))
    for repo in (p.j, p.t):
        rows = sorted(repo._tbl.touched_rows())
        pend = repo._tbl.export_pend_bulk(rows)
        repo._drain_sharded(rows, pend, {r: repo._tbl.pend_cutoff(r) for r in rows})
    assert len(calls) == 2 and p.t._len_cap == p.j._len_cap == 8
    p.cmd(b"TRIM", keys[0], 2)
    p.finish(keys)


UJSON_CASES = [
    "test_command_and_delta_stream_matches_jax",
    "test_deep_fanin_promotes_folds_by_the_tree_and_trickles",
    "test_widen_and_host_only_fallback_match_jax",
    "test_load_state_round_trips_a_dump",
]


@pytest.mark.parametrize("case", UJSON_CASES, ids=[c[5:] for c in UJSON_CASES])
def test_ujson_repo_cases_on_a_mesh_match_jax(mesh_repos, case):
    """The repo-against-repo cases of test_torch_ujson_repo.py with both
    repos on a mesh: resident keys fold through the row-aligned fold,
    flat and by the tree, on every shard."""
    calls = []
    orig = tres.fold_join_aligned
    mesh_repos.setattr(tres, "fold_join_aligned", lambda *a, **kw: calls.append(1)
                       or orig(*a, **kw))
    getattr(test_torch_ujson_repo, case)(mesh_repos)
    assert calls


# ---- tests/test_parallel.py, case for case, on the port ------------------------------


class _R:
    """Collects what a repo replies, in order."""

    def __init__(self):
        self.vals = []

    def __getattr__(self, name):
        return lambda *a: self.vals.extend(a)


def test_serving_repos_shard_disjoint_key_blocks():
    """On an 8-shard mesh every device owns a disjoint, contiguous block
    of key rows covering the keyspace, every replica column resident."""
    m = tmesh(8)
    repo = rc.RepoGCOUNT(identity=7, device="cpu", mesh=m)
    assert repo._ks.mesh is m and repo._ks.n_shards == 8
    assert [s.counts.shape for s in repo._ks.parts] == [(1024 // 8, 8)] * 8
    repo.converge(b"k", {3: 5})
    repo.drain()
    row = repo._tbl.find(b"k")
    owner = row // (repo._key_cap // 8)
    assert [int(s.counts.sum()) for s in repo._ks.parts] == [
        5 if i == owner else 0 for i in range(8)]


@pytest.mark.parametrize("name", ["GCOUNT", "PNCOUNT"])
def test_sharded_convergence_two_nodes(name):
    """Two repos (different identities) on a mesh exchange flushed deltas
    and converge to identical values."""
    m = tmesh(8)
    cls = getattr(rc, f"Repo{name}")
    a, b = cls(identity=1, device="cpu", mesh=m), cls(identity=2, device="cpu", mesh=m)
    rng = np.random.default_rng(3)
    keys = [b"k%d" % i for i in range(300)]  # > one shard block's worth
    model = {k: 0 for k in keys}
    for repo in (a, b):
        for k in keys:
            amt = int(rng.integers(1, 1000))
            op = b"DEC" if name == "PNCOUNT" and rng.integers(2) else b"INC"
            repo.apply(_R(), [op, k, str(amt).encode()])
            model[k] += amt if op == b"INC" else -amt
    for src, dst in ((a, b), (b, a)):
        for key, delta in src.flush_deltas():
            dst.converge(key, delta)
    for repo in (a, b):
        for k in keys:
            r = _R()
            repo.apply(r, [b"GET", k])
            assert r.vals == [model[k]], k


def test_sharded_repo_grows_past_initial_capacity():
    m = tmesh(8)
    repo = rc.RepoGCOUNT(identity=5, key_cap=16, device="cpu", mesh=m)
    n = 200
    for i in range(n):
        repo.apply(_R(), [b"INC", b"g%d" % i, b"%d" % (i + 1)])
    repo.converge(b"g0", {99: 7})
    repo.drain()
    assert repo._key_cap >= n and len(repo._ks.parts) == 8
    assert sum(s.counts.shape[0] for s in repo._ks.parts) == repo._key_cap
    for i in range(n):
        r = _R()
        repo.apply(r, [b"GET", b"g%d" % i])
        assert r.vals == [(i + 1) + (7 if i == 0 else 0)]


def test_sharded_treg_convergence_and_ties():
    m = tmesh(8)
    a = rt.RepoTREG(identity=1, device="cpu", mesh=m)
    b = rt.RepoTREG(identity=2, device="cpu", mesh=m)
    assert len(a._ks.parts) == 8
    rng = np.random.default_rng(5)
    keys = [b"r%d" % i for i in range(200)]
    model = {}
    for repo in (a, b):
        for k in keys:
            ts = int(rng.integers(1, 1000))
            val = b"v%d" % rng.integers(100)
            repo.apply(_R(), [b"SET", k, val, str(ts).encode()])
            cur = model.get(k)
            if cur is None or (ts, val) > cur:
                model[k] = (ts, val)
    a.apply(_R(), [b"SET", b"tie", b"apple", b"777"])
    b.apply(_R(), [b"SET", b"tie", b"zebra", b"777"])
    model[b"tie"] = (777, b"zebra")
    for src, dst in ((a, b), (b, a)):
        for key, delta in src.flush_deltas():
            dst.converge(key, delta)
    for repo in (a, b):
        repo.drain()  # the routed drain and its tie patch
        for k in keys + [b"tie"]:
            t = _R()
            repo.apply(t, [b"GET", k])
            assert t.vals == [2, model[k][1], model[k][0]], (k, t.vals)
        row = repo._tbl.find(b"tie")
        assert repo._cache[row][1] == repo._interner.intern(b"zebra")


def test_sharded_tlog_convergence_trim_and_overflow():
    m = tmesh(8)
    a = rl.RepoTLOG(identity=1, len_cap=4, device="cpu", mesh=m)
    b = rl.RepoTLOG(identity=2, len_cap=4, device="cpu", mesh=m)
    assert all(s.wide for s in a._ks.parts) and len(a._ks.parts) == 8
    keys = [b"log%d" % i for i in range(40)]
    for repo, base in ((a, 0), (b, 1000)):
        for k in keys:
            for t in range(6):  # 6 entries > len_cap 4: exercises grow
                repo.apply(_R(), [b"INS", k, b"e%d" % (base + t), b"%d" % (base + t + 1)])
    for src, dst in ((a, b), (b, a)):
        for key, delta in src.flush_deltas():
            dst.converge(key, delta)
    for k in keys:
        ra, rb = _R(), _R()
        a.apply(ra, [b"GET", k])
        b.apply(rb, [b"GET", k])
        assert ra.vals == rb.vals and ra.vals[0] == 12, k
    sa, sb = _R(), _R()
    a.apply(sa, [b"SIZE", keys[0]])
    b.apply(sb, [b"SIZE", keys[0]])
    assert sa.vals == sb.vals == [12]
    a.apply(_R(), [b"TRIM", keys[0], b"3"])
    st = _R()
    a.apply(st, [b"SIZE", keys[0]])
    assert st.vals == [3]
    for key, delta in a.flush_deltas():
        b.converge(key, delta)
    sb2 = _R()
    b.apply(sb2, [b"SIZE", keys[0]])
    assert sb2.vals == [3]


def resp(*parts) -> bytes:
    return b"*%d\r\n" % len(parts) + b"".join(b"$%d\r\n%s\r\n" % (len(p), p) for p in parts)


def test_mesh_database_matches_the_single_device_database():
    """One RESP script and delta stream into a Database on a 4-shard mesh
    and a single-device one: every reply byte and every repo's dump equal;
    TENSOR stays on the mesh's first device."""
    from jylis_tpu_torch.ops.ujson_host import UJSON
    from test_ops_ujson_device import random_mutations

    rng = np.random.default_rng(21)
    dbs = [tdb.Database(1, device="cpu", mesh=tmesh(4)), tdb.Database(1, device="cpu")]
    assert dbs[0].mesh is not None and dbs[1].mesh is None
    assert dbs[0].manager("TENSOR").repo._device == torch.device("cpu")
    outs = [bytearray(), bytearray()]
    writers = [UJSON() for _ in range(3)]
    for step in range(300):
        k = b"k%d" % int(rng.integers(40))
        cmds = [[b"GCOUNT", b"INC", k, b"%d" % rng.integers(1, 99)],
                [b"PNCOUNT", b"DEC", k, b"%d" % rng.integers(1, 99)],
                [b"TREG", b"SET", k, b"v%d" % rng.integers(5), b"%d" % rng.integers(9)],
                [b"TLOG", b"INS", k, b"e%d" % rng.integers(5), b"%d" % rng.integers(50)],
                [b"TLOG", b"TRIM", k, b"2"], [b"GCOUNT", b"GET", k],
                [b"PNCOUNT", b"GET", k], [b"TREG", b"GET", k], [b"TLOG", b"GET", k],
                [b"UJSON", b"GET", b"doc"]]
        cmd = cmds[int(rng.integers(len(cmds)))]
        for db, out in zip(dbs, outs):
            db.apply(tresp.Respond(out.extend), list(cmd))
        if step % 10 == 0:
            w = int(rng.integers(3))
            d = UJSON()
            random_mutations(rng, writers[w], replica=300 + w, n_ops=1, delta=d)
            batches = {"GCOUNT": [(k, {77: int(rng.integers(1, 1 << 40))})],
                       "PNCOUNT": [(k, ({77: 5}, {78: int(rng.integers(1, 9))}))],
                       "TREG": [(k, (b"r%d" % rng.integers(3), int(rng.integers(9))))],
                       "TLOG": [(k, ([(b"x", int(rng.integers(60)))], 0))],
                       "UJSON": [(b"doc", d)] * 70}
            for name, batch in batches.items():
                for db in dbs:
                    db.converge(name, batch)
    assert bytes(outs[0]) == bytes(outs[1])
    for name in ("TREG", "TLOG", "GCOUNT", "PNCOUNT", "UJSON"):
        a, b = (db.manager(name).repo for db in dbs)
        da, db_ = a.dump_state(), b.dump_state()
        if name == "UJSON":
            da = [(key, test_torch_ujson_repo.canon(x)) for key, x in da]
            db_ = [(key, test_torch_ujson_repo.canon(x)) for key, x in db_]
        assert da == db_, name
    assert dbs[0].manager("UJSON").repo._res is not None  # the doc went resident


def test_dryrun_multichip_on_a_cpu_mesh():
    assert dryrun_multichip(["cpu"] * 4) == {
        "devices": ["cpu"] * 4, "mesh": {"rep": 2, "keys": 2},
        "keys_mesh": {"rep": 1, "keys": 4}}


def test_parallel_imports_and_drains_without_jax():
    """The port's mesh package needs no JAX: a process in which importing
    jax fails builds a CPU mesh and runs a routed drain, an unrouted
    (staged) drain and the dryrun."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from jylis_tpu_torch import parallel as p\n"
        "from jylis_tpu_torch.ops import gcount\n"
        "from jylis_tpu_torch.parallel.dryrun import dryrun_multichip\n"
        "m = p.make_mesh(4, devices=['cpu'] * 4)\n"
        "sh = p.shard_state(m, gcount.init(64, 8, 'cpu'))\n"
        "lr, d, s = p.route_drain(np.array([1, 40]), np.ones((2, 8), np.uint64), 4, 16)\n"
        "sums = p.drain_sharded_g(m, sh, lr, d)\n"
        "assert sorted(sums[s >= 0].tolist()) == [8, 8], sums\n"
        "ks = p.Keyspace(m, 'cpu'); ks.init(64, lambda n, dv: gcount.init(n, 8, dv))\n"
        "u = p.drain_unrouted_g(ks, np.array([40, 1]), p.fill_from(np.ones((2, 8), np.uint64)))\n"
        "assert u.tolist() == [8, 8] and 'jylis_tpu_torch.ops.staging' in sys.modules, u\n"
        "dryrun_multichip(['cpu'] * 4)\n"
        "assert not any(k == 'jylis_tpu' or k.startswith('jylis_tpu.') for k in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
