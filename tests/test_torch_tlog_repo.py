"""The port's TLOG repo (models/repo_tlog.py) against the JAX package's, on
the CPU.

One seeded stream of commands (INS, GET with and without a count, SIZE,
CUTOFF, TRIM, TRIMAT, CLR) and anti-entropy deltas (entries with
duplicates, raised cutoffs, whole-keyspace sweeps that take the dense
drain) goes into JAX ``RepoTLOG(..., mesh=None, engine="python")`` and
the port's ``RepoTLOG(device="cpu")``. Every reply byte, every
``flush_deltas``, the final ``dump_state``, the capacities and the state
planes (through convert.py) must be equal. Separate streams force a
dense drain's tail-overflow retry, interner compaction past
``COMPACT_SLACK``, and a widen to the 3-plane layout mid-stream.
"""

import numpy as np
import pytest
import torch

from jylis_tpu.models import repo_tlog as jrt
from jylis_tpu.server import resp as jresp
from jylis_tpu_torch import convert
from jylis_tpu_torch.models import repo_tlog as rt
from jylis_tpu_torch.ops import interner
from jylis_tpu_torch.server import resp as tresp

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

U64 = (1 << 64) - 1
WIDE_TS = [1 << 32, (1 << 40) + 3, U64 - 1, U64]
TRIM_COUNTS = [0, 1, 2, 3, 50, U64]  # U64: clamped to the no-op sentinel
VALUES = [b"a", b"b", b"c", b"\xffz", b"shared8b-x", b"shared8b-y", b""]


def assert_same_state(trepo, jrepo):
    got = convert.tlog_to_jax(trepo._state)
    st = jrepo._state
    want = (None if st.nth is None else np.asarray(st.nth), np.asarray(st.ntl),
            np.asarray(st.nv), np.asarray(st.length), np.asarray(st.cutoff))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(g, w)
    assert (trepo._key_cap, trepo._len_cap) == (jrepo._key_cap, jrepo._len_cap)


class Pair:
    """Both repos, fed the same calls; replies compared after each."""

    def __init__(self):
        self.j = jrt.RepoTLOG(1, mesh=None, engine="python")
        self.t = rt.RepoTLOG(1, device="cpu")
        self.jout, self.tout = bytearray(), bytearray()
        self.jr = jresp.Respond(self.jout.extend)
        self.tr = tresp.Respond(self.tout.extend)

    def cmd(self, *args):
        args = [a if isinstance(a, bytes) else b"%d" % a for a in args]
        assert self.t.may_drain(list(args)) == self.j.may_drain(list(args))
        self.j.apply(self.jr, list(args))
        self.t.apply(self.tr, list(args))
        assert bytes(self.tout) == bytes(self.jout), args

    def converge(self, key, delta):
        self.j.converge(key, delta)
        self.t.converge(key, delta)
        assert self.t.drain_overdue() == self.j.drain_overdue()

    def drain(self):
        self.j.drain()
        self.t.drain()

    def flush(self):
        assert self.t.flush_deltas() == self.j.flush_deltas()

    def finish(self, keys):
        for k in keys:
            self.cmd(b"GET", k)
            self.cmd(b"SIZE", k)
            self.cmd(b"CUTOFF", k)
        self.flush()
        assert self.t.dump_state() == self.j.dump_state()
        assert_same_state(self.t, self.j)
        assert len(self.t._interner) == len(self.j._interner)


def ts_of(rng, wide: bool) -> int:
    if wide and rng.random() < 0.3:
        return WIDE_TS[int(rng.integers(len(WIDE_TS)))]
    return int(rng.integers(0, 60))


def run_stream(seed, n_keys, n_ops, weights, widen_at=None):
    rng = np.random.default_rng(seed)
    keys = [b"log%d" % i for i in range(n_keys)]
    p = Pair()
    ops = ["INS", "GET", "SIZE", "CUTOFF", "TRIM", "TRIMAT", "CLR", "CONV",
           "BULK", "DRAIN", "FLUSH"]
    w = np.asarray(weights, float)
    for i in range(n_ops):
        wide = widen_at is not None and i >= widen_at
        op = ops[rng.choice(len(ops), p=w / w.sum())]
        key = keys[int(rng.integers(n_keys))]
        if op == "INS":
            p.cmd(b"INS", key, VALUES[int(rng.integers(len(VALUES)))], ts_of(rng, wide))
        elif op == "GET":
            p.cmd(*([b"GET", key] + ([int(rng.integers(0, 6))]
                                     if rng.random() < 0.5 else [])))
        elif op in ("SIZE", "CUTOFF", "CLR"):
            p.cmd(op.encode(), key)
        elif op == "TRIM":
            p.cmd(b"TRIM", key, TRIM_COUNTS[int(rng.integers(len(TRIM_COUNTS)))])
        elif op == "TRIMAT":
            p.cmd(b"TRIMAT", key, ts_of(rng, wide) // 2)
        elif op == "CONV":
            ents = [(VALUES[int(rng.integers(len(VALUES)))], ts_of(rng, wide))
                    for _ in range(int(rng.integers(0, 5)))]
            ents += ents[:1]  # a duplicate inside the delta
            p.converge(key, (ents, int(rng.integers(0, 20)) if rng.random() < 0.3 else 0))
        elif op == "BULK":
            # one replica's sweep over half the keyspace: the dense drain
            for k in rng.choice(n_keys, max(1, n_keys // 2), replace=False):
                ents = [(VALUES[int(rng.integers(len(VALUES)))], ts_of(rng, wide))
                        for _ in range(int(rng.integers(1, 4)))]
                p.converge(keys[k], (ents, 0))
            p.drain()
        elif op == "DRAIN":
            p.drain()
        else:
            p.flush()
    p.finish(keys)
    return p


@pytest.fixture
def drains(monkeypatch):
    """Which device steps the port's repo ran, in order."""
    calls = []
    for fn in ("_drain", "_drain_dense", "_get_row"):
        orig = getattr(rt, fn)
        monkeypatch.setattr(
            rt, fn, lambda *a, _o=orig, _n=fn: calls.append(_n) or _o(*a))
    return calls


@pytest.mark.parametrize("seed,n_keys,n_ops,weights,steps", [
    # single-key commands: sparse drains, trims fused into them
    (0, 6, 500, [5, 3, 2, 1, 1, 1, 0.5, 3, 0, 0.5, 0.5], {"_drain"}),
    # sweeps over half the keys (300 >= 1024 / 4): dense drains too
    (1, 600, 300, [4, 2, 1, 1, 1, 1, 0.5, 2, 0.1, 0.5, 0.5],
     {"_drain", "_drain_dense"}),
    # more keys than the first key capacity
    (2, 1100, 60, [2, 1, 1, 1, 1, 1, 0.5, 2, 1, 0.5, 0.5],
     {"_drain", "_drain_dense"}),
])
def test_command_and_delta_stream_matches_jax(drains, seed, n_keys, n_ops,
                                              weights, steps):
    p = run_stream(seed, n_keys, n_ops, weights)
    out = bytes(p.tout)
    assert b"*2\r\n" in out and b"*0\r\n" in out
    assert steps <= set(drains)
    assert not p.t._state.wide
    if n_keys > 1024:
        assert p.t._key_cap == 2048


def test_mid_stream_widen_matches_jax():
    """64-bit timestamps arrive half way: the narrow state widens before
    the drain that carries them, in both packages."""
    p = run_stream(3, 600, 400, [4, 2, 1, 1, 1, 1, 0.5, 2, 0.1, 0.5, 0.5],
                   widen_at=200)
    assert p.t._state.wide and p.j._state.wide


def test_dense_tail_overflow_retry_matches_jax(monkeypatch):
    """Uneven rows: a few keys hold 14 entries (len_cap 16), then a sweep
    over every other key brings 4 entries each (5 with a re-delivered
    one, so Ld = 8). The sweep takes the dense
    drain, whose conservative rule (length > L - Ld, on every row) flags
    the long rows; the port leaves them untouched, grows len_cap to 32
    and drains the same delta again, ending on JAX's planes and len_cap."""
    grows = []
    orig = rt.tlog.grow
    monkeypatch.setattr(rt.tlog, "grow",
                        lambda st, k, l: grows.append((k, l)) or orig(st, k, l))
    dense = []
    orig_dense = rt._drain_dense
    monkeypatch.setattr(rt, "_drain_dense",
                        lambda *a: dense.append(1) or orig_dense(*a))
    p = Pair()
    keys = [b"k%d" % i for i in range(300)]
    for k in keys[:3]:
        for t in range(14):
            p.cmd(b"INS", k, b"v%d" % t, 100 + t)
    p.drain()
    assert p.t._len_cap == 16 and grows == []
    for k in keys[3:]:
        p.converge(k, ([(b"w%d" % j, 200 + j) for j in range(4)], 0))
        p.converge(k, ([(b"w0", 200)], 0))  # re-delivered: deduplicated
    p.drain()
    assert len(dense) == 2  # flagged once, then merged
    assert grows[-1] == (1024, 32)
    p.cmd(b"GET", keys[0], 3)
    p.cmd(b"SIZE", keys[1])
    p.finish(keys)
    assert p.t._state.length[:5].tolist() == [14, 14, 14, 4, 4]


def test_interner_compaction_matches_jax(monkeypatch):
    """INS churn trimmed away strands interner ids; past 2 x live +
    COMPACT_SLACK the drain compacts and rewrites the vid plane. The
    slack is lowered in both packages alike so a short stream compacts
    often; run_stream compares the planes and the interner's size."""
    monkeypatch.setattr(rt, "COMPACT_SLACK", 32)
    monkeypatch.setattr(jrt, "COMPACT_SLACK", 32)
    compactions = []
    orig = interner.Interner.compact
    monkeypatch.setattr(interner.Interner, "compact",
                        lambda self, live: compactions.append(1) or orig(self, live))
    rng = np.random.default_rng(8)
    p = Pair()
    keys = [b"c%d" % i for i in range(5)]
    for step in range(60):
        for k in keys:
            for j in range(4):
                p.cmd(b"INS", k, b"val%d-%d" % (step, j), step * 10 + j)
        for k in keys:
            p.cmd(b"TRIM", k, int(rng.integers(1, 4)))
        if step % 7 == 0:
            p.cmd(b"CLR", keys[int(rng.integers(len(keys)))])
    p.finish(keys)
    assert len(compactions) >= 2
    assert [p.t._interner.lookup(i) for i in range(len(p.t._interner))] == [
        p.j._interner.lookup(i) for i in range(len(p.j._interner))]


def test_threshold_drain_and_database_routing():
    """A row filling its pending window drains inline (sync path); the
    Database routes TLOG between TREG and GCOUNT, as the JAX registry
    orders them."""
    from jylis_tpu_torch.models import database as tdb

    p = Pair()
    for t in range(rt.ROW_DRAIN_THRESHOLD):
        p.cmd(b"INS", b"hot", b"v%d" % (t % 9), t)
    assert p.t._tbl.pend_len(p.t._tbl.find(b"hot")) == 0
    p.finish([b"hot"])
    db = tdb.Database(1, device="cpu")
    out = bytearray()
    r = tresp.Respond(out.extend)
    db.apply(r, [b"TLOG", b"INS", b"l", b"x", b"3"])
    db.apply(r, [b"TLOG", b"GET", b"l"])
    db.apply(r, [b"TLOG", b"TRIM", b"l"])
    assert bytes(out).startswith(
        b"+OK\r\n*1\r\n*2\r\n$1\r\nx\r\n:3\r\n-BADCOMMAND (could not parse "
        b"command)\nThis operation expects the arguments in the following "
        b"form:\nTLOG TRIM key count\r\n")
    assert [m.decode() for m in db._map] == [
        "TREG", "TLOG", "GCOUNT", "PNCOUNT", "UJSON", "TENSOR", "MAP", "BCOUNT", "SYSTEM"]
