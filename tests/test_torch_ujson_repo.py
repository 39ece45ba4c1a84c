"""The port's UJSON repo (models/repo_ujson.py) against the JAX package's,
repo against repo, on the CPU.

One seeded stream of local commands (GET whole and at paths, SET, INS,
RM, CLR, and malformed ones that render help) and anti-entropy deltas
from several remote writers goes into JAX ``RepoUJSON(1, mesh=None,
engine=None)`` and the port's ``RepoUJSON(1, device="cpu")``, with the
fan-in thresholds lowered alike on both modules (as
tests/test_ops_ujson_resident.py:158-196 does), so keys promote to the
resident store, fold flat and by the tree, trickle on reads, demote on
local writes and re-promote. Every reply byte, every ``may_drain`` and
``drain_overdue`` answer, every ``flush_deltas``, ``_host_only`` and the
final ``dump_state`` (canonicalised) must be equal, and the resident
stores must hold equal planes. A second stream crosses the narrow
layout (the store widens) and a seq past u32 (the key goes host-only).
"""

import numpy as np
import pytest
import torch

from jylis_tpu.models import repo_ujson as jru
from jylis_tpu.models.base import ParseError as JaxParseError
from jylis_tpu.ops.ujson_host import UJSON
from jylis_tpu.server import resp as jresp
from jylis_tpu_torch import convert
from jylis_tpu_torch.models import repo_ujson as tru
from jylis_tpu_torch.models.base import ParseError
from jylis_tpu_torch.server import resp as tresp
from test_ops_ujson_device import random_mutations

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

PATHS = [(), ("a",), ("b",), ("a", "x"), ("c", "y", "z"), ("tags",)]


def canon(doc):
    ents = sorted((dot, path, token) for dot, (path, token) in doc.entries.items())
    return ents, sorted(doc.ctx.vv.items()), sorted(doc.ctx.cloud)


class Pair:
    def __init__(self, monkeypatch, seg=3, dev=6, trickle=2, total=40):
        for mod in (jru, tru):
            monkeypatch.setattr(mod, "SEG_FANIN_MIN", seg)
            monkeypatch.setattr(mod, "DEVICE_FANIN_MIN", dev)
            monkeypatch.setattr(mod, "TRICKLE_MAX", trickle)
            monkeypatch.setattr(mod, "PENDING_TOTAL_MAX", total)
        self.j = jru.RepoUJSON(1, mesh=None, engine=None)
        self.t = tru.RepoUJSON(1, device="cpu")
        self.jout, self.tout = bytearray(), bytearray()
        self.jr, self.tr = jresp.Respond(self.jout.extend), tresp.Respond(self.tout.extend)
        self.drains = 0

    def cmd(self, *args):
        args = [a if isinstance(a, bytes) else str(a).encode() for a in args]
        assert self.t.may_drain(args) == self.j.may_drain(args), args
        for repo, r, err, out in ((self.j, self.jr, JaxParseError, self.jout),
                                  (self.t, self.tr, ParseError, self.tout)):
            try:
                repo.apply(r, list(args))
            except err:
                out.extend(b"HELP\r\n")
        assert bytes(self.tout) == bytes(self.jout), args
        self.check_overdue()

    def converge(self, key, delta):
        self.j.converge(key, delta)
        self.t.converge(key, delta)
        self.check_overdue()

    def check_overdue(self):
        assert self.t.drain_overdue() == self.j.drain_overdue()
        if self.t.drain_overdue():  # the manager drains after the batch
            self.j.drain()
            self.t.drain()
            self.drains += 1
            self.check_stores()

    def check_stores(self):
        assert (self.t._res is None) == (self.j._res is None)
        assert self.t._host_only == self.j._host_only
        assert set(self.t._data) == set(self.j._data)
        assert {k: len(v) for k, v in self.t._pend.items()} == {
            k: len(v) for k, v in self.j._pend.items()}
        if self.t._res is not None:
            a = convert.resident_state(self.j._res)
            b = convert.resident_state(self.t._res)
            pa, pb = a.pop("planes"), b.pop("planes")
            assert a == b
            for x, y in zip(pa or (), pb or ()):
                assert np.array_equal(x, y)

    def flush(self):
        fj, ft = self.j.flush_deltas(), self.t.flush_deltas()
        assert [(k, canon(d)) for k, d in ft] == [(k, canon(d)) for k, d in fj]
        assert self.t.deltas_size() == self.j.deltas_size() == 0
        return len(ft)

    def finish(self):
        dj, dt = self.j.dump_state(), self.t.dump_state()
        assert [(k, canon(d)) for k, d in dt] == [(k, canon(d)) for k, d in dj]
        self.check_stores()
        return dt


def json_arg(rng):
    v = int(rng.integers(50))
    return [str(v), '"s%d"' % v, "true", "null", '{"m": %d, "n": [1, 2]}' % v][
        int(rng.integers(5))]


def test_command_and_delta_stream_matches_jax(monkeypatch):
    rng = np.random.default_rng(17)
    p = Pair(monkeypatch)
    keys = [b"doc%d" % i for i in range(6)]
    writers = {k: UJSON() for k in keys}
    flushed = 0
    for step in range(260):
        k = keys[int(rng.integers(len(keys)))]
        roll = rng.random()
        if roll < 0.55:  # a remote delta from one of four writers
            d = UJSON()
            random_mutations(rng, writers[k], replica=200 + int(rng.integers(4)),
                             n_ops=1, delta=d)
            p.converge(k, d)
        elif roll < 0.75:
            path = PATHS[int(rng.integers(len(PATHS)))]
            p.cmd("GET", k, *path)
        elif roll < 0.83:
            path = PATHS[1 + int(rng.integers(len(PATHS) - 1))]
            p.cmd("INS", k, *path, json_arg(rng).split(",")[0].strip("{") or "1")
        elif roll < 0.89:
            p.cmd("SET", k, *PATHS[int(rng.integers(3))], json_arg(rng))
        elif roll < 0.94:
            p.cmd("RM", k, "tags", str(int(rng.integers(50))))
        else:
            p.cmd("CLR", k, *PATHS[int(rng.integers(3))])
        if step % 37 == 0:
            flushed += p.flush()
    for bad in (("GET",), ("SET", "k"), ("INS", "k", "{bad"), ("RM", "k", "[1]"),
                ("FOO", "k"), ("SET", "k", "a", "{")):
        p.cmd(*bad)
    flushed += p.flush()
    out = p.finish()
    assert p.drains > 3 and flushed > 0 and out
    assert p.t._res is not None and len(p.t._res) > 0  # keys went resident
    assert b"HELP" in p.tout and b"+OK" in p.tout


def test_deep_fanin_promotes_folds_by_the_tree_and_trickles(monkeypatch):
    """One key's fan-in past DEVICE_FANIN_MIN promotes it on the GET path
    (a single-key drain; the tree at D > 64), a trickle below
    TRICKLE_MAX serves host-side, local writes demote, and a segmented
    drain re-promotes several keys together."""
    rng = np.random.default_rng(23)
    p = Pair(monkeypatch, seg=4, dev=80, trickle=3, total=10_000)
    w = UJSON()
    for i in range(90):
        d = UJSON()
        w.ins(300 + i % 5, ("tags",), str(i), delta=d)
        p.converge(b"hot", d)
    p.cmd("GET", b"hot", "tags")
    assert p.t._is_resident(b"hot") and p.t._res._shift < 32
    for _ in range(2):  # a trickle: stays pending, served host-side
        d = UJSON()
        random_mutations(rng, w, replica=301, n_ops=1, delta=d)
        p.converge(b"hot", d)
    p.cmd("GET", b"hot")
    assert len(p.t._pend[b"hot"]) == 2
    p.cmd("INS", b"hot", "tags", "99")  # demotes
    assert not p.t._is_resident(b"hot")
    for k in (b"hot", b"k1", b"k2"):
        for i in range(5):
            d = UJSON()
            random_mutations(rng, w, replica=310 + i, n_ops=1, delta=d)
            p.converge(k, d)
    p.j.drain()
    p.t.drain()
    p.check_stores()
    assert all(p.t._is_resident(k) for k in (b"hot", b"k1", b"k2"))
    p.cmd("GET", b"k1")
    p.finish()


def test_widen_and_host_only_fallback_match_jax(monkeypatch):
    """A delta with a seq past the narrow budget widens the resident
    store to u64; one past u32 sends its key to the host lattice for
    good (``_host_only``), the rest stay resident."""
    p = Pair(monkeypatch, seg=2, dev=3, trickle=1, total=10_000)
    w = UJSON()
    for k in (b"x", b"y", b"z"):
        for i in range(3):
            d = UJSON()
            w.ins(7, ("tags",), '"%s%d"' % (k.decode(), i), delta=d)
            p.converge(k, d)
    p.j.drain()
    p.t.drain()
    p.check_stores()
    assert p.t._res._shift < 32
    big = UJSON()
    big.ctx.vv[8] = (1 << 28) + 5
    d = UJSON()
    big.ins(8, ("a",), "1", delta=d)
    huge = UJSON()
    huge.ctx.vv[9] = 1 << 40
    d2 = UJSON()
    huge.ins(9, ("a",), "2", delta=d2)
    for k, delta in ((b"x", d), (b"x", d), (b"y", d2), (b"y", d)):
        p.converge(k, delta)
    p.j.drain()
    p.t.drain()
    p.check_stores()
    assert p.t._res._shift == 32 and p.t._host_only == {b"y"}
    for k in (b"x", b"y", b"z"):
        p.cmd("GET", k)
        p.cmd("GET", k, "a")
    p.finish()


def test_load_state_round_trips_a_dump(monkeypatch):
    p = Pair(monkeypatch)
    rng = np.random.default_rng(31)
    w = UJSON()
    for i in range(40):
        d = UJSON()
        random_mutations(rng, w, replica=400 + i % 3, n_ops=1, delta=d)
        p.converge(b"k%d" % (i % 4), d)
    dump = p.finish()
    fresh = tru.RepoUJSON(1, device="cpu")
    fresh.load_state(dump)
    assert [(k, canon(d)) for k, d in fresh.dump_state()] == [(k, canon(d)) for k, d in dump]


@pytest.mark.parametrize("args", [[b"GET", b"k"], [b"INS", b"k", b"t", b"1"], [b"TRIM"], []])
def test_may_drain_on_a_fresh_repo_matches_jax(args):
    assert tru.RepoUJSON(1, device="cpu").may_drain(args) == jru.RepoUJSON(
        1, mesh=None, engine=None).may_drain(args)
