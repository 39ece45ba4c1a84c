"""The port's ResidentStore (jylis_tpu_torch/ops/ujson_resident.py) against
the JAX package's, store against store, on the CPU.

Both stores take the same operations — admissions, epochs of
``fold_in`` (flat folds at D <= 64, tree folds above), evictions and
discards, capacity growth, the narrow repack on replica growth, the
widen to u64, a seq past u32 (OverflowError, rows unchanged), broadcast
folds (lazy, and flushed past a lowered BCAST_FLUSH_DELTAS), and full
reads that re-tighten the widths and compact the payload interner. After
every step the two hold equal planes bit for bit (through convert.py),
shift, replica budget, rows, free list, width bounds, max seq and
interners, and decode to equal documents. The JAX store runs with
``mesh=None``: the single-device subset fold the port ports.
"""

import numpy as np
import pytest
import torch

from jylis_tpu.ops import ujson_resident as jres
from jylis_tpu.ops.ujson_host import UJSON
from jylis_tpu_torch import convert
from jylis_tpu_torch.ops import ujson_resident as tres
from test_ops_ujson_device import copy_doc, random_mutations

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)


def make_deltas(rng, doc, replica, n, n_ops=1):
    out = []
    for _ in range(n):
        d = UJSON()
        random_mutations(rng, doc, replica=replica, n_ops=n_ops, delta=d)
        out.append(d)
    return out


class Twin:
    """A JAX store and a port store driven alike and compared."""

    def __init__(self, n_rep=8):
        self.j = jres.ResidentStore(n_rep=n_rep, mesh=None)
        self.t = tres.ResidentStore(n_rep=n_rep, device="cpu")

    def both(self, name, *args):
        out = []
        for store in (self.j, self.t):
            try:
                out.append(getattr(store, name)(*args))
            except OverflowError as e:
                out.append(e)
        assert isinstance(out[0], OverflowError) == isinstance(out[1], OverflowError), out
        return out

    def check(self):
        a, b = convert.resident_state(self.j), convert.resident_state(self.t)
        pa, pb = a.pop("planes"), b.pop("planes")
        assert a == b
        assert (pa is None) == (pb is None)
        if pa is not None:
            for x, y in zip(pa, pb):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert np.array_equal(x, y)

    def check_docs(self, oracle=None):
        dj, dt = dict(self.j.dump()), dict(self.t.dump())
        assert dj.keys() == dt.keys()
        for k in dj:
            assert dj[k].entries == dt[k].entries
            assert (dj[k].ctx.vv, dj[k].ctx.cloud) == (dt[k].ctx.vv, dt[k].ctx.cloud)
            if oracle is not None:
                assert dt[k].render() == oracle[k].render()
        self.check()


@pytest.mark.parametrize("fanin", [4, 70], ids=["flat", "tree"])
def test_admit_and_fold_epochs_match_jax(fanin):
    rng = np.random.default_rng(3 + fanin)
    tw = Twin()
    keys = [b"a", b"b", b"c", b"d", b"e"]
    oracle = {k: UJSON() for k in keys}
    writers = {k: UJSON() for k in keys}
    for i, k in enumerate(keys[:3]):
        random_mutations(rng, oracle[k], replica=20 + i, n_ops=4)
        writers[k] = copy_doc(oracle[k])
    tw.both("admit", [(k, copy_doc(oracle[k])) for k in keys[:3]])
    tw.check()
    for epoch in range(5):
        if epoch == 2:  # later admissions land beside folded rows
            tw.both("admit", [(k, copy_doc(oracle[k])) for k in keys[3:]])
        pending = {}
        for i, k in enumerate(keys[: 3 + 2 * (epoch >= 2)]):
            if (epoch + i) % 3 == 0:
                continue  # a subset drain: untouched rows stay as they are
            pending[k] = make_deltas(rng, writers[k], replica=10 + (i + epoch) % 6,
                                     n=fanin)
            for d in pending[k]:
                oracle[k].converge(d)
        tw.both("fold_in", pending)
        tw.check()
        if epoch % 2:
            k = keys[epoch]
            got = tw.both("read", k)
            assert got[0].render() == got[1].render() == oracle[k].render()
            tw.check()
    tw.check_docs(oracle)


def test_evict_discard_and_capacity_growth_match_jax():
    rng = np.random.default_rng(11)
    tw = Twin()
    keys = [b"k%02d" % i for i in range(30)]
    docs = {}
    for i, k in enumerate(keys[:10]):
        docs[k] = UJSON()
        random_mutations(rng, docs[k], replica=i % 6 + 1, n_ops=3)
    tw.both("admit", [(k, copy_doc(docs[k])) for k in keys[:10]])
    ev = tw.both("evict", b"k03")
    assert ev[0].render() == ev[1].render() == docs[b"k03"].render()
    tw.both("discard", b"k07")
    tw.check()
    for i, k in enumerate(keys[10:]):  # past capacity: the row axis grows
        docs[k] = UJSON()
        random_mutations(rng, docs[k], replica=i % 6 + 1, n_ops=2)
    tw.both("admit", [(k, copy_doc(docs[k])) for k in keys[10:]])
    tw.check()
    pending = {k: make_deltas(rng, docs[k], replica=40, n=3) for k in keys[5:25:3]}
    tw.both("fold_in", pending)
    tw.check_docs()
    assert tw.t._row_axis() > 16


def test_narrow_repack_and_widen_match_jax():
    """Replica growth past the narrow budget repacks (shift 29 -> 28 ->
    ... -> 26 or below), then a seq past the narrow budget widens to
    u64/32."""
    rng = np.random.default_rng(7)
    tw = Twin(n_rep=4)
    doc, writer = UJSON(), UJSON()
    tw.both("admit", [(b"k", copy_doc(doc)), (b"j", UJSON())])
    shifts = []
    for r in range(40):
        deltas = make_deltas(rng, writer, replica=100 + r, n=2)
        for d in deltas:
            doc.converge(d)
        tw.both("fold_in", {b"k": deltas})
        tw.check()
        shifts.append(tw.t._shift)
    assert shifts[0] == 29 and shifts[-1] <= 26 and 28 in shifts
    big = UJSON()
    big.ctx.vv[2] = 1 << 30
    d2 = UJSON()
    big.ins(2, ("y",), "2", delta=d2)
    d2.ctx.vv[2] = 1 << 30
    doc.converge(d2)
    tw.both("fold_in", {b"k": [d2], b"j": [d2]})
    assert tw.t._shift == 32
    tw.check_docs()
    assert tw.t.read(b"k").render() == doc.render()


def test_overflow_past_u32_raises_with_rows_unchanged():
    tw = Twin()
    a = UJSON()
    a.ins(1, ("x",), "1")
    tw.both("admit", [(b"k", copy_doc(a))])
    d = UJSON()
    d.ctx.vv[9] = 1 << 40
    out = tw.both("fold_in", {b"k": [d]})
    assert isinstance(out[1], OverflowError)
    # the narrow layout could not hold the seq: both stores widened, and
    # the row's content is the admitted document
    assert tw.t._shift == 32
    tw.check_docs({b"k": a})


def test_broadcast_folds_match_jax(monkeypatch):
    """Rounds buffer and coalesce (the read flushes them); past a
    lowered BCAST_FLUSH_DELTAS a round flushes by itself, at D > 64 (the
    tree) and D <= 64 (the flat rule); free rows stay identity."""
    rng = np.random.default_rng(19)
    monkeypatch.setattr(jres.ResidentStore, "BCAST_FLUSH_DELTAS", 80)
    monkeypatch.setattr(tres.ResidentStore, "BCAST_FLUSH_DELTAS", 80)
    tw = Twin()
    n_rep = 6
    replicas = [UJSON() for _ in range(n_rep)]
    writers = [UJSON() for _ in range(n_rep)]
    tw.both("admit", [(b"rep%d" % i, copy_doc(r)) for i, r in enumerate(replicas)])
    tw.both("discard", b"rep2")
    replicas[2] = None
    for rnd, per in enumerate((3, 3, 20, 2)):
        deltas = []
        for r, w in enumerate(writers):
            deltas.extend(make_deltas(rng, w, replica=r, n=per))
        tw.both("fold_in_broadcast", deltas)
        for doc in replicas:
            if doc is not None:
                for d in deltas:
                    doc.converge(d)
        tw.check()
        if rnd == 1:
            tw.both("block")
            tw.check()
    oracle = {b"rep%d" % i: d for i, d in enumerate(replicas) if d is not None}
    tw.check_docs(oracle)
    assert len({d.render() for d in oracle.values()}) == 1


def test_full_reads_retighten_widths_and_compact_payloads():
    """Value churn inflates the width bounds and leaves dead payload ids;
    a full read re-tightens the planes and compacts the interner (remap
    on the device) exactly as the JAX store does."""
    rng = np.random.default_rng(29)
    tw = Twin()
    keys = [b"x", b"y"]
    writers = {k: UJSON() for k in keys}
    tw.both("admit", [(k, UJSON()) for k in keys])
    for epoch in range(6):
        pending = {}
        for k in keys:
            lst = []
            for j in range(12):
                d = UJSON()
                writers[k].set_doc(3, ("f",), str(epoch * 100 + j), delta=d)
                lst.append(d)
            pending[k] = lst
        tw.both("fold_in", pending)
        tw.check()
    wide_before = tw.t._batch.dots.shape[1]
    pays_before = len(tw.t._pay_rev)
    tw.both("read_many", list(keys))
    tw.check()
    assert tw.t._batch.dots.shape[1] < wide_before
    assert len(tw.t._pay_rev) < pays_before
    tw.check_docs({k: writers[k] for k in keys})


def test_live_widths_copy_is_ready_on_the_cpu():
    store = tres.ResidentStore(device="cpu")
    live = tres._Live(torch.tensor([3, 5], dtype=torch.int32))
    assert live.ready() and live.get() == (3, 5)
    assert store.approx_bytes() == 0 and not store.full()


def test_a_drain_with_one_wide_delta_sends_every_key_to_a_cta(monkeypatch):
    """A store drain of 132 keys (a launch that fills an H100's 132 SMs),
    four deltas a key, one of which sets a JSON object of ten fields: the
    launch's deltas share one width, so all 132 keys go past the warp
    class (8 dots a delta) to a CTA a key (ujson_resident.flat_plan). The
    folded documents equal the host join."""
    import json

    rng = np.random.default_rng(11)
    keys = [b"k%03d" % i for i in range(132)]
    oracle = {k: UJSON() for k in keys}
    for i, k in enumerate(keys):
        oracle[k].ins(1, ("a",), str(i))
    store = tres.ResidentStore(n_rep=8, device="cpu")
    store.admit([(k, copy_doc(oracle[k])) for k in keys])
    pending = {}
    for i, k in enumerate(keys):
        pending[k] = make_deltas(rng, copy_doc(oracle[k]), replica=2 + i % 3, n=3)
        if i == 7:
            wide = UJSON()
            copy_doc(oracle[k]).set_doc(5, ("w",), json.dumps({f"f{j}": j for j in range(10)}),
                                        delta=wide)
            pending[k].append(wide)
        for d in pending[k]:
            oracle[k].converge(d)
    grids = []
    fold = tres.fold_flat
    monkeypatch.setattr(tres, "fold_flat", lambda g, s: grids.append(g) or fold(g, s))
    store.fold_in(pending)
    (g,) = grids
    k, d, w = g.dots.shape
    assert k >= 132 and d <= tres.FLAT_MAX and w > 8
    plan = tres.flat_plan(k, g.dots.element_size(), d, w, g.cloud.shape[-1], g.vv.shape[-1])
    assert plan.kind == "cta"
    for key in keys:
        assert store.read(key).render() == oracle[key].render()
