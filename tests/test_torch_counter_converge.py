"""The counters' slice-at-once converge against the key-at-a-time one.

GCOUNT and PNCOUNT join foreign delta columns into dense u64 host planes
a converge slice at a time (``converge_batch``). A seeded batch converged
whole must leave the repo as the same batch converged one key per call
does, and both as a plain-Python join of the deltas says: the served
values, the sync canon bytes, the dumped state and the flushed deltas,
after a drain. The batches hold wire-decoded deltas (read in place from
the native decoder's lists) and plain dicts, keys repeated within a
slice, several replica ids a delta, replica ids past the columns' first
capacity arriving mid-slice, rows past the planes' first capacity, and
values at 0, 2^63 and 2^64-1. A drain that fails in its device call keeps
every pending contribution for the retry.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.cluster.msg import MsgPushDeltas
from jylis_tpu_torch.models import repo_counters as rc
from jylis_tpu_torch.models.database import Database
from jylis_tpu_torch.native.engine import G, PN, make_engine
from jylis_tpu_torch.server.resp import Respond

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)

IDENTITY = 0xC0FFEE
U64 = (1 << 64) - 1
EDGES = (0, 1 << 63, U64)


def value(rng) -> int:
    """Mostly seeded u64s, a quarter of them the edges 0, 2^63, 2^64-1."""
    if rng.random() < 0.25:
        return EDGES[int(rng.integers(0, len(EDGES)))]
    return int(rng.integers(0, U64, dtype=np.uint64, endpoint=True))


def make_batch(rng, kind: str, n: int, n_keys: int, rids: list[int]):
    """n (key, delta) pairs over n_keys keys (repeats within the batch),
    1-4 replica ids a delta; the replica ids open up as the batch goes,
    so new ones arrive mid-slice."""
    out = []
    for i in range(n):
        live = rids[: 2 + (len(rids) - 2) * (i + 1) // n]

        def one():
            pick = rng.choice(len(live), size=int(rng.integers(1, min(4, len(live)) + 1)),
                              replace=False)
            return {live[j]: value(rng) for j in pick}

        key = b"ck%04d" % int(rng.integers(0, n_keys))
        out.append((key, one() if kind == "GCOUNT" else (one(), one() if i % 7 else {})))
    return out


def wire(kind: str, batch):
    """The batch as the native decoder gives it: lazy deltas whose
    ``wire()`` reads the decoded lists."""
    got = codec.decode(codec.encode(MsgPushDeltas(kind, tuple(batch)))).batch
    assert all(hasattr(d, "wire") for _, d in got)
    assert [k for k, _ in got] == [k for k, _ in batch] and list(got) == batch
    return list(got)


def oracle(kind: str, batch):
    """key -> per-polarity {rid: max value}, zeros left out (a plain join)."""
    cols = {}
    for key, delta in batch:
        parts = (delta,) if kind == "GCOUNT" else delta
        c = cols.setdefault(key, [{} for _ in parts])
        for pol, d in enumerate(parts):
            for rid, v in d.items():
                if v > c[pol].get(rid, 0):
                    c[pol][rid] = v
    return cols


def state(repo, kind: str, keys):
    """What the repo serves and syncs, after a drain."""
    repo.drain()
    return ([repo._get_raw(k) for k in keys], [repo.sync_canon(k) for k in keys],
            repo.dump_state(), repo.flush_deltas())


def expected(kind: str, cols, keys):
    raw, canon = [], []
    for k in keys:
        parts = cols.get(k)
        if parts is None:
            raw.append(0)
            canon.append(None)
            continue
        sums = [sum(p.values()) for p in parts]
        raw.append((sums[0] - (sums[1] if kind == "PNCOUNT" else 0)) & U64)
        canon_parts = [sorted(p.items()) for p in parts]
        if kind == "GCOUNT":
            canon.append(repr(canon_parts[0]).encode() if canon_parts[0] else None)
        else:
            canon.append(repr(tuple(canon_parts)).encode() if any(canon_parts) else None)
    dump = [(k, p[0] if kind == "GCOUNT" else tuple(p)) for k, p in sorted(cols.items())
            if any(p)]
    return raw, canon, dump


def fresh(kind: str, engine: str):
    # 16 rows and 8 columns at first: the batches pass both
    return getattr(rc, f"Repo{kind}")(IDENTITY, key_cap=16, rep_cap=8, device="cpu",
                                      engine=engine)


@pytest.mark.parametrize("engine", ["python", "auto"])
@pytest.mark.parametrize("kind", ["GCOUNT", "PNCOUNT"])
@pytest.mark.parametrize("form", ["wire", "dict"])
@pytest.mark.parametrize("seed", [1, 2])
def test_a_slice_at_once_equals_key_by_key_and_the_plain_join(engine, kind, form, seed):
    rng = np.random.default_rng(seed)
    rids = [int(x) for x in rng.integers(1, 1 << 64, 13, dtype=np.uint64)]
    batches = [make_batch(rng, kind, 300, 90, rids) for _ in range(2)]
    if form == "wire":
        batches = [wire(kind, b) for b in batches]
    whole, per_key = fresh(kind, engine), fresh(kind, engine)
    keys = sorted({k for b in batches for k, _ in b}) + [b"never"]
    for batch in batches:
        whole.converge_batch(batch)
        for key, delta in batch:
            per_key.converge(key, delta)
    assert whole._fpend.shape[1] > 16 and whole._fpend.shape[2] > 8  # both grew
    got = state(whole, kind, keys)
    assert got == state(per_key, kind, keys)
    raw, canon, dump = expected(kind, oracle(kind, [x for b in batches for x in b]), keys)
    assert got[:3] == (raw, canon, dump)
    # a local write on top: the own column joins the values, the canon,
    # the dump and the flush
    for repo in (whole, per_key):
        repo.apply(Respond(bytearray().extend), [b"INC", keys[0], b"5"])
        repo.converge_batch(batches[0][:40])
    got = state(whole, kind, keys)
    assert got == state(per_key, kind, keys)
    own = {IDENTITY: 5} if kind == "GCOUNT" else ({IDENTITY: 5}, {})
    joined = oracle(kind, [x for b in batches for x in b] + [(keys[0], own)])
    assert got == (*expected(kind, joined, keys), [(keys[0], own)])


@pytest.mark.parametrize("engine", ["python", "auto"])
@pytest.mark.parametrize("kind", ["GCOUNT", "PNCOUNT"])
def test_load_state_whole_equals_key_by_key(engine, kind):
    """A snapshot's batch, own column included, loaded whole or a key per
    call: the own column also joins the table's own counter."""
    rng = np.random.default_rng(5)
    rids = [IDENTITY] + [int(x) for x in rng.integers(1, 1 << 62, 10)]
    batch = make_batch(rng, kind, 200, 70, rids)
    whole, per_key = fresh(kind, engine), fresh(kind, engine)
    whole.load_state(batch)
    for item in batch:
        per_key.load_state([item])
    keys = sorted({k for k, _ in batch})
    assert state(whole, kind, keys) == state(per_key, kind, keys)
    for repo in (whole, per_key):
        repo.apply(Respond(bytearray().extend), [b"INC", keys[0], b"1"])
    assert whole.flush_deltas() == per_key.flush_deltas() != []


@pytest.mark.parametrize("engine", ["python", "auto"])
@pytest.mark.parametrize("kind", ["GCOUNT", "PNCOUNT"])
def test_a_failed_drain_keeps_every_pending_contribution(engine, kind, monkeypatch):
    rng = np.random.default_rng(9)
    rids = [int(x) for x in rng.integers(1, 1 << 64, 10, dtype=np.uint64)]
    batch = wire(kind, make_batch(rng, kind, 250, 80, rids))
    repo = fresh(kind, engine)
    repo.converge_batch(batch[:120])
    repo.apply(Respond(bytearray().extend), [b"INC", b"ck0001", b"7"])
    real = repo._staged

    def fails(rows, fill, dense, reg):
        real(rows, fill, dense, reg)  # the device call ran, then the host failed
        raise RuntimeError("device call failed")

    monkeypatch.setattr(repo, "_staged", fails)
    with pytest.raises(RuntimeError):
        repo.drain()
    monkeypatch.undo()
    assert repo._frows.any()
    repo.converge_batch(batch[120:])
    keys = sorted({k for k, _ in batch} | {b"ck0001"})
    clean = fresh(kind, engine)
    clean.converge_batch(batch)
    clean.apply(Respond(bytearray().extend), [b"INC", b"ck0001", b"7"])
    assert state(repo, kind, keys) == state(clean, kind, keys)
    assert not repo._frows.any() and not repo._fpend.any()


def test_upsert_foreign_equals_upsert_then_set_foreign():
    """The engine's one-call converge entry gives the rows and the foreign
    flags a loop of upsert + set_foreign gives: new and known keys, a key
    twice, the empty key, both counter tables."""
    rng = np.random.default_rng(3)
    one, loop = make_engine(), make_engine()
    for which in (G, PN):
        for eng in (one, loop):
            for k in (b"a", b"b", b"c"):
                eng.upsert(which, k)
        for n in (0, 1, 37, 500):
            keys = [b"a", b""] + [b"k%d" % int(rng.integers(0, 400)) for _ in range(n)]
            rows = one.upsert_foreign(which, keys)
            want = []
            for k in keys:
                want.append(loop.upsert(which, k))
                loop.set_foreign(which, want[-1])
            assert rows.dtype == np.int64 and rows.tolist() == want
        assert one.rows(which) == loop.rows(which)
        flags = [[e.is_foreign(which, r) for r in range(e.rows(which))] for e in (one, loop)]
        assert flags[0] == flags[1] and flags[0][:3] == [True, False, False]


def mapped_line(db: Database, kind: str) -> int | None:
    out = bytearray()
    db.apply(Respond(out.extend), [b"SYSTEM", b"METRICS"])
    for line in out.split(b"\r\n"):
        if line.startswith(f"{kind} converge_mapped ".encode()):
            return int(line.split()[-1])
    return None


@pytest.mark.parametrize("kind", ["GCOUNT", "PNCOUNT"])
def test_converge_mapped_counts_the_keys_not_read_from_the_wire(kind):
    db = Database(IDENTITY, device="cpu")
    assert mapped_line(db, kind) is None  # no converge yet: no line
    rng = np.random.default_rng(4)
    rids = [int(x) for x in rng.integers(1, 1 << 62, 4)]
    batch = make_batch(rng, kind, 64, 50, rids)
    db.converge(kind, wire(kind, batch))
    assert mapped_line(db, kind) == 0
    db.converge(kind, batch)
    assert mapped_line(db, kind) == len(batch)
