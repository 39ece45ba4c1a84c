"""MAP and BCOUNT in the port against the JAX package, byte for byte.

One seeded command and delta stream -- MAP over all four inner types
(SET, GET, DEL and KEYS, tombstones, type-dominance flips, foreign field
units, a malformed composite key, parse failures) and BCOUNT (GRANT,
INC, DEC, TRANSFER and GET, both OUTOFBOUND refusals, foreign escrow
views, values near 2^64) -- goes into a JAX ``Database(identity,
engine="python")`` through the JAX package's ``Respond`` writer and into
the port's ``Database(identity, device="cpu")`` through its own. The
reply bytes, each repo's ``dump_state`` and the flushed deltas must be
equal (tolerance 0: these are exact host lattices). Both databases are
built once for the module, so the reference's set-up is paid once.
"""

import copy
import random

import numpy as np
import pytest
import torch

from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.ops import bcount as jbcount
from jylis_tpu.ops import compose as jcompose
from jylis_tpu.server.resp import Respond as JaxRespond
from jylis_tpu_torch.models.database import Database
from jylis_tpu_torch.ops import bcount as tbcount
from jylis_tpu_torch.ops import compose as tcompose
from jylis_tpu_torch.server.resp import Respond

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

IDENTITY = 0xABCDEF
U64 = (1 << 64) - 1
FOREIGN = (7, 8, 9)
INNER = ("TREG", "TLOG", "GCOUNT", "PNCOUNT")


def pick(rng, options):
    """One of ``options``, as it is: numpy's choice would turn a list of
    ints near 2^64 into floats."""
    return options[int(rng.integers(len(options)))]


def inner_args(rng, itype: str) -> list[bytes]:
    """A ``MAP <itype> SET key field`` tail, with values near 2^64."""
    if itype in ("TREG", "TLOG"):
        ts = int(pick(rng, [0, 1, 5, 1 << 40, U64 - 1, U64]))
        return [b"v%d" % rng.integers(4), b"%d" % ts]
    amount = int(pick(rng, [1, 3, 1 << 62, U64 - 2, U64]))
    if itype == "PNCOUNT":
        return [b"%s%d" % (pick(rng, [b"", b"+", b"-"]), amount)]
    return [b"%d" % amount]


def inner_val(rng, itype: str):
    """An inner value in its wire shape, from a foreign replica."""
    rid = int(pick(rng, FOREIGN))
    if itype == "TREG":
        return (b"w%d" % rng.integers(4), int(pick(rng, [0, 5, U64])))
    if itype == "TLOG":
        ents = tuple(sorted({(b"e%d" % rng.integers(3), int(rng.integers(0, 9)))
                             for _ in range(int(rng.integers(0, 4)))},
                            key=lambda e: (e[1], e[0]), reverse=True))
        return (ents, int(rng.integers(0, 3)))
    if itype == "GCOUNT":
        return {rid: int(pick(rng, [1, 9, U64]))}
    return ({rid: int(rng.integers(1, 50))}, {rid: int(pick(rng, [2, U64]))})


def map_fields(t: bytes) -> list[bytes]:
    """The fields of inner type ``t``: three of its own, two shared."""
    return [t[:2] + b"%d" % i for i in range(3)] + [b"x0", b"x1"]


def map_steps(rng, n: int = 220):
    """("cmd", [words]) and ("conv", batch) steps over 6 keys; a field is
    mostly one type's own (the greater type name wins a shared field
    wholesale, so GCOUNT would rarely survive there)."""
    steps = []
    for _ in range(n):
        itype = str(pick(rng, INNER))
        t = itype.encode()
        key, field = b"m%d" % rng.integers(6), pick(rng, map_fields(t))
        r = rng.random()
        if r < 0.4:
            steps.append(("cmd", [b"MAP", t, b"SET", key, field] + inner_args(rng, itype)))
        elif r < 0.55:
            steps.append(("cmd", [b"MAP", t, b"GET", key, field]))
        elif r < 0.65:
            steps.append(("cmd", [b"MAP", t, b"DEL", key, field]))
        elif r < 0.72:
            steps.append(("cmd", [b"MAP", t, b"KEYS", key]))
        elif r < 0.92:
            rid = int(pick(rng, FOREIGN))
            ver = {rid: int(rng.integers(1, 4))} if rng.random() < 0.8 else {}
            tomb = {rid: int(rng.integers(0, 3))} if rng.random() < 0.3 else {}
            packed = jcompose.pack_field(key, field)
            steps.append(("conv", [(packed, (itype, ver, tomb, inner_val(rng, itype)))]))
        else:
            steps.append(("cmd", [
                [b"MAP", b"FOO", b"SET", key, field, b"1"],
                [b"MAP", b"TREG", b"SET", key, field, b"v"],
                [b"MAP", b"GCOUNT", b"SET", key, field, b"-1"],
                [b"MAP", b"TLOG"], [b"MAP"], [b"MAP", b"TREG", b"BAD", key],
                [b"MAP", b"PNCOUNT", b"GET", key],
            ][int(rng.integers(7))]))
    # a composite key no unpack can parse: dropped at the converge boundary
    steps.append(("conv", [(b"\xff", ("TREG", {7: 1}, {}, (b"x", 1)))]))
    steps.append(("cmd", [b"MAP", b"TREG", b"KEYS", b"m0"]))
    return steps


def bcount_view(rng):
    """A foreign replica's full per-key BCOUNT view (five components):
    grants, spends and transfers, some of them to this node's identity."""
    rid = int(pick(rng, FOREIGN))
    g = int(pick(rng, [10, 100, 1 << 40, U64]))
    inc = int(rng.integers(0, 5))
    dec = int(rng.integers(0, inc + 1))
    xi = {(rid, IDENTITY): int(rng.integers(0, 3))} if rng.random() < 0.5 else {}
    xd = {(rid, IDENTITY): int(rng.integers(0, inc - dec + 1))} if rng.random() < 0.5 else {}
    return ({rid: g}, {rid: inc}, {rid: dec} if dec else {}, xi, xd)


def bcount_steps(rng, n: int = 220):
    # a grant cell at 2^64 - 1 refuses the next grant; an empty key's
    # escrow refuses a DEC and funds an INC up to its grant
    steps = [("cmd", c) for c in (
        [b"BCOUNT", b"GRANT", b"b0", b"%d" % U64], [b"BCOUNT", b"GRANT", b"b0", b"1"],
        [b"BCOUNT", b"DEC", b"b1", b"1"], [b"BCOUNT", b"GRANT", b"b1", b"3"],
        [b"BCOUNT", b"INC", b"b1", b"4"], [b"BCOUNT", b"INC", b"b1", b"3"],
        [b"BCOUNT", b"GET", b"b1"])]
    for _ in range(n):
        key = b"b%d" % rng.integers(5)
        r = rng.random()
        amount = b"%d" % int(pick(rng, [0, 1, 2, 5, 50, 1 << 40, U64]))
        if r < 0.15:
            steps.append(("cmd", [b"BCOUNT", b"GRANT", key, amount]))
        elif r < 0.35:
            steps.append(("cmd", [b"BCOUNT", b"INC", key, amount]))
        elif r < 0.55:
            steps.append(("cmd", [b"BCOUNT", b"DEC", key, amount]))
        elif r < 0.65:
            to = b"%d" % int(pick(rng, FOREIGN + (IDENTITY,)))
            pol = [[], [b"INC"], [b"DEC"]][int(rng.integers(3))]
            steps.append(("cmd", [b"BCOUNT", b"TRANSFER", key, to, amount] + pol))
        elif r < 0.8:
            steps.append(("cmd", [b"BCOUNT", b"GET", key]))
        elif r < 0.95:
            steps.append(("conv", [(key, bcount_view(rng))]))
        else:
            steps.append(("cmd", [
                [b"BCOUNT", b"INC", key], [b"BCOUNT", b"INC", key, b"-1"],
                [b"BCOUNT", b"FOO"], [b"BCOUNT"],
                [b"BCOUNT", b"TRANSFER", key, b"7", b"1", b"BAD"],
                [b"BCOUNT", b"GRANT", key, b"%d" % (U64 + 1)],
            ][int(rng.integers(6))]))
    return steps


def run(db, respond_cls, name: str, steps, converge) -> bytes:
    out = bytearray()
    resp = respond_cls(out.extend)
    for step in steps:
        if step[0] == "cmd":
            db.apply(resp, list(step[1]))
        else:
            converge(db, name, copy.deepcopy(step[1]))
    return bytes(out)


@pytest.fixture(scope="module")
def streams():
    """Both databases fed the MAP stream, then the BCOUNT stream (and the
    MAP GET/KEYS of every key at the end); the replies of each stream,
    the dumps and the deltas each database flushes at the end."""
    jdb = JaxDatabase(identity=IDENTITY, engine="python")
    tdb = Database(identity=IDENTITY, device="cpu")

    def jconv(db, name, batch):
        db.converge_deltas((name, batch))

    def tconv(db, name, batch):
        db.converge(name, batch)

    out = {}
    rng = np.random.default_rng(2026)
    for name, steps in (("MAP", map_steps(rng)), ("BCOUNT", bcount_steps(rng))):
        out[name] = (run(jdb, JaxRespond, name, steps, jconv),
                     run(tdb, Respond, name, steps, tconv))
    tail = [("cmd", [b"MAP", t.encode(), b"KEYS", b"m%d" % k]) for t in INNER for k in range(6)]
    tail += [("cmd", [b"MAP", t.encode(), b"GET", b"m%d" % k, f])
             for t in INNER for k in range(6) for f in map_fields(t.encode())]
    tail += [("cmd", [b"BCOUNT", b"GET", b"b%d" % k]) for k in range(5)]
    out["reads"] = (run(jdb, JaxRespond, "MAP", tail, jconv), run(tdb, Respond, "MAP", tail, tconv))
    out["dumps"] = {n: (jdb.manager(n).repo.dump_state(), tdb.manager(n).repo.dump_state())
                    for n in ("MAP", "BCOUNT")}
    flushed = ([], [])
    jdb.flush_deltas(flushed[0].append)
    tdb.flush_deltas(flushed[1].append)
    out["flushed"] = flushed
    out["dbs"] = (jdb, tdb)
    return out


@pytest.mark.parametrize("name", ["MAP", "BCOUNT", "reads"])
def test_replies_match_jax(streams, name):
    want, got = streams[name]
    assert got == want
    assert len(want) > 1000


def test_replies_cover_the_surface(streams):
    """The stream reaches the paths it is meant to: help texts, both
    OUTOFBOUND refusals, live values near 2^64 and tombstoned fields."""
    text = b"".join(streams[n][1] for n in ("MAP", "BCOUNT", "reads"))
    for want in (b"-BADCOMMAND (could not parse command)\nThe following are valid operations"
                 b" for this data type:\nMAP SET type key field",
                 b"This operation expects the arguments in the following form:\nBCOUNT INC key amount",
                 b"-OUTOFBOUND (insufficient local dec escrow: rights ",
                 b"-OUTOFBOUND (insufficient local inc escrow: rights ",
                 b"-OUTOFBOUND (grant overflows this replica's u64 grant cell: ",
                 b":18446744073709551615\r\n", b"$-1\r\n"):
        assert want in text, want
    jdb, tdb = streams["dbs"]
    m = tdb.manager("MAP").repo
    assert m._dropped_units == jdb.manager("MAP").repo._dropped_units == 1
    fields = [f for mp in m._tbl.maps.values() for f in mp.fields.values()]
    assert any(not f.live() for f in fields) and any(f.live() for f in fields)
    assert len({f.itype for f in fields}) == 4


@pytest.mark.parametrize("name", ["MAP", "BCOUNT"])
def test_dump_state_matches_jax(streams, name):
    want, got = streams["dumps"][name]
    assert got == want
    assert len(want) >= 5


def test_flushed_deltas_match_jax(streams):
    want, got = streams["flushed"]
    assert got == want
    names = [n for n, batch in got if batch]
    assert "MAP" in names and "BCOUNT" in names


# ---- the lattices themselves, on the JAX package's own generators ---------------


@pytest.mark.parametrize("itype", INNER)
def test_inner_lattice_joins_match_jax(itype):
    """Each registered inner lattice: join, canon, bottom test and the RESP
    write of the port's copy against the JAX package's, on values from
    the JAX registry's seeded generator."""
    rng = random.Random(hash(itype) & 0xFFFF)
    ji, ti = jcompose.REGISTRY[itype], tcompose.REGISTRY[itype]
    for _ in range(200):
        a, b = ji.gen(rng), ji.gen(rng)
        assert ti.join(ti.copy(a), ti.copy(b)) == ji.join(ji.copy(a), ji.copy(b))
        assert ti.canon(a) == ji.canon(a) and ti.is_bottom(a) == ji.is_bottom(a)
        args = inner_args(np.random.default_rng(rng.randrange(1 << 30)), itype)
        assert ti.write(ti.copy(a), 7, args) == ji.write(ji.copy(a), 7, args)
    units = [(itype, {7: 1}, {}, ji.gen(rng)), ("TREG", {8: 2}, {8: 1}, (b"x", 3)),
             (itype, {}, {7: 1}, ji.bottom())]
    for u in units:
        for v in units:
            assert tcompose.join_units(u, v) == jcompose.join_units(u, v)
    assert tcompose.pack_field(b"k" * 200, b"f") == jcompose.pack_field(b"k" * 200, b"f")


def test_bcount_escrow_matches_jax():
    """Random local operations and joins on the port's BCount and the JAX
    one: every verdict, right, value, canon and wire view equal."""
    rng = np.random.default_rng(5)
    rids = (1, 2, 3)
    pairs = {r: (jbcount.BCount(), tbcount.BCount()) for r in rids}
    for _ in range(600):
        r = int(pick(rng, rids))
        j, t = pairs[r]
        op = int(rng.integers(5))
        amount = int(pick(rng, [0, 1, 3, 10, 1 << 63, U64]))
        if op == 0:
            assert t.grant(r, amount) == j.grant(r, amount)
        elif op == 1:
            assert t.inc(r, amount) == j.inc(r, amount)
        elif op == 2:
            assert t.dec(r, amount) == j.dec(r, amount)
        elif op == 3:
            to, pol = int(pick(rng, rids)), str(pick(rng, ["INC", "DEC"]))
            assert t.transfer(r, to, amount, pol) == j.transfer(r, to, amount, pol)
        else:
            o = int(pick(rng, rids))
            j.converge(pairs[o][0])
            t.converge(tbcount.BCount.from_wire(pairs[o][1].to_wire()))
        for x in rids:
            assert (t.inc_rights(x), t.dec_rights(x)) == (j.inc_rights(x), j.dec_rights(x))
        assert (t.value(), t.bound(), t.canon(), t.to_wire()) == (
            j.value(), j.bound(), j.canon(), j.to_wire())
