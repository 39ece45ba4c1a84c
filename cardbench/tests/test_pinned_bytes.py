"""The bytes the peers send are pinned: the fill frames and the first
sweep frames of every peer stream of the CPU tests' cells (cells.py), at
two seeds, hash to what the harness sent before the data types moved
into modules of their own (types/); and each type's ``push``, built on
``wire.push``, gives the bytes of a plain entry-by-entry encoding of the
schema's grammar, at the edges of the u64 range."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from cardbench import types
from cardbench.tests.cells import small_cell
from cardbench.traffic import gen, wire

SWEEP_FRAMES = 4
FRAMES = {
    ("pn100k-r8.sweep-read", 7):
        "18d3e88d651f9b1915554c69012ef677ed4497325ca7b66ba1294727ce889948",
    ("pn100k-r8.sweep-read", 2**33 + 1):
        "533928cf6de0a3482dcfecf3525db48658f1442cfbbf17d17d7eb7647f0f8d7e",
    ("pn100k-r8.sweep-batch", 7):
        "18d3e88d651f9b1915554c69012ef677ed4497325ca7b66ba1294727ce889948",
    ("pn100k-r8.sweep-batch", 2**33 + 1):
        "533928cf6de0a3482dcfecf3525db48658f1442cfbbf17d17d7eb7647f0f8d7e",
    ("treg1m.sweep", 7):
        "ee1c33d64305d6e5dd89fa82dd41e46eb6ca0598dbe43cb02f9d03e4bddc08a1",
    ("treg1m.sweep", 2**33 + 1):
        "21b95cf37992981d43c463f688cf86716bf0fabf0c0af356757eda34086c2e64",
}


@pytest.mark.parametrize("name,seed", sorted(FRAMES))
def test_the_fill_and_first_sweep_frames_keep_their_bytes(name, seed):
    cell = small_cell(name)
    h = hashlib.sha256()
    for s in gen.streams(cell["config"], cell["traffic"], seed):
        for j in range(s.n_fill + SWEEP_FRAMES):
            h.update(s.frame(j))
    assert h.hexdigest() == FRAMES[(name, seed)]


PNCOUNT = types.load("PNCOUNT")
TREG = types.load("TREG")
KEYS = gen.key_bytes("pn%06d", 6)
TOP = (1 << 64) - 1


def pn_cases():
    g = np.random.default_rng(5)
    return {
        "rid 0": (0, np.full(6, 1 << 63, np.uint64), np.full(6, 1 << 63, np.uint64), 10, 10),
        "2^64-1, 2^63": (TOP, np.full(6, TOP, np.uint64), np.full(6, 1 << 63, np.uint64), 10, 10),
        "seeded": (12345, g.integers(1 << 63, TOP, 6, dtype=np.uint64, endpoint=True),
                   g.integers(1 << 56, 1 << 63, 6, dtype=np.uint64), 10, 9),
    }


VALUES = np.frombuffer(b"".join(b"abcdefgh%08d" % i for i in range(6)), np.uint8).reshape(6, 16)
TREG_CASES = {
    "2^63, 2^64-1": (np.array([1 << 63, TOP, 1 << 63, 2**63 + 5, 2**63 + 5, TOP], np.uint64), 10),
    "one-byte ts": (np.array([1, 2, 127, 5, 5, 64], np.uint64), 1),
}
# sha256 of the bodies the harness's encoders gave for these inputs
# before they moved into the type modules
PINNED = {
    "rid 0": "3e728fd546f743d72b68598803931aec5d28bc6af87b5c9d358d55b208252961",
    "2^64-1, 2^63": "b3d752084536a55ac99b942b36396bc85bdfefcf2769ae94fec4773d3c740c90",
    "seeded": "c25ac940e3bdd8a85ce2e3210dc13e6d28304de4d60c8e554817269a4a079919",
    "2^63, 2^64-1": "df6211c66c9959ff66f3d222d910f4bfafa25010f83e7a8fd3562cf7803936ca",
    "one-byte ts": "5e78f36461a89037bd3770d71a16da0d75580ca80f27f2caedb685e8fec01446",
}


def plain_body(name: str, entries: list[bytes]) -> bytes:
    """``msg3=PushDeltas(name:str batch:[(key:bytes delta)])``, one entry
    at a time."""
    head = bytes([wire.TAG_PUSH]) + wire.str_bytes(name) + wire.varint(len(entries))
    return head + b"".join(entries)


@pytest.mark.parametrize("case", sorted(pn_cases()))
def test_pncount_push_is_the_plain_encoding(case):
    rid, p, n, pw, nw = pn_cases()[case]
    body = PNCOUNT.push(KEYS, rid, p, n, pw, nw)
    # delta/PNCOUNT=(gcount gcount), delta/GCOUNT=[(rid:varint v:varint)]
    want = plain_body("PNCOUNT", [
        wire.str_bytes(k.tobytes()) + wire.varint(1) + wire.varint(rid) + wire.varint(int(a))
        + wire.varint(1) + wire.varint(rid) + wire.varint(int(b))
        for k, a, b in zip(KEYS, p, n)])
    assert body == want
    assert hashlib.sha256(body).hexdigest() == PINNED[case]


@pytest.mark.parametrize("case", sorted(TREG_CASES))
def test_treg_push_is_the_plain_encoding(case):
    ts, width = TREG_CASES[case]
    body = TREG.push(KEYS, VALUES, ts, width)
    # delta/TREG=(value:bytes ts:varint)
    want = plain_body("TREG", [wire.str_bytes(k.tobytes()) + wire.str_bytes(v.tobytes())
                               + wire.varint(int(t)) for k, v, t in zip(KEYS, VALUES, ts)])
    assert body == want
    assert hashlib.sha256(body).hexdigest() == PINNED[case]


def test_the_streams_frames_are_the_plain_encoding():
    """Seeded frames of both streams, TREG's values on their shared
    prefixes, past the fill."""
    cell = small_cell("treg1m.sweep")
    s = gen.streams(cell["config"], cell["traffic"], 2**31 + 9)[3]
    j = s.n_fill + 1
    keys = s.keys(j)
    values, ts = s.deltas(j, keys)
    assert len({v[:8].tobytes() for v in values}) <= cell["config"]["values"]["value_prefixes"]
    assert s.frame(j) == plain_body("TREG", [
        wire.str_bytes(s.key_table[k].tobytes()) + wire.str_bytes(v.tobytes())
        + wire.varint(int(t)) for k, v, t in zip(keys, values, ts)])
    cell = small_cell("pn100k-r8.sweep-read")
    s = gen.streams(cell["config"], cell["traffic"], 2**31 + 9)[5]
    j = s.n_fill + 1
    keys = s.keys(j)
    p, n = s.deltas(j, keys)
    col = wire.varint(1) + wire.varint(s.rid)
    assert s.frame(j) == plain_body("PNCOUNT", [
        wire.str_bytes(s.key_table[k].tobytes()) + col + wire.varint(int(a)) + col
        + wire.varint(int(b)) for k, a, b in zip(keys, p, n)])


def test_a_zero_column_takes_no_fixed_width():
    """0 has no fixed-width varint of its own; the encoder refuses it as
    it did before, and varint() writes it as one byte."""
    assert wire.varint(0) == b"\x00"
    with pytest.raises(wire.WireError):
        PNCOUNT.push(KEYS, 1, np.zeros(6, np.uint64), np.full(6, 1 << 63, np.uint64), 1, 10)
