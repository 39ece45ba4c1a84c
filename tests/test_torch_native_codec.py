"""The port's native wire codec against its oracle and the JAX package's codec.

At tolerance 0, all on the CPU (the codec is host code; only g++ is needed):

* Every golden-corpus message (tests/golden/codec_corpus.json) and every
  frame of its snapshot blob decodes and re-encodes to the same bytes on
  the native path and on the oracle path (``native=False``), and the
  PushDeltas kinds (plain, seq- and relay-prefixed) of the natively
  packed types really take the native path (``encode.native`` counts).
* Seeded random pushes of every natively packed type, with u64 values at
  2^63 and 2^64-1: native bytes == oracle bytes == the JAX package's
  ``cluster.codec.encode`` bytes, and each package decodes the other's
  bytes to equal batches.
* The flush and dump batches of all eight types and SYSTEM from a port
  node with the native engine, fed the digest tests' seeded stream: the
  same three-way byte equality and cross-decoding.
* Mutated bytes: wherever the native decoder accepts, the oracle gives the
  same message; where the oracle raises, the public decode raises.
* UJSON's wire path: the native splitter's lazy deltas equal the oracle's
  documents, and the resident store folds them from their wire bytes to
  the documents the object encoder gives.
"""

import asyncio
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from jylis_tpu.cluster import codec as jax_codec
from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.cluster.framing import FrameReader
from jylis_tpu_torch.cluster.msg import MsgPushDeltas, MsgRelayPush, MsgSeqPush
from jylis_tpu_torch.models import repo_system
from jylis_tpu_torch.models.database import Database
from jylis_tpu_torch.native import codec as ncodec
from jylis_tpu_torch.ops.ujson_host import UJSON
from jylis_tpu_torch.ops.ujson_resident import ResidentStore
from jylis_tpu_torch.ops.ujson_wire import WireUJSON

from test_torch_system_digest import IDENTITY, U64, feed, round_one, round_two

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

CORPUS = json.loads(
    (Path(__file__).resolve().parent / "golden" / "codec_corpus.json").read_text()
)
MESSAGES = sorted(n for n in CORPUS["entries"] if n.startswith(("msg/", "delta/")))
# the types the native codec packs; TENSOR, MAP and BCOUNT take the oracle
NATIVE_TYPES = ("GCOUNT", "PNCOUNT", "TREG", "TLOG", "SYSTEM", "UJSON")
TYPES = ("TREG", "TLOG", "GCOUNT", "PNCOUNT", "UJSON", "TENSOR", "MAP", "BCOUNT", "SYSTEM")
EDGES = (0, 1, 127, 128, 1 << 63, U64)


def counts() -> dict:
    return {"enc": dict(codec.encode.native), "dec": dict(codec.decode.native)}


def native_delta(before: dict, kind: str) -> tuple[int, int]:
    """(natively encoded, natively decoded) messages of ``kind`` since
    ``before`` was taken."""
    now = counts()
    return (now["enc"].get(kind, 0) - before["enc"].get(kind, 0),
            now["dec"].get(kind, 0) - before["dec"].get(kind, 0))


def check_three_ways(msg, body: bytes | None = None) -> bytes:
    """Native bytes == oracle bytes (== ``body`` when given) == JAX's
    encode of JAX's decode; the port decodes its own and JAX's bytes to
    equal messages on both paths. Returns the bytes."""
    fast = codec.encode(msg)
    assert fast == codec.encode(msg, native=False)
    if body is not None:
        assert fast == body
    jmsg = jax_codec.decode(fast)
    jbody = jax_codec.encode(jmsg)
    assert jbody == fast
    assert jax_codec._encode_oracle(jmsg) == fast
    back = codec.decode(jbody)
    assert back == codec.decode(jbody, native=False)
    assert codec.encode(back) == fast
    return fast


@pytest.mark.parametrize("name", MESSAGES)
def test_corpus_messages_native_equal_oracle(name):
    body = bytes.fromhex(CORPUS["entries"][name]["hex"])
    before = counts()
    msg = codec.decode(body)
    assert msg == codec.decode(body, native=False)
    check_three_ways(msg, body)
    kind = type(msg).__name__[3:]
    pushed = kind in ("PushDeltas", "SeqPush", "RelayPush")
    enc, dec = native_delta(before, kind)
    if pushed and msg.name in NATIVE_TYPES:
        assert enc >= 2 and dec >= 2, (enc, dec)  # both packages' bytes
    else:
        assert enc == dec == 0


def test_corpus_covers_every_native_kind():
    kinds = {(type(m).__name__, getattr(m, "name", None))
             for m in (codec.decode(bytes.fromhex(CORPUS["entries"][n]["hex"]))
                       for n in MESSAGES)}
    for t in NATIVE_TYPES:
        assert ("MsgPushDeltas", t) in kinds
    assert {k for k, _ in kinds} >= {"MsgSeqPush", "MsgRelayPush"}


def test_corpus_snapshot_frames_native_equal_oracle():
    blob = bytes.fromhex(CORPUS["entries"]["file/snapshot"]["hex"])
    frames = FrameReader(max_frame=1 << 62)
    frames.append(blob[40:])
    names = []
    for body in frames:
        msg = codec.decode(body)
        check_three_ways(msg, body)
        names.append(msg.name)
    assert sorted(names) == sorted(TYPES)


# ---- seeded random pushes ----------------------------------------------------


def _u64(rng: random.Random) -> int:
    return rng.choice([*EDGES, rng.randrange(1 << 21), rng.randrange(1 << 49),
                       rng.randrange(1 << 64)])


def _bytes(rng: random.Random) -> bytes:
    return bytes(rng.randrange(256) for _ in range(rng.choice([0, 1, 3, 17, 200])))


def _str(rng: random.Random) -> str:
    return rng.choice(["", "a", "profile", "über", "名前", "x" * 40])


def _ujson(rng: random.Random) -> UJSON:
    u = UJSON()
    for _ in range(rng.randrange(4)):
        dot = (rng.randrange(1 << 63), _u64(rng))
        u.entries[dot] = (tuple(_str(rng) for _ in range(rng.randrange(3))), _str(rng))
    for _ in range(rng.randrange(3)):
        u.ctx.vv[_u64(rng)] = _u64(rng)
    for _ in range(rng.randrange(3)):
        u.ctx.cloud.add((_u64(rng), _u64(rng)))
    return u


def _push(rng: random.Random, name: str) -> MsgPushDeltas:
    batch = []
    for _ in range(rng.randrange(6)):
        if name == "GCOUNT":
            delta = {_u64(rng): _u64(rng) for _ in range(rng.randrange(6))}
        elif name == "PNCOUNT":
            delta = tuple({_u64(rng): _u64(rng) for _ in range(rng.randrange(6))}
                          for _ in range(2))
        elif name == "TREG":
            delta = (_bytes(rng), _u64(rng))
        elif name == "UJSON":
            delta = _ujson(rng)
        else:  # TLOG / SYSTEM
            delta = ([(_bytes(rng), _u64(rng)) for _ in range(rng.randrange(4))], _u64(rng))
        batch.append((_bytes(rng), delta))
    return MsgPushDeltas(name, tuple(batch))


@pytest.mark.parametrize("name", NATIVE_TYPES)
def test_random_pushes_native_equal_oracle_and_jax(name):
    rng = random.Random(f"push-{name}")
    before = counts()
    for i in range(60):
        msg = _push(rng, name)
        assert ncodec.encode_push(msg) is not None, "the native encoder declined"
        assert codec.decode(check_three_ways(msg)) == msg
        seq = MsgSeqPush(_u64(rng), _u64(rng), name, msg.batch, _bytes(rng))
        assert codec.decode(check_three_ways(seq)) == seq
        relay = MsgRelayPush(_u64(rng), "127.0.0.1:7%03d:n" % i, _u64(rng), name,
                             msg.batch, b"")
        assert codec.decode(check_three_ways(relay)) == relay
    for kind in ("PushDeltas", "SeqPush", "RelayPush"):
        enc, dec = native_delta(before, kind)
        assert enc >= 120 and dec >= 120, (kind, enc, dec)


def test_u64_edges_decode_as_python_ints():
    """2^63 and 2^64-1 as counts, replica ids, timestamps, cutoffs and
    seqs: the JAX bytes both ways, and Python ints in [0, 2^64) out."""
    big, top = 1 << 63, U64
    msgs = [
        MsgPushDeltas("GCOUNT", ((b"g", {big: top, top: big, 1: 0}),)),
        MsgPushDeltas("PNCOUNT", ((b"p", ({top: big}, {big: top})),)),
        MsgPushDeltas("TREG", ((b"r", (b"v", top)), (b"s", (b"w", big)))),
        MsgPushDeltas("TLOG", ((b"l", ([(b"a", top), (b"b", big)], big)),)),
        MsgPushDeltas("SYSTEM", ((b"log", ([(b"x", big)], top)),)),
    ]
    for msg in msgs:
        body = check_three_ways(msg)
        got = codec.decode(body)
        assert got == msg
        flat = json.dumps(repr(got.batch))
        assert str(top) in flat and str(big) in flat
    g = codec.decode(codec.encode(msgs[0])).batch[0][1]
    assert all(type(v) is int for v in (*g.keys(), *g.values()))
    assert dict(g.items()) == {big: top, top: big, 1: 0}


def test_values_outside_u64_take_the_oracle():
    before = counts()
    msg = MsgPushDeltas("GCOUNT", ((b"k", {3: 1 << 64}),))
    assert ncodec.encode_push(msg) is None
    body = codec.encode(msg)  # the oracle writes the varint as given
    assert ncodec.decode_push(body) is None  # a 65-bit varint: declined
    assert codec.decode(body) == msg
    assert native_delta(before, "PushDeltas") == (0, 0)
    with pytest.raises(codec.CodecError):
        codec.encode(MsgPushDeltas("TREG", ((b"r", (b"v", -1)),)))


def test_mutated_bytes_never_diverge():
    rng = random.Random("mutate")
    accepted = 0
    for _ in range(300):
        name = rng.choice(NATIVE_TYPES)
        body = bytearray(codec.encode(_push(rng, name), native=False))
        for _ in range(rng.randrange(1, 4)):
            body[rng.randrange(1, len(body))] = rng.randrange(256)
        body = bytes(body)
        try:
            expect = codec.decode(body, native=False)
            raised = False
        except codec.CodecError:
            raised = True
        fast = ncodec.decode_push(body)
        if fast is not None:
            accepted += 1
            assert not raised, "native accepted bytes the oracle refuses"
            assert fast == expect
        if raised:
            with pytest.raises(codec.CodecError):
                codec.decode(body)
    assert accepted > 30


# ---- a port node's flush and dump batches --------------------------------------


@pytest.fixture(scope="module")
def node_batches():
    """A port node with the native engine, fed the digest tests' seeded
    stream in two rounds: each type's flushed batch and sync dump after
    each round, and the native codec counts they added."""
    rng = np.random.default_rng(8)
    db = Database(IDENTITY, device="cpu")
    assert db.native_engine is not None
    clock = iter(range(1 << 63, (1 << 63) + 100))
    out = {"flush": [], "dump": []}
    for steps in (round_one(rng), round_two(rng)):
        feed(db, steps, False, bytearray(), {})
        orig = repo_system._now_millis
        repo_system._now_millis = lambda ts=next(clock): ts  # a u64 log line ts
        try:
            db.system.inslog("node started")
        finally:
            repo_system._now_millis = orig
        got = []
        db.flush_deltas(lambda nb: got.append((nb[0], tuple(nb[1]))))
        for mgr in db.managers():
            mgr._deltas_fn = None  # no proactive flush in the next round
        out["flush"].append(dict(got))
        out["dump"].append(dict(asyncio.run(db.dump_state_async())))
    assert db.serving_totals()["native_cmds"] == 0  # direct applies: Python path
    return out


@pytest.mark.parametrize("what", ["flush", "dump"])
@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("name", TYPES)
def test_node_batches_native_equal_oracle_and_jax(node_batches, name, rnd, what):
    batch = tuple(node_batches[what][rnd].get(name, ()))
    before = counts()
    body = check_three_ways(MsgPushDeltas(name, batch))
    if rnd == 0 or what == "dump":
        assert batch, (name, what)
    enc, dec = native_delta(before, "PushDeltas")
    assert (enc > 0 and dec > 0) == (name in NATIVE_TYPES), (enc, dec)
    check_three_ways(MsgSeqPush(U64, 1 << 63, name, batch, body[:5]))


def test_node_dumps_hold_u64_values(node_batches):
    dump = node_batches["dump"][0]
    u64_max = b"\xff" * 9 + b"\x01"  # LEB128 of 2^64-1
    for name in ("GCOUNT", "PNCOUNT"):
        assert u64_max in codec.encode(MsgPushDeltas(name, dump[name]))
    assert b"\x80" * 9 + b"\x01" in codec.encode(MsgPushDeltas("SYSTEM", dump["SYSTEM"]))


# ---- UJSON: the lazy wire deltas and the grid from wire bytes --------------------


def _docs(rng: random.Random, n: int, writers: int) -> list[UJSON]:
    """n deltas from ``writers`` replica documents making set_doc and ins
    edits (seqs small enough for the narrow layout)."""
    docs = [UJSON() for _ in range(writers)]
    out = []
    for i in range(n):
        w = rng.randrange(writers)
        d = UJSON()
        if rng.random() < 0.5:
            docs[w].set_doc(w + 1, (f"f{rng.randrange(5)}",), str(rng.randrange(9)), d)
        else:
            docs[w].ins(w + 1, ("tags",), f'"t{rng.randrange(7)}"', d)
        out.append(d)
    return out


def _wire(deltas: list[UJSON]) -> list[WireUJSON]:
    batch = tuple((b"k%d" % i, d) for i, d in enumerate(deltas))
    msg = codec.decode(codec.encode(MsgPushDeltas("UJSON", batch)))
    got = [d for _, d in msg.batch]
    assert all(type(d) is WireUJSON for d in got)
    return got


def test_split_push_ujson_gives_the_oracle_documents():
    rng = random.Random("split")
    deltas = _docs(rng, 40, 3) + [_ujson(rng) for _ in range(40)]
    wire = _wire(deltas)
    assert [(d.n_entries, d.n_cloud) for d in wire] == [
        (len(d.entries), len(d.ctx.cloud)) for d in deltas
    ]
    assert wire == deltas  # materialised on comparison


@pytest.mark.parametrize("shape", ["subset", "broadcast"])
def test_resident_fold_from_wire_equals_object_fold(shape):
    """Two stores hold the same documents; one folds plain deltas (the
    object encoder), the other the same deltas as wire objects (the grid
    from wire bytes, with replica columns past the store's first vv
    width): every document reads back equal."""
    rng = random.Random(f"grid-{shape}")
    base = _docs(rng, 24, 3)
    docs = {}
    for i, d in enumerate(base):
        docs.setdefault(b"d%d" % (i % 4), UJSON()).converge(d)
    stores = [ResidentStore(n_rep=4, device="cpu") for _ in range(2)]
    for st in stores:
        st.admit([(k, _copy(v)) for k, v in docs.items()])
    deltas = _docs(random.Random("grid-more"), 48, 9)
    wire = _wire(deltas)
    if shape == "subset":
        keys = sorted(docs)
        stores[0].fold_in({k: deltas[i::4] for i, k in enumerate(keys)})
        stores[1].fold_in({k: wire[i::4] for i, k in enumerate(keys)})
    else:
        stores[0].fold_in_broadcast(deltas)
        stores[1].fold_in_broadcast(wire)
    keys = sorted(docs)
    got = [st.read_many(keys) for st in stores]
    assert got[0] == got[1]
    assert stores[1]._pay_wire  # payloads interned by their wire bytes
    assert len(stores[1]._rid_cols) == 9


def _copy(doc: UJSON) -> UJSON:
    out = UJSON()
    out.converge(doc)
    return out
