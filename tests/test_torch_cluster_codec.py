"""The port's cluster codec and framing against the JAX package's, byte for byte.

Three parts, all at tolerance 0:

* The golden corpus (tests/golden/codec_corpus.json): every ``msg/*`` and
  ``delta/*`` entry decodes with the port's codec and re-encodes to the
  same bytes; ``frame/wire`` passes the port's framing and CRC check;
  the snapshot blob's frames decode and re-encode too. No JAX is needed
  for this part.
* The handshake's ``signature()`` and ``delta_signature()`` equal JAX's.
* One seeded command stream (test_torch_system_digest.py's rounds, with
  counter values and timestamps at and above 2^63) goes into a JAX
  ``Database(engine="python")`` and a port ``Database(device="cpu")``.
  Each type's ``flush_deltas`` batch, encoded as ``MsgPushDeltas`` by its
  own package's codec, gives equal bytes for all eight types and SYSTEM,
  and so does each type's sync dump (``dump_state_async``) and range
  dump (``dump_range_async``) for a few digest-tree bucket sets.
"""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from jylis_tpu.cluster import codec as jax_codec
from jylis_tpu.cluster.msg import MsgPushDeltas as JaxMsgPushDeltas
from jylis_tpu.models import repo_system as jax_repo_system
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.cluster.cluster import check_frame, wire_frame
from jylis_tpu_torch.cluster.framing import HEADER_SIZE, FrameReader, parse_header
from jylis_tpu_torch.cluster.msg import MsgPong, MsgPushDeltas, MsgSeqPush
from jylis_tpu_torch.models import repo_system
from jylis_tpu_torch.models.database import Database

from test_torch_system_digest import IDENTITY, U64, feed, round_one, round_two

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

CORPUS = json.loads(
    (Path(__file__).resolve().parent / "golden" / "codec_corpus.json").read_text()
)
MESSAGES = sorted(n for n in CORPUS["entries"] if n.startswith(("msg/", "delta/")))
TYPES = ("TREG", "TLOG", "GCOUNT", "PNCOUNT", "UJSON", "TENSOR", "MAP", "BCOUNT", "SYSTEM")
# digest-tree bucket sets a range sync may ask for: a few, a stride, all
BUCKET_SETS = ((3, 100, 200), tuple(range(0, 256, 7)), tuple(range(256)))


@pytest.mark.parametrize("name", MESSAGES)
def test_corpus_message_round_trips(name):
    body = bytes.fromhex(CORPUS["entries"][name]["hex"])
    msg = codec.decode(body)
    assert codec.encode(msg) == body
    assert type(msg).__name__ == type(jax_codec.decode(body)).__name__


def test_corpus_covers_every_message_and_delta_kind():
    kinds = {n.split("/")[1] for n in MESSAGES}
    assert set(TYPES) <= kinds
    assert {"Pong", "SyncRequest", "SyncDone", "SeqPush", "DigestTree", "RangeRequest",
            "RelayPush", "RegionGossip", "IntervalReset", "DeltaAck", "ExchangeAddrs",
            "AnnounceAddrs"} <= kinds


def test_corpus_wire_frame_validates_and_carries_origin():
    e = CORPUS["entries"]["frame/wire"]
    raw = bytes.fromhex(e["hex"])
    body = raw[HEADER_SIZE:]
    assert parse_header(raw[:HEADER_SIZE]) == len(body)
    origin, payload = check_frame(body)
    assert origin == e["origin_ms"]
    assert isinstance(codec.decode(payload), MsgPong)
    assert wire_frame(payload, origin_ms=origin) == raw
    for i in range(len(body)):  # any single flipped byte is refused
        flipped = bytearray(body)
        flipped[i] ^= 0x40
        assert check_frame(bytes(flipped)) is None


def test_corpus_snapshot_frames_round_trip():
    blob = bytes.fromhex(CORPUS["entries"]["file/snapshot"]["hex"])
    assert blob[8:40] == codec.delta_signature()
    frames = FrameReader(max_frame=1 << 62)
    frames.append(blob[40:])
    names = []
    for body in frames:
        msg = codec.decode(body)
        assert isinstance(msg, MsgPushDeltas) and codec.encode(msg) == body
        names.append(msg.name)
    assert sorted(names) == sorted(TYPES)


def test_signatures_equal_jax():
    assert codec.signature() == jax_codec.signature()
    assert codec.delta_signature() == jax_codec.delta_signature()
    assert codec.delta_signature().hex() == CORPUS["delta_signature"]


def test_u64_varints_and_seq_prefix():
    """Counts and timestamps at 2^63 and at 2^64-1 take the JAX bytes; a
    negative value (an int64 bit pattern left unconverted) is refused."""
    batch = ((b"k", {1: 1 << 63, U64: U64}),)
    for msg, jmsg in ((MsgPushDeltas("GCOUNT", batch), JaxMsgPushDeltas("GCOUNT", batch)),):
        assert codec.encode(msg) == jax_codec.encode(jmsg)
    seq = MsgSeqPush(U64, 1 << 63, "TREG", ((b"r", (b"v", U64)),), b"")
    body = codec.encode(seq)
    assert codec.decode(body) == seq
    assert jax_codec.encode(jax_codec.decode(body)) == body
    with pytest.raises(codec.CodecError):
        codec.encode(MsgPushDeltas("TREG", ((b"r", (b"v", -1)),)))


@pytest.fixture(scope="module")
def flushed():
    """Each package's flushed batches and dumps, encoded by its own codec,
    after round one and again after round two."""
    rng = np.random.default_rng(8)
    rounds = [round_one(rng), round_two(rng)]
    dbs = {"jax": JaxDatabase(identity=IDENTITY, engine="python"),
           "port": Database(IDENTITY, device="cpu")}
    writers = {n: {} for n in dbs}
    out = {n: {"flush": [], "dump": [], "range": []} for n in dbs}
    clock = iter(range(1 << 63, (1 << 63) + 100))
    for steps in rounds:
        ts = next(clock)
        for name, db in dbs.items():
            jax_side = name == "jax"
            feed(db, steps, jax_side, bytearray(), writers[name])
            mod = jax_repo_system if jax_side else repo_system
            orig = mod._now_millis
            mod._now_millis = lambda ts=ts: ts  # one SYSTEM log line at a u64 ts
            try:
                db.system.inslog("node started")
            finally:
                mod._now_millis = orig
            cod = jax_codec if jax_side else codec
            msg = JaxMsgPushDeltas if jax_side else MsgPushDeltas
            got = []
            db.flush_deltas(lambda nb: got.append((nb[0], cod.encode(msg(nb[0], tuple(nb[1]))),
                                                   cod.batch_has_content(*nb))))
            for mgr in db.managers():
                mgr._deltas_fn = None  # no proactive flush in the next round
            out[name]["flush"].append(got)
            dumps = asyncio.run(db.dump_state_async())
            out[name]["dump"].append({n: cod.encode(msg(n, tuple(b))) for n, b in dumps})
            out[name]["range"].append({
                (n, i): cod.encode(msg(n, tuple(asyncio.run(db.dump_range_async(n, bs)))))
                for n in TYPES[:-1] for i, bs in enumerate(BUCKET_SETS)})
    return out


@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("name", TYPES)
def test_flushed_batches_encode_as_jax(flushed, name, rnd):
    want = [x for x in flushed["jax"]["flush"][rnd] if x[0] == name]
    got = [x for x in flushed["port"]["flush"][rnd] if x[0] == name]
    assert got == want
    if rnd == 0:
        assert want and want[0][2] and len(want[0][1]) > 20, name


def test_flush_order_is_jax(flushed):
    for rnd in (0, 1):
        assert ([n for n, _, _ in flushed["port"]["flush"][rnd]]
                == [n for n, _, _ in flushed["jax"]["flush"][rnd]])


@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("name", TYPES)
def test_sync_dumps_encode_as_jax(flushed, name, rnd):
    want = flushed["jax"]["dump"][rnd][name]
    assert flushed["port"]["dump"][rnd][name] == want
    assert len(want) > 20


@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("name", TYPES[:-1])
def test_range_dumps_encode_as_jax(flushed, name, rnd):
    """``dump_range_async`` for a few bucket sets: the port reads only
    the wanted keys' rows (``dump_keys`` on the counters, TREG and TLOG)
    where JAX filters its whole dump; the frames are equal, and the full
    bucket set gives the whole dump's frame."""
    got, want = flushed["port"]["range"][rnd], flushed["jax"]["range"][rnd]
    for i in range(len(BUCKET_SETS)):
        assert got[name, i] == want[name, i], BUCKET_SETS[i][:3]
    assert got[name, 2] == flushed["port"]["dump"][rnd][name]
    assert len(got[name, 0]) <= len(got[name, 1]) <= len(got[name, 2])
    if name in ("TREG", "TLOG", "GCOUNT", "PNCOUNT"):  # the keyed dumps
        assert len(got[name, 0]) < len(got[name, 1]) < len(got[name, 2])


def test_stream_holds_u64_values(flushed):
    """The dumps carry counts and timestamps at and above 2^63."""
    dumps = flushed["port"]["dump"][0]
    u64_max = b"\xff" * 9 + b"\x01"  # LEB128 of 2^64-1
    assert u64_max in dumps["GCOUNT"] and u64_max in dumps["PNCOUNT"]
    assert b"\x81" + b"\x80" * 8 + b"\x01" in dumps["TREG"]  # 2^63+1
    assert b"\x80" * 9 + b"\x01" in dumps["SYSTEM"]  # 2^63
