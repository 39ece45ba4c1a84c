"""The frozen traffic against the port's own wire: the port's decoder
reads the frozen encoder's PNCOUNT and TREG frames back to exactly what
was sent, and a seed gives the same traffic twice."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from cardbench.traffic import gen, wire
from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.cluster.cluster import check_frame
from jylis_tpu_torch.cluster.framing import FrameReader
from jylis_tpu_torch.cluster.msg import MsgExchangeAddrs, MsgPong, MsgPushDeltas, MsgSyncDone
from jylis_tpu_torch.utils.address import Address

PKG = Path(__file__).resolve().parents[1]


def cell(config: str, traffic: str, keys: int) -> tuple[dict, dict]:
    cfg = json.loads((PKG / "configs" / f"{config}.json").read_text())
    cfg["keys"] = keys
    return cfg, json.loads((PKG / "traffic" / f"{traffic}.json").read_text())


def decoded(body: bytes, native: bool):
    """The port's read of one frozen frame: its framing, CRC and codec."""
    frames = FrameReader()
    frames.append(wire.wire_frame(body))
    (raw,) = list(frames)
    origin, payload = check_frame(raw)
    assert origin == 0
    return codec.decode(payload, native=native)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("j", [0, 3, 9])
def test_pncount_frames_decode_to_what_was_sent(native, j):
    cfg, traffic = cell("pncount-100k-r8", "sweep-read", 5000)
    s = gen.streams(cfg, traffic, 2**31 + 77)[2]
    msg = decoded(s.frame(j), native)
    keys = s.keys(j)
    p, n = s.deltas(j)
    want = tuple((s.key_table[k].tobytes(), ({s.rid: int(a)}, {s.rid: int(b)}))
                 for k, a, b in zip(keys, p, n))
    assert msg == MsgPushDeltas("PNCOUNT", want)
    assert len(want) == len(keys) and list(keys) == sorted(keys)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("j", [0, 5, 40])
def test_treg_frames_decode_to_what_was_sent(native, j):
    cfg, traffic = cell("treg-1m", "sweep", 20000)
    s = gen.streams(cfg, traffic, 123456789)[5]
    msg = decoded(s.frame(j), native)
    values, ts = s.deltas(j)
    want = tuple((s.key_table[k].tobytes(), (v.tobytes(), int(t)))
                 for k, v, t in zip(s.keys(j), values, ts))
    assert msg == MsgPushDeltas("TREG", want)
    assert all(t >= 1 << 63 for _, (_, t) in want)


def test_control_messages_decode():
    assert decoded(wire.pong(), True) == MsgPong()
    assert decoded(wire.sync_done(), True) == MsgSyncDone(())
    msg = decoded(wire.exchange_addrs([("127.0.0.1", 9, "b"), ("127.0.0.1", 7, "a")]), True)
    assert isinstance(msg, MsgExchangeAddrs)
    assert msg.known_addrs.adds == {Address("127.0.0.1", "9", "b"), Address("127.0.0.1", "7", "a")}
    assert not msg.known_addrs.removes


def test_handshake_matches_the_port():
    assert wire.SIGNATURE == codec.signature()
    hello = wire.hello("127.0.0.1", 4242, "p0", 3)
    assert codec.decode_hello(hello[32:]) == (Address("127.0.0.1", "4242", "p0"), "", 3)
    assert codec.decode_echo(wire.echo(9)[32:]) == ("", 9)


@pytest.mark.parametrize("config,traffic", [("pncount-100k-r8", "sweep-batch"), ("treg-1m", "sweep")])
def test_a_seed_gives_the_same_traffic_twice(config, traffic):
    cfg, tr = cell(config, traffic, 9000)
    a, b = (gen.streams(cfg, tr, 2**33 + 5) for _ in range(2))
    other = gen.streams(cfg, tr, 2**33 + 6)
    for r in (0, 7):
        frames = range(a[r].n_fill + 12)
        assert all(a[r].frame(j) == b[r].frame(j) for j in frames)
        assert any(a[r].frame(j) != other[r].frame(j) for j in frames)


def test_the_fill_and_every_cycle_cover_the_keyspace():
    for config, traffic in (("pncount-100k-r8", "sweep-read"), ("treg-1m", "sweep")):
        cfg, tr = cell(config, traffic, 9000)
        streams = gen.streams(cfg, tr, 5)
        fill = np.concatenate([s.keys(j) for s in streams for j in range(s.n_fill)])
        assert sorted(fill.tolist()) == list(range(9000))
        for s in streams:
            for cycle in range(2):
                first = s.n_fill + cycle * s.per_cycle
                keys = np.concatenate([s.keys(first + i) for i in range(s.per_cycle)])
                assert sorted(keys.tolist()) == list(range(9000))


def test_pncount_columns_rise_from_the_fill_on():
    cfg, tr = cell("pncount-100k-r8", "sweep-batch", 9000)
    s = gen.streams(cfg, tr, 5)[3]
    got = {}
    for j in range(s.n_fill + 3 * s.per_cycle):
        keys = s.keys(j)
        p, n = s.deltas(j, keys)
        for k, a, b in zip(keys.tolist(), p.tolist(), n.tolist()):
            if k in got:
                assert a > got[k][0] and b > got[k][1]
            got[k] = (a, b)
    assert len(got) == 9000
