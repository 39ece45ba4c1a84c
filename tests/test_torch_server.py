"""The port's RESP server against the JAX package's database, byte for byte.

A RESP script (array and inline commands, pipelined, with parse
failures, unknown data types and anti-entropy deltas between bursts)
goes over a real socket into the port's Server (state on the CPU), and
command by command into a JAX ``Database(identity, engine="python")``
through the JAX package's real ``Respond`` writer. The two reply streams
must be equal. A separate test runs ``python -m jylis_tpu_torch`` as a
real process, another two of them as a cluster, and another serves
TREG, TENSOR, TLOG and UJSON in a process where ``import jax`` fails.
"""

import asyncio
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from jylis_tpu.cluster import codec as jax_codec
from jylis_tpu.models.database import DATA_TYPE_NAMES as JAX_DATA_TYPE_NAMES
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.ops.tensor_host import Tensor as JaxTensor
from jylis_tpu.ops.ujson_host import UJSON as JaxUJSON
from jylis_tpu.server.resp import Respond as JaxRespond
from jylis_tpu.server.resp import RespParser as JaxRespParser
from jylis_tpu.utils.address import Address as JaxAddress
from jylis_tpu_torch.cluster import codec
from jylis_tpu_torch.models.database import SERVED_TYPES, Database
from jylis_tpu_torch.ops.ujson_host import UJSON
from jylis_tpu_torch.server.server import Server
from jylis_tpu_torch.utils.config import Config, config_from_cli

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

IDENTITY = 0xABCDEF
BIG = (1 << 64) - 1


def arr(*parts) -> bytes:
    out = b"*%d\r\n" % len(parts)
    for p in parts:
        p = p if isinstance(p, bytes) else str(p).encode()
        out += b"$%d\r\n%s\r\n" % (len(p), p)
    return out


def vec(*xs) -> bytes:
    return np.asarray(xs, "<f4").tobytes()


def tensor_blob(mode, dim, val=b"", ts=b"", rid=b"", contribs=None) -> bytes:
    """A delta/TENSOR payload, encoded by the JAX codec."""
    t = JaxTensor.from_wire(mode, dim, val, ts, rid, contribs or {})
    return jax_codec.encode_delta("TENSOR", t)


LWW_T = tensor_blob(2, 3, vec(9, 9, 9), np.array([7, 8, 6], "<u8").tobytes(),
                    np.array([1, 1, 0xFFFFFFFF], "<u4").tobytes())
NAN = b"\x01\x00\xc0\x7f"  # a non-canonical NaN

# bursts of raw client bytes; a delta batch is converged between bursts
BURSTS = [
    arr("GCOUNT", "INC", "a", 5) + arr("GCOUNT", "GET", "a")
    + b"PNCOUNT INC p 10\r\nPNCOUNT DEC p 25\r\n" + arr("PNCOUNT", "GET", "p")
    + arr("TREG", "SET", "r", "hello", 5) + arr("TREG", "GET", "r")
    + arr("TREG", "GET", "nope") + arr("TENSOR", "SET", "t", "LWW", 7, vec(1, 2, 3))
    + arr("TENSOR", "GET", "t") + arr("TENSOR", "SET", "m", "MAX", 0, vec(-0.0, 1) + NAN)
    + arr("TENSOR", "SET", "v", "AVG", 4, vec(2, 4))
    + arr("TLOG", "INS", "l", "x", 5) + arr("TLOG", "INS", "l", "y", 5)
    + arr("TLOG", "INS", "l", "x", 5) + arr("TLOG", "INS", "l", "z", 9)
    + arr("TLOG", "GET", "l") + arr("TLOG", "SIZE", "l")
    + arr("TLOG", "GET", "nope")
    + arr("UJSON", "SET", "u", "a", '{"x": 1, "y": [1, 2]}') + arr("UJSON", "GET", "u")
    + arr("UJSON", "INS", "u", "tags", '"t1"') + arr("UJSON", "INS", "u", "tags", 5)
    + arr("UJSON", "GET", "u", "tags") + arr("UJSON", "GET", "u", "a", "y")
    + arr("UJSON", "RM", "u", "tags", 5) + arr("UJSON", "GET", "u")
    + arr("UJSON", "GET", "nope") + arr("UJSON", "CLR", "nope"),
    arr("GCOUNT", "GET", "a") + arr("GCOUNT", "GET", "zz")
    + arr("PNCOUNT", "GET", "p") + arr("GCOUNT", "INC", "a", BIG)
    + arr("GCOUNT", "GET", "a")
    + arr("TREG", "GET", "r") + arr("TREG", "GET", "r2")
    + arr("TREG", "SET", "r", "hellp", 5) + arr("TREG", "GET", "r")
    + arr("TENSOR", "GET", "t") + arr("TENSOR", "MRG", "t", LWW_T)
    + arr("TENSOR", "GET", "t") + arr("TENSOR", "GET", "m")
    + arr("TENSOR", "GET", "v") + arr("TENSOR", "SET", "t", "MAX", 1, vec(1, 2, 3))
    + arr("TENSOR", "SET", "t", "LWW", 1, vec(1, 2))
    + arr("TENSOR", "SET", "t", "LWW", 1, b"abc")
    + arr("TENSOR", "MRG", "t", LWW_T + b"\x00")
    + arr("TENSOR", "MRG", "t", tensor_blob(0, 0))
    + arr("TLOG", "GET", "l") + arr("TLOG", "GET", "l", 2)
    + arr("TLOG", "CUTOFF", "l") + arr("TLOG", "TRIM", "l", 2)
    + arr("TLOG", "GET", "l") + arr("TLOG", "INS", "l", "w", BIG)
    + arr("TLOG", "TRIMAT", "l2", 3) + arr("TLOG", "GET", "l2")
    + arr("TLOG", "SIZE", "l2") + arr("TLOG", "CLR", "l")
    + arr("TLOG", "GET", "l") + arr("TLOG", "CUTOFF", "l")
    + arr("UJSON", "GET", "u") + arr("UJSON", "GET", "u2")
    + arr("UJSON", "SET", "u2", "b", "true") + arr("UJSON", "GET", "u2")
    + arr("UJSON", "CLR", "u", "a") + arr("UJSON", "GET", "u")
    + arr("UJSON", "INS", "u2", "tags", "null") + arr("UJSON", "GET", "u2", "tags")
    + arr("UJSON", "GET", "fan", "tags") + arr("UJSON", "RM", "fan", "tags", 7)
    + arr("UJSON", "GET", "fan"),
    arr("GCOUNT") + arr("GCOUNT", "FOO", "x") + arr("GCOUNT", "INC", "a")
    + arr("PNCOUNT", "INC", "p", "-3") + arr("PNCOUNT", "DEC", "p", BIG + 1)
    + arr("PNCOUNT", "INC", "p", "1x") + arr("PNCOUNT", "GET")
    + arr("FOO", "GET", "a") + arr("gcount", "GET", "a") + b"\r\n"
    + arr("PNCOUNT", "GET", "p") + arr("PNCOUNT", "GET", "q")
    + arr("TREG", "SET", "r", "x") + arr("TREG", "SET", "r", "x", "-1")
    + arr("TREG", "SET", "r", "x", BIG + 1) + arr("TREG")
    + arr("TENSOR", "SET", "t", "FOO", 1, vec(1)) + arr("TENSOR", "GET")
    + arr("TENSOR", "MRG", "t") + arr("TLOG", "INS", "l", "x")
    + arr("TLOG", "TRIM", "l", "-1") + arr("TLOG", "GET", "l", "x")
    + arr("TLOG", "FOO") + arr("TLOG") + arr("UJSON") + arr("UJSON", "GET")
    + arr("UJSON", "SET", "u") + arr("UJSON", "INS", "u", "tags", "{bad")
    + arr("UJSON", "RM", "u", "tags", "[1]") + arr("UJSON", "FOO", "u"),
    b"".join(arr("PNCOUNT", "GET", "k%d" % i) for i in range(40))
    + b"".join(arr("GCOUNT", "GET", "k%d" % i) for i in range(40))
    + b"".join(arr("TREG", "GET", "k%d" % i) for i in range(40))
    + b"".join(arr("TENSOR", "GET", "k%d" % i) for i in range(40))
    + b"".join(arr("TLOG", "GET", "k%d" % i) for i in range(40))
    + b"".join(arr("TLOG", "CUTOFF", "k%d" % i) for i in range(40))
    + b"".join(arr("UJSON", "GET", "k%d" % i) for i in range(40)),
]
# UJSON deltas as (writer replica id, ops) specs; each package builds its
# own documents from them (ujson_delta). FAN's 300 deltas to one key
# reach DEVICE_FANIN_MIN: the port folds them in the resident store
FAN = [(300 + i % 3, [("ins", ("tags",), str(i))]) for i in range(300)]
DELTAS = [
    [("GCOUNT", [(b"a", {7: 3, 8: BIG})]),
     ("PNCOUNT", [(b"p", ({7: 100}, {8: BIG}))]),
     ("TREG", [(b"r", (b"hello", 5)), (b"r2", (b"\xff\x00", BIG))]),
     ("TENSOR", [(b"v", tensor_blob(3, 2, contribs={9: (2, vec(8, 8))})),
                 (b"m", tensor_blob(1, 3, vec(0.0, 1, 7)))]),
     ("TLOG", [(b"l", ([(b"x", 5), (b"q", 7), (b"q", 7)], 0)),
               (b"l2", ([(b"old", 1), (b"new", 1 << 40)], 0))]),
     ("UJSON", [(b"u", (77, [("set", ("a",), '{"z": 3}'), ("ins", ("tags",), '"r"')])),
                (b"u2", (78, [("ins", ("tags",), "1"), ("ins", ("tags",), "2")])),
                *((b"fan", spec) for spec in FAN)])],
    [],
    [("GCOUNT", [(b"k%d" % i, {7: i, 9: BIG - i}) for i in range(40)]),
     ("PNCOUNT", [(b"k%d" % i, ({7: i * 3}, {9: BIG - i})) for i in range(40)]),
     ("TREG", [(b"k%d" % i, (b"val%d" % (i % 5), i // 3)) for i in range(40)]),
     ("TENSOR", [(b"k%d" % i, tensor_blob(1 + i % 3, 2, vec(i, -i), np.array(
         [i, 1], "<u8").tobytes(), np.array([3, 3], "<u4").tobytes())
         if i % 3 == 1 else tensor_blob(
             1 + i % 3, 2, vec(i, -i) if i % 3 == 0 else b"",
             contribs={i: (i, vec(i, i))} if i % 3 == 2 else None))
         for i in range(40)]),
     ("TLOG", [(b"k%d" % i, ([(b"e%d" % (i % 3), i), (b"f", i + 1)], i // 2))
               for i in range(40)]),
     ("UJSON", [(b"k%d" % i, (90 + i % 4, [("set", (), '{"n": %d}' % i)]))
                for i in range(40)])],
]


def ujson_delta(cls, writers, key, spec):
    """One package's UJSON delta from a (replica, ops) spec: the key's
    writer document for that replica (kept in ``writers``, so a stream
    of specs mints successive dots) runs the ops and accumulates their
    delta."""
    replica, ops = spec
    writer, delta = writers.setdefault((key, replica), cls()), cls()
    for op, path, value in ops:
        if op == "set":
            writer.set_doc(replica, path, value, delta)
        else:
            writer.ins(replica, path, value, delta)
    return delta


def decoded(name, batch, codec_mod):
    """A delta batch as one package's objects: TENSOR deltas travel as
    codec blobs and are decoded by that package's codec; UJSON deltas are
    built from their specs with that package's document class."""
    if name == "UJSON":
        cls = JaxUJSON if codec_mod is jax_codec else UJSON
        writers = {}
        return [(k, ujson_delta(cls, writers, k, spec)) for k, spec in batch]
    if name != "TENSOR":
        return batch
    return [(k, codec_mod.decode_delta("TENSOR", b)) for k, b in batch]


def jax_replies() -> list[bytes]:
    """The JAX database's replies to each burst."""
    db = JaxDatabase(identity=IDENTITY, engine="python")
    out = bytearray()
    resp, parser = JaxRespond(out.extend), JaxRespParser()
    replies = []
    for i, burst in enumerate(BURSTS):
        start = len(out)
        parser.append(burst)
        for cmd in parser:
            db.apply(resp, cmd)
        replies.append(bytes(out[start:]))
        for name, batch in DELTAS[i] if i < len(DELTAS) else ():
            db.converge_deltas((name, decoded(name, batch, jax_codec)))
    return replies


def test_reply_stream_matches_jax_database():
    want = jax_replies()

    async def drive():
        db = Database(identity=IDENTITY, device="cpu")
        server = Server(Config(port="0"), db)
        await server.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
        got = []
        try:
            for i, burst in enumerate(BURSTS):
                writer.write(burst)
                await writer.drain()
                got.append(
                    await asyncio.wait_for(reader.readexactly(len(want[i])), 30)
                )
                for name, batch in DELTAS[i] if i < len(DELTAS) else ():
                    await db.converge_async(name, decoded(name, batch, codec))
            # FAN's fan-in went through the resident store's fold
            assert db.manager("UJSON").repo._res is not None
        finally:
            writer.close()
            await server.dispose()
        return got

    got = asyncio.run(drive())
    assert got == want
    text = b"".join(got)
    assert b":-" in text and b"BADCOMMAND" in text
    for reply in (b"*2\r\n$5\r\nhellp\r\n:5", b"*3\r\n$3\r\nLWW",
                  b"*3\r\n*2\r\n$1\r\nz\r\n:9\r\n*2\r\n$1\r\ny\r\n:5",
                  b"*3\r\n$3\r\nAVG", b"-BADSHAPE (key holds LWW/3, write is MAX/3)",
                  b"-BADPAYLOAD (MRG", b"-BADPAYLOAD (empty",
                  b'$23\r\n{"a":{"x":1,"y":[1,2]}}\r\n', b'{"n":39}',
                  b"UJSON SET key [key...] ujson"):
        assert reply in text, reply


def test_protocol_error_replies_and_drops_the_connection():
    async def drive():
        server = Server(Config(port="0"), Database(IDENTITY, device="cpu"))
        await server.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
        try:
            writer.write(arr("GCOUNT", "INC", "a", 1) + b"*x\r\n")
            await writer.drain()
            data = await asyncio.wait_for(reader.read(), 30)
        finally:
            writer.close()
            await server.dispose()
        return data

    assert asyncio.run(drive()) == b"+OK\r\n-protocol error: bad array header\r\n"


def test_cli_config_and_identity_match_jax():
    cfg = config_from_cli(
        ["-p", "7000", "-a", "10.0.0.1:9999:node", "--device", "cpu", "-L", "error"]
    )
    assert (cfg.port, cfg.device) == ("7000", "cpu")
    assert cfg.addr.hash64() == JaxAddress("10.0.0.1", "9999", "node").hash64()
    assert config_from_cli([]).device == "cuda"


CLUSTER_FLAGS = ("seed_addrs", "heartbeat_time", "system_log_trim", "dial_timeout",
                 "dial_backoff_cap", "delta_log_cap", "range_budget", "region",
                 "bridge_demote_ticks", "failpoints", "trace_sample", "converge_slo_ms")


@pytest.mark.parametrize("argv", [
    [],
    ["-s", "10.0.0.2:9999:b 10.0.0.3:9999:c", "-T", "0.25", "--system-log-trim", "50",
     "--dial-timeout", "2.5", "--dial-backoff-cap", "8", "--delta-log-cap", "64",
     "--range-budget", "256", "--region", "r1", "--bridge-demote-ticks", "4",
     "--failpoints", "cluster.dial=error:1", "--trace-sample", "0",
     "--converge-slo-ms", "10,100"],
], ids=["defaults", "set"])
def test_cluster_flags_match_jax(argv):
    """The cluster flags parse to the JAX node's values, defaults included,
    and an empty address name gets a random one, as on a JAX node."""
    from jylis_tpu.utils.config import config_from_cli as jax_config_from_cli

    ours, theirs = config_from_cli(argv), jax_config_from_cli(argv)
    for flag in CLUSTER_FLAGS:
        a, b = getattr(ours, flag), getattr(theirs, flag)
        if flag == "seed_addrs":
            a, b = [str(x) for x in a], [str(x) for x in b]
        assert a == b, flag
    assert ours.addr.name and ours.addr.name.count("-") == 2
    assert config_from_cli(["-a", "127.0.0.1:9999:"]).addr.name != ""

def test_help_names_every_served_type(capsys):
    """The entry point's --help is built from the repo registry, so it
    names all eight types the node serves, in the JAX registry's order."""
    from jylis_tpu_torch.main import main

    with pytest.raises(SystemExit):
        main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    for name in ("TREG", "TLOG", "GCOUNT", "PNCOUNT", "UJSON", "TENSOR", "MAP", "BCOUNT"):
        assert name in text
    assert SERVED_TYPES == ("TREG", "TLOG", "GCOUNT", "PNCOUNT", "UJSON", "TENSOR", "MAP",
                            "BCOUNT") == JAX_DATA_TYPE_NAMES


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_module_entry_point_serves_and_stops_on_sigterm():
    port = _free_port()
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen(
        [sys.executable, "-m", "jylis_tpu_torch", "--port", str(port),
         "--device", "cpu", "--log-level", "error"],
        env=env, cwd=root, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=5)
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    pytest.fail(f"node did not start: {proc.stderr.read()!r}")
                time.sleep(0.1)
        with sock:
            sock.sendall(arr("GCOUNT", "INC", "a", 2) + arr("GCOUNT", "GET", "a"))
            data = b""
            while data.count(b"\r\n") < 2:
                chunk = sock.recv(4096)
                assert chunk, "connection closed early"
                data += chunk
        assert data == b"+OK\r\n:2\r\n"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()



def _spawn_node(port: int, cport: int, name: str, seeds: str = "") -> subprocess.Popen:
    root = str(Path(__file__).resolve().parents[1])
    cmd = [sys.executable, "-m", "jylis_tpu_torch", "--port", str(port),
           "--addr", f"127.0.0.1:{cport}:{name}", "--heartbeat-time", "0.1",
           "--device", "cpu", "--log-level", "error"]
    if seeds:
        cmd += ["--seed-addrs", seeds]
    return subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=root), cwd=root,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _ask(port: int, *cmds) -> list[bytes]:
    """One connection, one reply per command (simple, integer or bulk)."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(b"".join(arr(*c) for c in cmds))
        data, out = b"", []
        while len(out) < len(cmds):
            chunk = sock.recv(4096)
            assert chunk, "connection closed early"
            data += chunk
            while len(out) < len(cmds) and b"\r\n" in data:
                head, rest = data.split(b"\r\n", 1)
                if head[:1] == b"$":
                    n = int(head[1:])
                    if len(rest) < n + 2:
                        break
                    out.append(rest[:n])
                    data = rest[n + 2:]
                else:
                    out.append(head)
                    data = rest
    return out


def test_two_node_cluster_processes_converge_and_stop_on_sigterm():
    """Two ``python -m jylis_tpu_torch --device cpu`` processes, the second
    seeded with the first: a GCOUNT INC on each reads as the sum on both,
    with equal SYSTEM DIGESTs; on SIGTERM each makes its final flush and
    exits 0."""
    ports = [_free_port() for _ in range(4)]
    a = _spawn_node(ports[0], ports[1], "a")
    b = _spawn_node(ports[2], ports[3], "b", seeds=f"127.0.0.1:{ports[1]}:a")
    procs = (a, b)
    try:
        deadline = time.monotonic() + 120
        for proc, port in ((a, ports[0]), (b, ports[2])):
            while True:
                try:
                    socket.create_connection(("127.0.0.1", port), timeout=5).close()
                    break
                except OSError:
                    if proc.poll() is not None or time.monotonic() > deadline:
                        pytest.fail(f"node did not start: {proc.stderr.read()!r}")
                    time.sleep(0.1)
        assert _ask(ports[0], ("GCOUNT", "INC", "hits", 2)) == [b"+OK"]
        assert _ask(ports[2], ("GCOUNT", "INC", "hits", 3)) == [b"+OK"]
        while True:
            got = [_ask(p, ("GCOUNT", "GET", "hits"), ("SYSTEM", "DIGEST"))
                   for p in (ports[0], ports[2])]
            if got[0] == got[1] and got[0][0] == b":5":
                break
            assert time.monotonic() < deadline, f"no convergence: {got}"
            time.sleep(0.1)
        assert len(got[0][1]) == 64
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        assert [proc.wait(timeout=60) for proc in procs] == [0, 0]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            proc.stderr.close()


JAX_FREE_NODE = textwrap.dedent("""
    import asyncio
    import sys

    sys.modules["jax"] = None  # any import of jax now raises ImportError

    import chip_smoke  # noqa: F401 (the chip script, the cluster and the
    import jylis_tpu_torch.cluster  # noqa: F401  entry point load without
    import jylis_tpu_torch.main  # noqa: F401  JAX too)
    from jylis_tpu_torch.models.database import Database
    from jylis_tpu_torch.server.server import Server
    from jylis_tpu_torch.utils.config import Config


    db = Database(1, device="cpu")


    async def main(request, n):
        server = Server(Config(port="0"), db)
        await server.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
        writer.write(request)
        await writer.drain()
        reply = await asyncio.wait_for(reader.readexactly(n), 60)
        writer.close()
        await server.dispose()
        return reply


    request = sys.stdin.buffer.read()
    reply = asyncio.run(main(request, int(sys.argv[1])))
    treg = db.manager("TREG").repo
    treg.drain()  # the staged, unrouted sparse drain
    assert treg._cache and "jylis_tpu_torch.ops.staging" in sys.modules
    # the native library built and loaded, a burst settled in C++, and a
    # PushDeltas frame coded natively both ways
    from jylis_tpu_torch import native
    from jylis_tpu_torch.cluster import codec
    from jylis_tpu_torch.cluster.msg import MsgPushDeltas

    assert native.lib() is db.native_engine.cdll
    assert db.serving_totals()["native_cmds"] > 0
    msg = MsgPushDeltas("PNCOUNT", ((b"p", ({1: 1 << 63}, {2: 5})),))
    assert codec.decode(codec.encode(msg)) == msg
    assert codec.encode.native["PushDeltas"] == codec.decode.native["PushDeltas"] == 1

    # persistence: this node's snapshot restored by a node that
    # main.build_node wires with --data-dir before anything listens; its
    # clean shutdown writes the snapshot again and retires the journal
    import os
    import tempfile

    from jylis_tpu_torch import journal, persist
    from jylis_tpu_torch.main import build_node, serve
    from jylis_tpu_torch.utils.config import config_from_cli
    from jylis_tpu_torch.utils.net import free_port

    with tempfile.TemporaryDirectory() as d:
        persist.save_snapshot(db, os.path.join(d, "snapshot.jylis"))
        node = build_node(config_from_cli([
            "--device", "cpu", "--port", "0", "--addr", f"127.0.0.1:{free_port()}:p",
            "--data-dir", d, "--log-level", "error"]))
        assert isinstance(node.journal, journal.Journal)
        assert node.database._sync_digest_blocking() == db._sync_digest_blocking()

        async def stop():
            dispose = await serve(node)
            dispose.dispose()
            await dispose.done.wait()

        asyncio.run(stop())
        assert os.path.getsize(os.path.join(d, "journal.jylis")) == journal.HEADER_LEN
        fresh = Database(2, device="cpu", engine="python")
        assert persist.load_snapshot(fresh, os.path.join(d, "snapshot.jylis")) == 9
        assert fresh._sync_digest_blocking() == db._sync_digest_blocking()

    # the process glue: admission, the client, lanes and the Prometheus
    # endpoint import without JAX, and run: a session token round trip,
    # the gate's classifier, the lane functions and a render
    from jylis_tpu_torch import admission, client, lanes, sessions
    from jylis_tpu_torch.obs import prom

    assert sessions.decode_token(sessions.encode_token({"a!1": 2})) == {"a!1": 2}
    assert admission.classify([b"SESSION", b"WRAP", b"TENSOR", b"SET"]) == admission.BULK
    assert client.pack_command("GCOUNT", "GET", 1).startswith(b"*3")
    assert lanes.lane_of(b"k", 2) in (0, 1) and "jylis_lane_up" in lanes.aggregate_expositions({0: None})
    assert "jylis_cmds_total" in prom.render(db)

    loaded = [m for m in sys.modules if m == "jylis_tpu" or m.startswith("jylis_tpu.")]
    assert not loaded, loaded
    assert sys.modules["jax"] is None
    sys.stdout.buffer.write(reply)
""")


def test_serves_treg_and_tensor_without_jax():
    """The port serves TREG, TENSOR, TLOG, UJSON, MAP, BCOUNT and SYSTEM
    DIGEST in a process where ``import jax`` raises, drains TREG through
    the staged path (ops/staging.py), imports the cluster, the entry
    point and chip_smoke.py, and loads nothing of ``jylis_tpu``; its
    replies equal the JAX database's. The same process builds and loads
    the port's native library, settles the burst in the native serving
    engine and codes a PushDeltas frame natively both ways; it also
    imports persist and journal, restores the node's snapshot in a node
    that ``main.build_node`` wires with ``--data-dir`` (equal digest),
    and that node's clean shutdown writes a loadable snapshot and
    retires its journal. It imports and runs the process glue too:
    sessions, admission, client, lanes and obs.prom."""
    request = (
        arr("TREG", "SET", "r", "v1", 3) + arr("TREG", "SET", "r", "v0", 3)
        + arr("TREG", "GET", "r") + arr("TENSOR", "SET", "t", "MAX", 0, vec(1, 2))
        + arr("TENSOR", "MRG", "t", tensor_blob(1, 2, vec(3, 0)))
        + arr("TENSOR", "GET", "t")
        + arr("TLOG", "INS", "l", "a", 4) + arr("TLOG", "INS", "l", "b", 6)
        + arr("TLOG", "INS", "l", "a", 4) + arr("TLOG", "TRIM", "l", 1)
        + arr("TLOG", "INS", "l", "c", 1 << 40) + arr("TLOG", "GET", "l")
        + arr("TLOG", "SIZE", "l") + arr("TLOG", "CUTOFF", "l")
        + arr("UJSON", "SET", "u", "a", '{"b": [1, "x"]}') + arr("UJSON", "INS", "u", "a", "c", 2)
        + arr("UJSON", "RM", "u", "a", "b", 1) + arr("UJSON", "GET", "u")
        + arr("UJSON", "CLR", "u", "a", "c") + arr("UJSON", "GET", "u", "a")
        + arr("MAP", "TLOG", "SET", "m", "f", "x", 3) + arr("MAP", "GCOUNT", "SET", "m", "g", 4)
        + arr("MAP", "GCOUNT", "DEL", "m", "g") + arr("MAP", "TLOG", "GET", "m", "f")
        + arr("MAP", "GCOUNT", "KEYS", "m") + arr("BCOUNT", "GRANT", "b", 5)
        + arr("BCOUNT", "INC", "b", 7) + arr("BCOUNT", "INC", "b", 4)
        + arr("BCOUNT", "DEC", "b", 1) + arr("BCOUNT", "GET", "b")
        + arr("SYSTEM", "DIGEST") + arr("SYSTEM", "DIGEST", "TYPES") + arr("SYSTEM", "VERSION")
    )
    db = JaxDatabase(identity=1, engine="python")
    out = bytearray()
    resp, parser = JaxRespond(out.extend), JaxRespParser()
    parser.append(request)
    for cmd in parser:
        db.apply(resp, cmd)
    root = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run(
        [sys.executable, "-c", JAX_FREE_NODE, str(len(out))],
        input=request, capture_output=True, timeout=120, cwd=root,
        env=dict(os.environ, PYTHONPATH=root),
    )
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout == bytes(out)
    assert b"*2\r\n$2\r\nv1\r\n:3" in proc.stdout
    assert (b"*2\r\n*2\r\n$1\r\nc\r\n:1099511627776\r\n*2\r\n$1\r\nb\r\n:6\r\n"
            b":2\r\n:6\r\n") in proc.stdout
    assert b'$21\r\n{"a":{"b":"x","c":2}}\r\n+OK\r\n$9\r\n{"b":"x"}\r\n' in proc.stdout
    assert (b"*1\r\n*2\r\n$1\r\nx\r\n:3\r\n*0\r\n+OK\r\n-OUTOFBOUND (insufficient local inc "
            b"escrow: rights 5 < amount 7") in proc.stdout
    assert b"*2\r\n:3\r\n:5\r\n$64\r\n" in proc.stdout and b"\r\n$68\r\nMAP " in proc.stdout
