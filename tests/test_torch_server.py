"""The port's RESP server against the JAX package's database, byte for byte.

A RESP script (array and inline commands, pipelined, with parse
failures, unknown data types and anti-entropy deltas between bursts)
goes over a real socket into the port's Server (state on the CPU), and
command by command into a JAX ``Database(identity, engine="python")``
through the JAX package's real ``Respond`` writer. The two reply streams
must be equal. A separate test runs ``python -m jylis_tpu_torch`` as a
real process.
"""

import asyncio
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.server.resp import Respond as JaxRespond
from jylis_tpu.server.resp import RespParser as JaxRespParser
from jylis_tpu.utils.address import Address as JaxAddress
from jylis_tpu_torch.models.database import Database
from jylis_tpu_torch.server.server import Server
from jylis_tpu_torch.utils.config import Config, config_from_cli

IDENTITY = 0xABCDEF
BIG = (1 << 64) - 1


def arr(*parts) -> bytes:
    out = b"*%d\r\n" % len(parts)
    for p in parts:
        p = p if isinstance(p, bytes) else str(p).encode()
        out += b"$%d\r\n%s\r\n" % (len(p), p)
    return out


# bursts of raw client bytes; a delta batch is converged between bursts
BURSTS = [
    arr("GCOUNT", "INC", "a", 5) + arr("GCOUNT", "GET", "a")
    + b"PNCOUNT INC p 10\r\nPNCOUNT DEC p 25\r\n" + arr("PNCOUNT", "GET", "p"),
    arr("GCOUNT", "GET", "a") + arr("GCOUNT", "GET", "zz")
    + arr("PNCOUNT", "GET", "p") + arr("GCOUNT", "INC", "a", BIG)
    + arr("GCOUNT", "GET", "a"),
    arr("GCOUNT") + arr("GCOUNT", "FOO", "x") + arr("GCOUNT", "INC", "a")
    + arr("PNCOUNT", "INC", "p", "-3") + arr("PNCOUNT", "DEC", "p", BIG + 1)
    + arr("PNCOUNT", "INC", "p", "1x") + arr("PNCOUNT", "GET")
    + arr("FOO", "GET", "a") + arr("gcount", "GET", "a") + b"\r\n"
    + arr("PNCOUNT", "GET", "p") + arr("PNCOUNT", "GET", "q"),
    b"".join(arr("PNCOUNT", "GET", "k%d" % i) for i in range(40))
    + b"".join(arr("GCOUNT", "GET", "k%d" % i) for i in range(40)),
]
DELTAS = [
    [("GCOUNT", [(b"a", {7: 3, 8: BIG})]),
     ("PNCOUNT", [(b"p", ({7: 100}, {8: BIG}))])],
    [],
    [("GCOUNT", [(b"k%d" % i, {7: i, 9: BIG - i}) for i in range(40)]),
     ("PNCOUNT", [(b"k%d" % i, ({7: i * 3}, {9: BIG - i})) for i in range(40)])],
]


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
            db.converge_deltas((name, batch))
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
                    await db.converge_async(name, batch)
        finally:
            writer.close()
            await server.dispose()
        return got

    got = asyncio.run(drive())
    assert got == want
    text = b"".join(got)
    assert b":-" in text and b"BADCOMMAND" in text


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
