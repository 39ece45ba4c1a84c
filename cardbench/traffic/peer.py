"""``python -m cardbench.traffic.peer``: a cell's synthetic cluster peers,
all in this one process on one asyncio thread.

Each peer is one replica id on one connection to the node's cluster
port. It listens on the address it advertises and answers the node's
dial as a cluster member does: the signature echo, its address set,
Pong to announces and pushes, DeltaAck to sequenced pushes and SyncDone
to the node's sync request. On its own connection it pushes its stream's
frames (gen.py) in a closed loop on the node's ``MsgPong``: the next
frame goes out once the last one's Pong arrives. A frame counts as
acknowledged when its Pong arrives; each frame's send-to-Pong time is
kept.

Where the data type's module asks for it (``DRAIN_AT_CLOSE``,
types/<type>.py) a phase ends with a drain-forcing read: a GET of one
key of each peer's last acknowledged frame, over RESP, so the phase's
deltas are joined into the state when it closes. With
``forced_reads_per_s`` a read of a key the sweep has just written goes
out that many times a second during the phase as well.

Protocol: one JSON object a line on stdin, one a line on stdout. The
first line is the spec (configuration, traffic, seed, the directory of
the type modules); then "connect" (ports), "fill", "run" (start time on
the monotonic clock, seconds) and "exit". Imports nothing of the
program.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

import numpy as np

from .. import types
from . import gen, wire

HOST = "127.0.0.1"
CONNECT_TIMEOUT_S = 60.0


def say(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


class Peer:
    def __init__(self, idx: int, stream: gen.Stream, epoch: int):
        self.idx, self.stream, self.epoch = idx, stream, epoch
        self.name = f"cardbench-peer{idx}"
        self.next_j = 0  # the next frame of the stream to send
        self.last_keys: np.ndarray | None = None  # of the last acked frame
        self.synced = asyncio.Event()
        self.pongs: asyncio.Queue = asyncio.Queue()
        self.server = None
        self.lport = 0
        self.reader = self.writer = None
        self.served: set = set()  # writers of the connections the node dialed
        self.tasks: set[asyncio.Task] = set()

    @property
    def addr(self) -> tuple[str, int, str]:
        return (HOST, self.lport, self.name)

    async def listen(self) -> None:
        self.server = await asyncio.start_server(self._serve, HOST, 0)
        self.lport = self.server.sockets[0].getsockname()[1]

    async def _serve(self, reader, writer) -> None:
        """A connection the node dialed to us."""
        frames = wire.FrameReader()
        greeted = False
        self.served.add(writer)
        try:
            while data := await reader.read(1 << 16):
                frames.append(data)
                for payload in frames:
                    body = wire.check_frame(payload)
                    if not greeted:
                        if not body.startswith(wire.SIGNATURE):
                            raise wire.WireError("the node's hello has another signature")
                        writer.write(wire.wire_frame(wire.echo(self.epoch)))
                        greeted = True
                        continue
                    reply = self._answer(body)
                    if reply is not None:
                        writer.write(wire.wire_frame(reply))
        except (ConnectionError, wire.WireError):
            pass
        finally:
            self.served.discard(writer)
            writer.close()

    def _answer(self, body: bytes) -> bytes | None:
        tag = body[0]
        if tag == wire.TAG_EXCHANGE:
            return wire.exchange_addrs([self.addr])
        if tag in (wire.TAG_ANNOUNCE, wire.TAG_PUSH):
            return wire.pong()
        if tag == wire.TAG_SYNC_REQ:
            self.synced.set()
            return wire.sync_done()
        if tag in (wire.TAG_SEQ_PUSH, wire.TAG_RELAY_PUSH):
            return wire.delta_ack(wire.seq_of(body))
        return None

    async def dial(self, cport: int) -> None:
        self.reader, self.writer = await asyncio.open_connection(HOST, cport)
        self.writer.write(wire.wire_frame(wire.hello(*self.addr, self.epoch)))
        frames = wire.FrameReader()
        while True:
            data = await self.reader.read(1 << 16)
            if not data:
                raise ConnectionError("the node closed the connection in the handshake")
            frames.append(data)
            echo = next(frames, None)
            if echo is not None:
                break
        if not wire.check_frame(echo).startswith(wire.SIGNATURE):
            raise wire.WireError("the node's echo has another signature")
        self.writer.write(wire.wire_frame(wire.exchange_addrs([self.addr])))
        task = asyncio.create_task(self._read_loop(frames))
        self.tasks.add(task)

    async def _read_loop(self, frames: wire.FrameReader) -> None:
        try:
            while True:
                for payload in frames:
                    if wire.check_frame(payload)[:1] == bytes([wire.TAG_PONG]):
                        self.pongs.put_nowait(time.monotonic())
                data = await self.reader.read(1 << 16)
                if not data:
                    break
                frames.append(data)
        finally:
            self.pongs.put_nowait(None)  # wakes a push waiting on a dead connection

    async def push(self, j: int) -> float:
        """Send frame j and wait for its Pong; the send-to-Pong ms."""
        body = self.stream.frame(j)
        t0 = time.monotonic()
        self.writer.write(wire.wire_frame(body))
        await self.writer.drain()
        t1 = await self.pongs.get()
        if t1 is None:
            raise ConnectionError(f"peer {self.idx}: the node closed the connection")
        self.last_keys = self.stream.keys(j)
        return (t1 - t0) * 1e3

    async def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        for task in self.tasks:
            task.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)
        if self.server is not None:
            self.server.close()
            for w in list(self.served):
                w.close()
            await self.server.wait_closed()


class Resp:
    """A RESP connection for the peers' reads."""

    def __init__(self, reader, writer):
        self.reader, self.writer = reader, writer

    @classmethod
    async def open(cls, port: int) -> "Resp":
        return cls(*await asyncio.open_connection(HOST, port))

    async def get(self, type_name: str, key: bytes) -> bool:
        """One GET; True when the reply is not an error."""
        words = [type_name.encode(), b"GET", key]
        self.writer.write(b"*%d\r\n" % len(words)
                          + b"".join(b"$%d\r\n%s\r\n" % (len(w), w) for w in words))
        return await self._reply()

    async def _reply(self) -> bool:
        line = await self.reader.readuntil(b"\r\n")
        kind, rest = line[:1], line[1:-2]
        if kind == b"$" and int(rest) >= 0:
            await self.reader.readexactly(int(rest) + 2)
        elif kind == b"*":
            ok = True
            for _ in range(max(int(rest), 0)):
                ok = await self._reply() and ok
            return ok
        return kind != b"-"

    def close(self) -> None:
        self.writer.close()


class Peers:
    def __init__(self, spec: dict):
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.type = self.cfg["type"]
        self.kind = types.load(self.type, spec["types"])
        streams = gen.streams(self.cfg, self.traffic, spec["seed"], self.kind)
        self.key_table = streams[0].key_table
        self.peers = [Peer(i, s, epoch=1 + i) for i, s in enumerate(streams)]
        self.resp: Resp | None = None

    async def prepare(self) -> dict:
        for p in self.peers:
            await p.listen()
        return {"event": "prepared", "listen_ports": [p.lport for p in self.peers]}

    async def connect(self, cport: int, resp_port: int) -> dict:
        for p in self.peers:
            await p.dial(cport)
        # the node dials back each peer it learns of and asks it for its
        # state: set-up goes on once every peer has answered
        await asyncio.wait_for(asyncio.gather(*(p.synced.wait() for p in self.peers)),
                               CONNECT_TIMEOUT_S)
        self.resp = await Resp.open(resp_port)
        return {"event": "connected"}

    async def fill(self) -> dict:
        async def one(p: Peer) -> None:
            for j in range(p.stream.n_fill):
                await p.push(j)
            p.next_j = p.stream.n_fill

        t0 = time.monotonic()
        await asyncio.gather(*(one(p) for p in self.peers))
        return {"event": "filled", "seconds": time.monotonic() - t0,
                "frames": [p.next_j for p in self.peers]}

    def _key(self, keys: np.ndarray) -> bytes:
        return self.key_table[int(keys[0])].tobytes()

    async def run(self, t_start: float, seconds: float) -> dict:
        """Push from ``t_start`` for ``seconds``, then close the phase."""
        t_end = t_start + seconds
        ack_ms: list[float] = []
        merges = [0]

        async def one(p: Peer) -> None:
            while time.monotonic() < t_end:
                j = p.next_j
                p.next_j += 1
                ack_ms.append(await p.push(j))
                merges[0] += len(p.stream.keys(j))

        reads = {"sent": 0, "failed": 0, "lat_ms": []}

        async def forced_reads(hz: float) -> None:
            i = 1
            while (t_due := t_start + i / hz) < t_end:
                await asyncio.sleep(max(t_due - time.monotonic(), 0.0))
                keys = self.peers[i % len(self.peers)].last_keys
                if keys is not None:
                    reads["sent"] += 1
                    ok = await self.resp.get(self.type, self._key(keys))
                    reads["failed"] += not ok
                    reads["lat_ms"].append((time.monotonic() - t_due) * 1e3)
                i += 1

        await asyncio.sleep(max(t_start - time.monotonic(), 0.0))
        jobs = [one(p) for p in self.peers]
        hz = self.traffic.get("forced_reads_per_s", 0)
        if hz:
            jobs.append(forced_reads(hz))
        await asyncio.gather(*jobs)
        if self.kind.DRAIN_AT_CLOSE:
            # the drain-forcing close: every delta acked so far is joined
            # into the state once these reads return
            for p in self.peers:
                if p.last_keys is not None:
                    ok = await self.resp.get(self.type, self._key(p.last_keys))
                    reads["failed"] += not ok
        t_close = time.monotonic()
        return {"event": "ran", "t_start": t_start, "t_close": t_close,
                "window_s": t_close - t_start, "merges": merges[0],
                "frames": [p.next_j for p in self.peers], "ack_ms": ack_ms,
                "reads": reads}

    async def close(self) -> None:
        if self.resp is not None:
            self.resp.close()
        for p in self.peers:
            await p.close()


async def serve() -> None:
    loop = asyncio.get_running_loop()

    async def line() -> dict | None:
        text = await loop.run_in_executor(None, sys.stdin.readline)
        return json.loads(text) if text.strip() else None

    peers = Peers(await line())
    say(await peers.prepare())
    try:
        while (cmd := await line()) is not None and cmd["cmd"] != "exit":
            if cmd["cmd"] == "connect":
                say(await peers.connect(cmd["cport"], cmd["resp_port"]))
            elif cmd["cmd"] == "fill":
                say(await peers.fill())
            elif cmd["cmd"] == "run":
                say(await peers.run(cmd["t_start"], cmd["seconds"]))
            else:
                raise ValueError(f"unknown command {cmd!r}")
    finally:
        await peers.close()


if __name__ == "__main__":
    asyncio.run(serve())
