"""``python -m cardbench.traffic.loadgen``: open-loop RESP GETs at a fixed
rate, over a fixed number of client connections.

A copy of the open-loop worker and the Zipf sampler of the repo's
``scripts/loadgen.py``, one worker a connection, each on threads of this
process (the script's own calibration runs its workers so): a sender
thread sends each command at its
scheduled time whether or not earlier replies have come, a receiver
thread matches replies to their scheduled times in order, and a
command's latency runs from its scheduled send, so a stall's queueing
counts. Keys follow a Zipf law over the configuration's keyspace, the
ranks scattered over the keys by a seeded permutation (YCSB's scrambled
zipfian). A reply that is an error, or that never comes, is a failure.

Protocol: the first stdin line is the spec (configuration, traffic,
seed, RESP port); each "run" line (start time on the monotonic clock,
seconds, phase number) answers one stdout line with the phase's
samples; "exit" ends. Imports nothing of the program.
"""

from __future__ import annotations

import bisect
import json
import math
import random
import socket
import sys
import threading
import time
from collections import deque

import numpy as np

from .gen import key_bytes

HOST = "127.0.0.1"
REPLY_TIMEOUT_S = 60.0


def _pack(args: list[bytes]) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


class _Conn:
    def __init__(self, host: str, port: int, timeout: float = REPLY_TIMEOUT_S):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        self.buf = b""

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _fill(self) -> None:
        chunk = self.sock.recv(1 << 16)
        if not chunk:
            raise RuntimeError("connection closed by server")
        self.buf += chunk

    def _line(self) -> bytes:
        while b"\r\n" not in self.buf:
            self._fill()
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def read_reply(self):
        """One reply; an error reply returns ("err", text)."""
        line = self._line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest
        if kind == b"-":
            return ("err", rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            while len(self.buf) < n + 2:
                self._fill()
            out, self.buf = self.buf[:n], self.buf[n + 2 :]
            return out
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self.read_reply() for _ in range(n)]
        raise RuntimeError(f"unparseable reply line: {line!r}")


class Zipf:
    """Rank sampler over ``n`` keys with exponent ``s`` via inverse-CDF
    bisect."""

    def __init__(self, n: int, s: float):
        weights = [1.0 / math.pow(r, s) for r in range(1, n + 1)]
        total = sum(weights)
        acc, cdf = 0.0, []
        for w in weights:
            acc += w / total
            cdf.append(acc)
        self.cdf = cdf

    def rank(self, rng: random.Random) -> int:
        return min(bisect.bisect_left(self.cdf, rng.random()), len(self.cdf) - 1)


class Reader:
    def __init__(self, spec: dict):
        cfg, traffic = spec["config"], spec["traffic"]
        self.type = cfg["type"].encode()
        self.seed = spec["seed"]
        self.port = spec["resp_port"]
        self.rate = traffic["gets_per_s"]
        self.connections = traffic["connections"]
        self.keys = key_bytes(cfg["key_format"], cfg["keys"])
        self.zipf = Zipf(cfg["keys"], traffic["zipf_theta"])
        self.scatter = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32, 31]).permutation(
            cfg["keys"])

    def run(self, t_start: float, seconds: float, phase: int) -> dict:
        """The phase's GETs over ``connections`` connections, one open-loop
        worker each, their sends interleaved so the whole offers ``rate``
        evenly; the latencies in the order they were scheduled."""
        n = self.connections
        outs: list = [None] * n
        workers = [threading.Thread(target=lambda c=c: outs.__setitem__(
            c, self._worker(t_start, seconds, phase, c)), daemon=True) for c in range(n)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(seconds + 2 * REPLY_TIMEOUT_S)
        if any(o is None for o in outs):
            raise RuntimeError("a reader connection did not finish")
        timed = sorted(x for o in outs for x in o["timed"])
        return {"event": "ran", "sent": sum(o["sent"] for o in outs),
                "errors": sum(o["errors"] for o in outs), "lat_ms": [v for _, v in timed],
                "sender_lag_ms": max(o["lag_ms"] for o in outs),
                "failures": [f for o in outs for f in o["failures"]]}

    def _worker(self, t_start: float, seconds: float, phase: int, c: int) -> dict:
        """One connection's open loop: its share of the schedule, from
        ``t_start + c / rate`` every ``connections / rate`` seconds."""
        rng = random.Random(f"{self.seed}/{phase}/{c}")
        conn = _Conn(HOST, self.port)
        pending: deque = deque()
        timed: list[tuple[float, float | None]] = []
        err = [0]
        queued = threading.Semaphore(0)  # one release a command sent, one at the end
        fail: list[str] = []

        def recv() -> None:
            try:
                while True:
                    queued.acquire()
                    if not pending:
                        return
                    reply = conn.read_reply()
                    t_sched = pending.popleft()
                    if isinstance(reply, tuple) and reply[0] == "err":
                        err[0] += 1
                        timed.append((t_sched, None))
                    else:
                        timed.append((t_sched, (time.monotonic() - t_sched) * 1e3))
            except (OSError, RuntimeError) as e:
                fail.append(f"receiver: {e}")

        rx = threading.Thread(target=recv, daemon=True)
        rx.start()
        interval = self.connections / self.rate
        first = t_start + c / self.rate
        end = t_start + seconds
        lag = 0.0
        i = 0
        sent: list[float] = []
        try:
            while not fail:
                t_sched = first + i * interval
                if t_sched >= end:
                    break
                now = time.monotonic()
                if t_sched > now:
                    time.sleep(min(t_sched - now, 0.25))
                    continue
                lag = max(lag, now - t_sched)
                key = self.keys[self.scatter[self.zipf.rank(rng)]].tobytes()
                # enqueue BEFORE the (possibly blocking) send: the reply
                # can arrive while sendall is parked on TCP backpressure
                pending.append(t_sched)
                sent.append(t_sched)
                queued.release()
                conn.sock.sendall(_pack([self.type, b"GET", key]))
                i += 1
        except OSError as e:
            fail.append(f"sender: {e}")
        queued.release()  # the receiver ends once it finds nothing pending
        rx.join(timeout=seconds + REPLY_TIMEOUT_S)
        conn.close()
        # a GET sent but never answered is a failure too
        timed.extend((t, None) for t in sent[len(timed):])
        return {"sent": i, "errors": err[0], "timed": timed, "lag_ms": lag * 1e3,
                "failures": fail}


def serve() -> None:
    spec = json.loads(sys.stdin.readline())
    reader = Reader(spec)
    sys.stdout.write(json.dumps({"event": "prepared"}) + "\n")
    sys.stdout.flush()
    for text in sys.stdin:
        cmd = json.loads(text)
        if cmd["cmd"] == "exit":
            break
        out = reader.run(cmd["t_start"], cmd["seconds"], cmd["phase"])
        sys.stdout.write(json.dumps(out) + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    serve()
