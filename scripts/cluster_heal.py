#!/usr/bin/env python3
"""How two cluster nodes heal a divergence that only the range sync carries.

    python3 scripts/cluster_heal.py --kind port --tick 0.1 [--keys N] [--deadline S]
    python3 scripts/cluster_heal.py --kind jax --tick 0.1         # the JAX package's nodes
    python3 scripts/cluster_heal.py --kind jax-oracle --tick 0.1  # ... codec without its native path
    python3 scripts/cluster_heal.py --costs [--keys N]

Runs on the CPU. Two nodes of one package, each in a process of its own,
heartbeat ``--tick`` and range budget 256 as in chip_smoke.py's cluster
phase: node h is loaded with BASELINE config 2 (``--keys`` GCOUNT and
PNCOUNT keys from 8 replica ids, default 100,000), node c starts empty,
seeded with h, and bootstraps over the wire. Then chip_smoke.py's
all-type script runs with ``--keys`` as its MESH_KEYS and its other
sizes as the chip phase has them: its RESP bursts alternate between the
nodes and its foreign batches are split between them, the i-th to c when
i is even, else to h. No broadcast carries a foreign batch, so only the
periodic digest exchange's range sync can bring the two nodes together.
Prints JSON lines: seconds to mesh; for the bootstrap and for the script,
the types that differ over time (SYSTEM DIGEST TYPES polled every 0.5 s
up to ``--deadline`` seconds, default 300) and the seconds to equal
digests, or null; each node's CLUSTER counters. Each node runs its
package's default serving engine, the native one (a port node's
``build_node``, a JAX ``Database(engine="auto")``), as a deployed node
does.

``--costs`` times, in one process, the work a range round does under a
repo lock or on the event loop at config 2's size: each counter type's
digest fold, ``dump_state`` and a range dump of 32 of the 256 digest-tree
buckets over ``--keys`` keys, and the codec's
encode and decode of the PNCOUNT state as 2,048-key MsgPushDeltas frames,
for the port and the JAX package, each with its native serving engine
and with its Python tables (the converge of config 2 too), and each
codec on its native path and on its oracle (the port's
``codec.encode(msg, native=False)``).

Port nodes import nothing of JAX; ``--kind jax``, ``jax-oracle`` and
``--costs`` import the JAX package (set JAX_PLATFORMS=cpu).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

POLL_S = 0.5


def say(obj) -> None:
    print(json.dumps(obj), flush=True)


def node_stack(spec: dict):
    """(database, server, cluster, converge(name, batch) coroutine fn) of
    one node, started on an event loop the caller runs."""
    kind, tick = spec["kind"], spec["tick"]
    if kind == "port":
        from jylis_tpu_torch.main import build_node
        from jylis_tpu_torch.utils.config import config_from_cli

        seeds = " ".join(":".join(s) for s in spec["seeds"])
        config = config_from_cli(["-p", "0", "-a", f"127.0.0.1:{spec['port']}:{spec['name']}",
                                  "-s", seeds, "-T", str(tick), "--range-budget", "256",
                                  "--device", "cpu", "-L", "error"])
        node = build_node(config)
        return node.database, node.server, node.cluster, node.database.converge_async
    if kind == "jax-oracle":
        from jylis_tpu.native import codec as ncodec

        ncodec.encode_push = lambda msg: None
        ncodec.decode_push = lambda body: None
    from jylis_tpu.cluster import Cluster
    from jylis_tpu.cluster import codec as jcodec
    from jylis_tpu.models.database import Database
    from jylis_tpu.server.server import Server
    from jylis_tpu.system import System
    from jylis_tpu.utils.address import Address
    from jylis_tpu.utils.config import Config
    from jylis_tpu_torch.cluster import codec as pcodec
    from jylis_tpu_torch.cluster.msg import MsgPushDeltas

    config = Config()
    config.port = "0"
    config.addr = Address("127.0.0.1", str(spec["port"]), spec["name"])
    config.seed_addrs = [Address(*s) for s in spec["seeds"]]
    config.heartbeat_time, config.range_budget = tick, 256
    system = System(config)
    db = Database(identity=config.addr.hash64(), system_repo=system.repo, engine="auto")

    async def converge(name, batch):
        # the script's deltas are the port's objects: carry them over the wire bytes
        msg = jcodec.decode(pcodec.encode(MsgPushDeltas(name, tuple(batch))))
        await db.converge_async((name, list(msg.batch)))

    return db, Server(config, db), Cluster(config, db), converge


def peer(spec: dict) -> None:
    """One node; one JSON line on stdout per command line on stdin."""
    cs.NODE_KEYS = cs.MESH_KEYS = spec["keys"]
    from jylis_tpu_torch.utils.net import free_port

    spec["port"] = free_port()
    db, server, cluster, converge = node_stack(spec)
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(600)

    async def start():
        await server.start()
        await cluster.start()

    async def stop():
        cluster.dispose()
        await server.dispose()

    async def totals():
        return cluster.metrics_totals()

    async def established():
        return sum(1 for c in list(cluster._actives.values()) if c.established)

    run(start())
    say({"addr": ["127.0.0.1", str(spec["port"]), spec["name"]], "resp_port": int(server.port)})
    for line in sys.stdin:
        cmd, t0 = line.split(), time.perf_counter()
        if cmd[0] == "config2":
            rng = np.random.default_rng(cs.SEED + 90)
            keys = [b"k%06d" % i for i in range(cs.NODE_KEYS)]
            rids = [int(x) for x in rng.integers(1 << 40, 1 << 62, cs.NODE_REPLICAS)]
            for name, batch in cs.cluster_config2(rng, keys, rids):
                run(converge(name, batch))
            say({"done": "config2", "s": time.perf_counter() - t0})
        elif cmd[0] == "half":  # half <0|1>: the foreign batches of this parity
            convs = [s for s in cs.cluster_script()[0] if s[0] == "conv"]
            for step in convs[int(cmd[1])::2]:
                run(converge(step[1], step[2]))
            say({"done": "half", "s": time.perf_counter() - t0})
        elif cmd[0] == "stats":
            say(run(totals()))
        elif cmd[0] == "established":
            say({"established": run(established())})
        else:
            break
    run(stop())


class Peer:
    def __init__(self, spec: dict):
        self.proc = subprocess.Popen([sys.executable, __file__, "--peer", json.dumps(spec)],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        hello = self.read()
        self.addr, self.client = hello["addr"], cs.Client(hello["resp_port"])

    def read(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise SystemExit(f"a node's process exited ({self.proc.poll()})")
        return json.loads(line)

    def send(self, cmd: str) -> None:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()

    def ask(self, cmd: str) -> dict:
        self.send(cmd)
        return self.read()

    def close(self) -> None:
        self.client.close()
        self.send("exit")
        self.proc.wait(timeout=60)


def wait_equal(a: Peer, b: Peer, deadline: float) -> tuple[float | None, list]:
    seen, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < deadline:
        da, db = (cs.digests_of(n) for n in (a, b))
        lines = [set(d[1].split(b"\r\n")) for d in (da, db)]
        differ = sorted({ln.split(b" ")[0].decode() for ln in lines[0] ^ lines[1] if b" " in ln})
        if not seen or seen[-1][1] != differ:
            seen.append((round(time.perf_counter() - t0, 2), differ))
        if da == db:
            return time.perf_counter() - t0, seen
        time.sleep(POLL_S)
    return None, seen


def heal(args) -> None:
    spec = {"kind": args.kind, "tick": args.tick, "keys": args.keys, "seeds": []}
    h = Peer(dict(spec, name="h"))
    c = None
    try:
        say({"kind": args.kind, "tick": args.tick, "keys": args.keys,
             "load_h_s": h.ask("config2")["s"]})
        t0 = time.perf_counter()
        c = Peer(dict(spec, name="c", seeds=[h.addr]))
        while c.ask("established")["established"] != 1 or h.ask("established")["established"] != 1:
            time.sleep(0.2)
        say({"mesh_s": time.perf_counter() - t0})
        s, seen = wait_equal(c, h, args.deadline)
        say({"step": "bootstrap", "equal_s": s, "differ": seen})
        t0 = time.perf_counter()
        c.send("half 0")
        h.send("half 1")
        bursts = [step[1] for step in cs.cluster_script()[0] if step[0] == "cmds"]
        for i, cmds in enumerate(bursts):
            (c, h)[i % 2].client.pipeline(cmds)
        c_s, h_s = c.read()["s"], h.read()["s"]
        say({"step": "script", "s": time.perf_counter() - t0, "c_half_s": c_s, "h_half_s": h_s})
        s, seen = wait_equal(c, h, args.deadline)
        say({"step": "last write to equal", "equal_s": s, "differ": seen})
        keep = ("evictions", "drop_idle", "drop_eof", "ranges_requested", "ranges_served",
                "sync_served", "sync_deferred", "sync_trees_sent", "sync_bytes_recv")
        for name, node in (("c", c), ("h", h)):
            st = node.ask("stats")
            say({"node": name, **{k: st.get(k, 0) for k in keep}})
    finally:
        for node in (c, h):
            if node is not None:
                node.close()


def costs(args) -> None:
    from jylis_tpu.cluster import codec as jcodec
    from jylis_tpu.cluster.msg import MsgPushDeltas as JaxMsg
    from jylis_tpu.models.database import Database as JaxDatabase
    from jylis_tpu_torch.cluster import codec as pcodec
    from jylis_tpu_torch.cluster.msg import MsgPushDeltas
    from jylis_tpu_torch.models.database import Database

    rng = np.random.default_rng(cs.SEED + 90)
    keys = [b"k%06d" % i for i in range(args.keys)]
    rids = [int(x) for x in rng.integers(1 << 40, 1 << 62, cs.NODE_REPLICAS)]
    batches = cs.cluster_config2(rng, keys, rids)
    for kind, engine in (("port", "auto"), ("port", "python"), ("jax", "auto"),
                         ("jax", "python")):
        t0 = time.perf_counter()
        if kind == "port":
            db = Database(1, device="cpu", engine=engine)
            for name, batch in batches:
                db.converge(name, batch)
        else:
            db = JaxDatabase(identity=1, engine=engine)
            for name, batch in batches:
                db.converge_deltas((name, batch))
        say({"package": kind, "engine": engine, "converge_s": time.perf_counter() - t0})
        for name in ("GCOUNT", "PNCOUNT"):
            repo = db._map[name.encode()].repo
            t0 = time.perf_counter()
            db._sync_update_repo(name, repo)
            fold = time.perf_counter() - t0
            t0 = time.perf_counter()
            repo.dump_state()
            dump = time.perf_counter() - t0
            # a range round's dump of one bucket in eight (32 of 256)
            buckets = range(0, 256, 8)
            t0 = time.perf_counter()
            asyncio.run(db.dump_range_async(name, buckets))
            say({"package": kind, "engine": engine, "type": name, "keys": args.keys,
                 "fold_s": fold,
                 "dump_s": dump, "range_32_of_256_s": time.perf_counter() - t0})
    state = [kd for name, batch in batches if name == "PNCOUNT" for kd in batch]
    chunks = [tuple(state[i:i + 2048]) for i in range(0, len(state), 2048)]
    for label, enc, dec, msg in (("port native", pcodec.encode, pcodec.decode, MsgPushDeltas),
                                 ("port oracle", lambda m: pcodec.encode(m, native=False),
                                  lambda b: pcodec.decode(b, native=False), MsgPushDeltas),
                                 ("jax native", jcodec.encode, jcodec.decode, JaxMsg),
                                 ("jax oracle", jcodec._encode_oracle, jcodec._decode_oracle,
                                  JaxMsg)):
        t0 = time.perf_counter()
        frames = [enc(msg("PNCOUNT", chunk)) for chunk in chunks]
        encode = time.perf_counter() - t0
        t0 = time.perf_counter()
        for f in frames:
            dec(f)
        say({"codec": label, "keys": len(state), "frames": len(frames),
             "bytes": sum(map(len, frames)), "encode_s": encode,
             "decode_s": time.perf_counter() - t0})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", choices=("port", "jax", "jax-oracle"), default="port")
    ap.add_argument("--tick", type=float, default=0.1)
    ap.add_argument("--keys", type=int, default=100_000)
    ap.add_argument("--deadline", type=float, default=300.0)
    ap.add_argument("--costs", action="store_true")
    ap.add_argument("--peer", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.peer:
        peer(json.loads(args.peer))
    elif args.costs:
        costs(args)
    else:
        heal(args)


if __name__ == "__main__":
    main()
