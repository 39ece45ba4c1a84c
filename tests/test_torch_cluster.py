"""The port's cluster against the JAX package's, over real loopback TCP.

Complete node stacks (System, Database, Server, Cluster) run in one event
loop on the CPU with a 50 ms heartbeat (after tests/test_cluster.py): JAX
nodes take a JAX ``Database(engine="python")``, port nodes a port
``Database(device="cpu")``. Every write goes in over RESP, or as foreign
deltas through ``converge_async`` where a test needs state that no
broadcast carries, so only a sync can ship it. Nodes are converged when
their ``SYSTEM DIGEST`` and every line of ``SYSTEM DIGEST TYPES`` are
equal; GET replies for keys of every type must then be equal too.

Every wait polls to a deadline of many heartbeats and never asserts
after a fixed sleep (tier-1 runs these beside other tests on a few
cores, where ticks stretch). Listeners bind fresh ephemeral ports and a
node whose port was taken in the meantime is rebuilt on another.
"""

import asyncio
import errno
import socket
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jylis_tpu.cluster import Cluster as JaxCluster
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.server.server import Server as JaxServer
from jylis_tpu.system import System as JaxSystem
from jylis_tpu.utils.address import Address as JaxAddress
from jylis_tpu.utils.config import Config as JaxConfig
from jylis_tpu.utils.log import Log as JaxLog
from jylis_tpu_torch.cluster import Cluster
from jylis_tpu_torch.cluster.cluster import wire_frame
from jylis_tpu_torch.models.database import SERVED_TYPES, Database
from jylis_tpu_torch.server.server import Server
from jylis_tpu_torch.system import System
from jylis_tpu_torch.utils.address import Address
from jylis_tpu_torch.utils.config import Config
from jylis_tpu_torch.utils.log import Log

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

TICK = 0.05
DEADLINE_S = 90.0  # 1,800 heartbeats: generous under tier-1's load


class Node:
    """One full node stack; ``kind`` is "jax" or "port"."""

    def __init__(self, kind: str, name: str, cluster_port: int, seeds=()):
        jax = kind == "jax"
        self.kind = kind
        addr_cls = JaxAddress if jax else Address
        self.config = (JaxConfig if jax else Config)()
        self.config.port = "0"
        self.config.addr = addr_cls("127.0.0.1", str(cluster_port), name)
        self.config.seed_addrs = [addr_cls(*s) for s in seeds]
        self.config.heartbeat_time = TICK
        self.config.log = (JaxLog if jax else Log).create_none()
        self.system = (JaxSystem if jax else System)(self.config)
        identity = self.config.addr.hash64()
        if jax:
            self.database = JaxDatabase(identity=identity, system_repo=self.system.repo,
                                        engine="python")
        else:
            self.database = Database(identity, device="cpu", system_repo=self.system.repo)
        self.server = (JaxServer if jax else Server)(self.config, self.database)
        self.cluster = (JaxCluster if jax else Cluster)(self.config, self.database)
        self._started = []

    @property
    def addr(self) -> tuple[str, str, str]:
        a = self.config.addr
        return (a.host, a.port, a.name)

    async def start(self):
        await self.server.start()
        self._started.append(self.server)
        await self.cluster.start()
        self._started.append(self.cluster)

    async def restart_cluster(self):
        """A fresh Cluster on the same address and Database (a healed
        partition)."""
        cls = JaxCluster if self.kind == "jax" else Cluster
        self.cluster = cls(self.config, self.database)
        await self.cluster.start()

    async def stop(self):
        self.cluster.dispose()
        if self.server in self._started:
            await self.server.dispose()


def grab_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def start_node(kind: str, name: str, seeds=()) -> Node:
    """Build and start a node on a fresh ephemeral cluster port, rebuilding
    it on another port if the one picked was taken before it bound."""
    for attempt in range(8):
        node = Node(kind, name, grab_port(), seeds)
        try:
            await node.start()
            return node
        except OSError as e:
            await node.stop()
            if e.errno != errno.EADDRINUSE or attempt == 7:
                raise
    raise AssertionError("unreachable")


def arr(*parts) -> bytes:
    out = b"*%d\r\n" % len(parts)
    for p in parts:
        p = p if isinstance(p, bytes) else str(p).encode()
        out += b"$%d\r\n%s\r\n" % (len(p), p)
    return out


def _reply_end(buf: bytes, pos: int):
    """End offset of the one RESP reply starting at ``pos``, or None."""
    eol = buf.find(b"\r\n", pos)
    if eol < 0:
        return None
    kind, head = buf[pos:pos + 1], buf[pos + 1:eol]
    if kind in b"+-:":
        return eol + 2
    n = int(head)
    if kind == b"$":
        end = eol + 2 + max(n, 0) + (2 if n >= 0 else 0)
        return end if len(buf) >= end else None
    pos = eol + 2
    for _ in range(max(n, 0)):
        pos = _reply_end(buf, pos)
        if pos is None:
            return None
    return pos


async def call(port: int, cmds: list[list]) -> list[bytes]:
    """Pipeline ``cmds`` over one connection; one reply's bytes each."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(b"".join(arr(*c) for c in cmds))
        await writer.drain()
        buf, replies, pos = b"", [], 0
        while len(replies) < len(cmds):
            end = _reply_end(buf, pos)
            if end is None:
                chunk = await asyncio.wait_for(reader.read(1 << 16), 30)
                assert chunk, "connection closed early"
                buf += chunk
                continue
            replies.append(buf[pos:end])
            pos = end
        return replies
    finally:
        writer.close()


def vec(*xs) -> bytes:
    return np.asarray(xs, "<f4").tobytes()


def script(rng, side: int, n: int = 200) -> list[list]:
    """Writes to every type; ``side`` picks one node's share. Both sides
    write some keys in common, with different values and timestamps."""
    cmds = []
    for i in range(n):
        cmds.append(["GCOUNT", "INC", f"g{i}", int(rng.integers(1, 1000))])
        cmds.append(["PNCOUNT", "INC" if i % 3 else "DEC", f"p{i}", int(rng.integers(1, 99))])
        cmds.append(["TREG", "SET", f"r{i}", f"v{side}-{i}", int(rng.integers(0, 50))])
        cmds.append(["TLOG", "INS", f"l{i % (n // 2)}", f"e{side}-{i}", int(rng.integers(0, 90))])
    for i in range(n // 4):
        cmds.append(["UJSON", "SET", f"u{i}", "a", '{"x": %d, "s": "%d"}' % (i, side)])
        cmds.append(["UJSON", "INS", f"u{i}", "tags", f'"t{side}"'])
        mode = ("MAX", "LWW", "AVG")[i % 3]
        cmds.append(["TENSOR", "SET", f"t{i}", mode, int(rng.integers(1, 9)),
                     vec(*rng.integers(-9, 9, 4).astype(float))])
        cmds.append(["MAP", "TREG", "SET", f"m{i}", f"f{side}", f"x{i}", i])
        cmds.append(["MAP", "GCOUNT", "SET", f"m{i}", "n", int(rng.integers(1, 9))])
    for i in range(n // 10):
        cmds.append(["BCOUNT", "GRANT", f"b{i}", 20 + i])
        cmds.append(["BCOUNT", "INC", f"b{i}", 3])
    cmds.append(["TLOG", "TRIM", "l0", 2])
    return cmds


def reads(n: int = 200) -> list[list]:
    keys = range(0, n, 7)
    out = [["GCOUNT", "GET", f"g{i}"] for i in keys]
    out += [["PNCOUNT", "GET", f"p{i}"] for i in keys]
    out += [["TREG", "GET", f"r{i}"] for i in keys]
    out += [["TLOG", "GET", f"l{i}"] for i in range(0, n // 2, 7)]
    out += [["UJSON", "GET", f"u{i}"] for i in range(0, n // 4, 3)]
    out += [["TENSOR", "GET", f"t{i}"] for i in range(0, n // 4, 3)]
    out += [["MAP", "TREG", "GET", f"m{i}", "f0"] for i in range(0, n // 4, 3)]
    out += [["BCOUNT", "GET", f"b{i}"] for i in range(n // 10)]
    return out


def foreign_deltas(kind: str, n: int = 200) -> list[tuple[str, list]]:
    """Foreign replicas' deltas (values and timestamps >= 2^63) that no
    broadcast carries: a node holding them can pass them on only by sync."""
    big = 1 << 63
    return [
        ("GCOUNT", [(b"fg%d" % i, {7: big + i, 8: i + 1}) for i in range(n)]),
        ("PNCOUNT", [(b"fp%d" % i, ({7: big + i}, {9: i + 2})) for i in range(n)]),
        ("TREG", [(b"fr%d" % i, (b"w%d" % i, big + i)) for i in range(n)]),
        ("TLOG", [(b"fl%d" % i, ([(b"x", big + i), (b"y", i)], 0)) for i in range(n // 2)]),
    ]


async def converge_foreign(node: Node):
    for name, batch in foreign_deltas(node.kind):
        if node.kind == "jax":
            await node.database.converge_async((name, batch))
        else:
            await node.database.converge_async(name, batch)


async def digests(node: Node) -> tuple[bytes, bytes]:
    d, t = await call(node.server.port, [["SYSTEM", "DIGEST"], ["SYSTEM", "DIGEST", "TYPES"]])
    return d, t


async def wait_converged(*nodes: Node) -> tuple[bytes, bytes]:
    """Poll until every node gives the same SYSTEM DIGEST and SYSTEM
    DIGEST TYPES; fail at the deadline naming the differing types."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + DEADLINE_S
    while True:
        got = [await digests(n) for n in nodes]
        if all(g == got[0] for g in got):
            return got[0]
        if loop.time() > deadline:
            lines = [set(t.split(b"\r\n")) for _, t in got]
            diff = sorted(set.union(*lines) - set.intersection(*lines))
            pytest.fail(f"no convergence: differing lines {diff!r}")
        await asyncio.sleep(TICK)


async def wait_for(check, what: str):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + DEADLINE_S
    while not check():
        if loop.time() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        await asyncio.sleep(TICK)


def meshed(*nodes: Node) -> bool:
    return all(
        len(n.cluster._actives) == len(nodes) - 1
        and all(c.established for c in n.cluster._actives.values())
        for n in nodes
    )


def type_lines(types_reply: bytes) -> dict[str, bytes]:
    lines = [ln for ln in types_reply.split(b"\r\n") if ln and ln[:1] not in b"*$"]
    return {ln.split()[0].decode(): ln.split()[1] for ln in lines}


def assert_all_types_hold_data(types_reply: bytes):
    lines = type_lines(types_reply)
    assert list(lines) == list(SERVED_TYPES)
    assert all(v != b"0" * 64 for v in lines.values()), lines


async def stop_all(*nodes):
    for n in nodes:
        if n is not None:
            await n.stop()


def test_jax_and_port_nodes_converge_after_writes_at_both():
    """A JAX node and a port node, each written over RESP (every type,
    overlapping keys), reach one SYSTEM DIGEST and give equal GETs."""

    async def main():
        jax = port = None
        try:
            jax = await start_node("jax", "jax")
            port = await start_node("port", "port", seeds=[jax.addr])
            await wait_for(lambda: meshed(jax, port), "the mesh")
            rng = np.random.default_rng(10)
            for side, node in enumerate((jax, port)):
                replies = await call(node.server.port, script(rng, side))
                assert not any(r.startswith(b"-") and b"OUTOFBOUND" not in r for r in replies)
            _, types = await wait_converged(jax, port)
            assert_all_types_hold_data(types)
            want = await call(jax.server.port, reads())
            assert await call(port.server.port, reads()) == want
            assert sum(len(r) for r in want) > 3_000
            assert port.cluster.metrics_totals()["peers_established"] == 1
            # SYSTEM METRICS' CLUSTER section names the same counters. The
            # drop_<reason> / msg_drop_<reason> lines appear for the
            # reasons that occurred, and the port's liveness rule evicts
            # fewer connections as idle than JAX's (ROADMAP C4), so those
            # are held to the two packages' common reason vocabulary
            metrics = [(await call(n.server.port, [["SYSTEM", "METRICS"]]))[0]
                       for n in (jax, port)]
            names = [[ln.split()[1] for ln in m.split(b"\r\n") if ln.startswith(b"CLUSTER ")]
                     for m in metrics]
            fixed = [[n for n in ns if not n.startswith((b"drop_", b"msg_drop_"))]
                     for ns in names]
            assert fixed[0] == fixed[1] and b"peers_established" in fixed[0]
            from jylis_tpu.cluster import cluster as jax_cluster_mod
            from jylis_tpu_torch.cluster import cluster as cluster_mod

            def reasons(mod):
                return {b"drop_" + v.encode() for k, v in vars(mod.Drop).items()
                        if k.isupper()} | {b"msg_drop_" + v.encode()
                                           for k, v in vars(mod.MsgDrop).items() if k.isupper()}

            assert reasons(cluster_mod) == reasons(jax_cluster_mod)
            for ns, fx in zip(names, fixed):
                assert set(ns) - set(fx) <= reasons(cluster_mod)
        finally:
            await stop_all(port, jax)

    asyncio.run(main())


@pytest.mark.parametrize("loaded,joiner", [("jax", "port"), ("port", "jax")],
                         ids=["port_joins_jax", "jax_joins_port"])
def test_late_joiner_bootstrap_sync(loaded, joiner):
    """A node loaded alone (RESP writes with its held-delta queue capped,
    and foreign deltas no broadcast carries) is joined by an empty node of
    the other package: the digest-checked sync brings the joiner to the
    loaded node's SYSTEM DIGEST."""

    async def main():
        a = b = None
        try:
            a = await start_node(loaded, "loaded")
            a.cluster._held_cap = 1  # alone: local flushes are lost, not held
            rng = np.random.default_rng(11)
            await call(a.server.port, script(rng, 0))
            await converge_foreign(a)
            want = await digests(a)
            b = await start_node(joiner, "joiner", seeds=[a.addr])
            got = await wait_converged(a, b)
            assert got == want  # the joiner came up to the loaded node
            assert_all_types_hold_data(got[1])
            assert await call(b.server.port, reads()) == await call(a.server.port, reads())
            stats = b.cluster.metrics_totals()
            assert stats["sync_bytes_recv"] > 0 or stats["ranges_requested"] > 0, stats
        finally:
            await stop_all(b, a)

    asyncio.run(main())


def test_port_three_node_gcount_convergence():
    """bar and baz know only foo; each INCs one key (2 + 3 + 4): every
    node reads 9 (test_cluster.py's three-node test on port nodes)."""

    async def main():
        foo = bar = baz = None
        try:
            foo = await start_node("port", "foo")
            bar = await start_node("port", "bar", seeds=[foo.addr])
            baz = await start_node("port", "baz", seeds=[foo.addr])
            await wait_for(lambda: meshed(foo, bar, baz), "the full mesh via gossip")
            for node, amount in ((foo, 2), (bar, 3), (baz, 4)):
                assert await call(node.server.port, [["GCOUNT", "INC", "test", amount]]) \
                    == [b"+OK\r\n"]
            loop = asyncio.get_running_loop()
            deadline = loop.time() + DEADLINE_S
            while True:
                got = [(await call(n.server.port, [["GCOUNT", "GET", "test"]]))[0]
                       for n in (foo, bar, baz)]
                if got == [b":9\r\n"] * 3 or loop.time() > deadline:
                    break
                await asyncio.sleep(TICK)
            assert got == [b":9\r\n"] * 3
            await wait_converged(foo, bar, baz)
        finally:
            await stop_all(baz, bar, foo)

    asyncio.run(main())


def test_dropped_connection_heals_through_sync():
    """The port node's cluster goes away; both nodes take writes during the
    gap (the JAX node's held-delta queue capped, so its broadcasts are
    lost); a fresh cluster at the same address heals to one digest."""

    async def main():
        jax = port = None
        try:
            jax = await start_node("jax", "jax")
            port = await start_node("port", "port", seeds=[jax.addr])
            await wait_for(lambda: meshed(jax, port), "the mesh")
            rng = np.random.default_rng(12)
            await call(jax.server.port, script(rng, 0, n=40))
            await wait_converged(jax, port)
            port.cluster.dispose()
            await wait_for(lambda: not jax.cluster._passives and not any(
                c.established for c in jax.cluster._actives.values()), "the drop")
            jax.cluster._held_cap = 1
            await call(jax.server.port, script(rng, 1, n=80))
            await call(port.server.port, script(rng, 2, n=60))
            await converge_foreign(jax)
            await port.restart_cluster()
            _, types = await wait_converged(jax, port)
            assert_all_types_hold_data(types)
            assert await call(port.server.port, reads(80)) == await call(jax.server.port, reads(80))
            healed = [n.cluster.metrics_totals() for n in (jax, port)]
            assert any(s["sync_bytes_recv"] > 0 or s["ranges_requested"] > 0 for s in healed)
        finally:
            await stop_all(port, jax)

    asyncio.run(main())


def test_failpoint_armed_by_the_flag_drops_reads_and_the_node_heals():
    """A port node built by the entry point's wiring (main.build_node,
    main.serve) with ``--failpoints cluster.read=drop:40`` joins a loaded
    JAX node: it silently loses its first 40 reads (handshakes, gossip,
    sync frames), the point then disarms itself, and the node still comes
    to the JAX node's SYSTEM DIGEST. The JAX package's own failpoint
    registry stays unarmed."""
    from jylis_tpu import faults as jax_faults
    from jylis_tpu_torch import faults
    from jylis_tpu_torch.main import build_node, serve
    from jylis_tpu_torch.utils.config import config_from_cli

    async def main():
        jax = dispose = None
        faults.reset()
        try:
            jax = await start_node("jax", "jax")
            jax.cluster._held_cap = 1  # alone: local flushes are lost, not held
            await call(jax.server.port, script(np.random.default_rng(13), 0, n=60))
            await converge_foreign(jax)
            want = await digests(jax)
            for attempt in range(8):
                config = config_from_cli([
                    "-p", "0", "-a", f"127.0.0.1:{grab_port()}:port", "-s", ":".join(jax.addr),
                    "-T", str(TICK), "--device", "cpu", "-L", "error",
                    "--failpoints", "cluster.read=drop:40",
                ])
                node = build_node(config)
                assert faults.armed_points() == {"cluster.read": "drop"}
                try:
                    dispose = await serve(node)
                    break
                except OSError as e:
                    node.cluster.dispose()
                    await node.server.dispose()
                    faults.reset()
                    if e.errno != errno.EADDRINUSE or attempt == 7:
                        raise
            assert await wait_converged(jax, SimpleNamespace(server=node.server)) == want
            assert faults.hits("cluster.read") == 40 and faults.armed_points() == {}
            assert jax_faults.armed_points() == {}
            assert await call(node.server.port, reads(60)) == await call(jax.server.port, reads(60))
        finally:
            faults.reset()
            if dispose is not None:
                dispose.dispose()
                await dispose.done.wait()
            await stop_all(jax)

    asyncio.run(main())


def test_a_frame_waiting_on_a_repo_lock_keeps_its_connection_and_range_walk():
    """The port's liveness rule (ROADMAP C4): a port node whose read loop
    holds a range-sync frame while its GCOUNT lock stays taken for more
    than IDLE_TICKS_LIMIT heartbeat ticks (as a digest fold or a range
    dump of a large repo holds it) is not idle: neither node evicts a
    connection, and the bucket walk of the bootstrap sync finishes on
    the connection it started on, to equal digests."""
    from jylis_tpu_torch.cluster.cluster import IDLE_TICKS_LIMIT

    async def main():
        a = b = None
        held = {}
        try:
            a = await start_node("port", "loaded")
            await converge_foreign(a)
            b = await start_node("port", "joiner", seeds=[a.addr])
            mgr = b.database.manager("GCOUNT")
            converge = b.database.converge_async

            async def hold_lock():
                async with mgr._lock:
                    t0 = held["from"] = b.cluster._tick
                    while b.cluster._tick - t0 <= IDLE_TICKS_LIMIT + 5:
                        await asyncio.sleep(TICK)
                    held["ticks"] = b.cluster._tick - t0

            async def converge_behind_a_held_lock(name, batch):
                if name == "GCOUNT" and "task" not in held:
                    # the first GCOUNT range frame: its converge waits on
                    # the lock, which is held for longer than the limit
                    held["task"] = asyncio.ensure_future(hold_lock())
                    await asyncio.sleep(0)
                    held["conns"] = [c for c in b.cluster._actives.values()]
                await converge(name, batch)

            b.database.converge_async = converge_behind_a_held_lock
            await wait_converged(a, b)
            await held["task"]
            assert held["ticks"] > IDLE_TICKS_LIMIT
            for n in (a, b):
                totals = n.cluster.metrics_totals()
                assert totals.get("drop_idle", 0) == 0, totals
            # the walk finished on the connection it started on
            assert [c for c in b.cluster._actives.values()] == held["conns"]
            assert all(c.established for c in held["conns"])
            assert b.cluster.metrics_totals()["ranges_requested"] > 0
        finally:
            await stop_all(b, a)

    asyncio.run(main())


def test_signature_mismatch_drops_the_connection():
    """A peer presenting another schema signature is dropped before any
    message is exchanged."""

    async def main():
        node = None
        try:
            node = await start_node("port", "foo")
            reader, writer = await asyncio.open_connection("127.0.0.1", node.cluster.listen_port)
            writer.write(wire_frame(b"x" * 32))  # a valid frame, another schema
            await writer.drain()
            assert await asyncio.wait_for(reader.read(1 << 16), 10) == b""
            writer.close()
            await wait_for(lambda: not node.cluster._passives, "the passive drop")
            assert node.cluster.metrics_totals()["drop_handshake_mismatch"] == 1
        finally:
            await stop_all(node)

    asyncio.run(main())


def test_chip_smoke_cluster_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's cluster phase (a card node and a CPU node in their
    own processes) runs end to end with both nodes on the CPU at small
    sizes and a 0.1 s heartbeat: the bootstrap over the wire, the split
    script, whose TREG, TLOG and UJSON foreign batches reach H alone and
    only a range sync can bring to C, equal digests and GETs."""
    import chip_smoke as cs

    for name, value in (("DEVICE", "cpu"), ("NODE_KEYS", 3000), ("MESH_KEYS", 3000),
                        ("MESH_TLOG_KEYS", 200), ("MESH_UJ_FLAT", 64),
                        ("DIGEST_MAP_PAIRS", 800), ("DIGEST_BCOUNT_KEYS", 800),
                        ("CLUSTER_TENSOR_KEYS", 1100), ("CLUSTER_SAMPLE", 100),
                        ("CLUSTER_TICK", 0.1), ("CLUSTER_DEADLINE_S", DEADLINE_S)):
        monkeypatch.setattr(cs, name, value)
    out = cs.cluster_phase(torch, c_device="cpu")
    assert out["c"]["keys_recv"] >= 2 * 3000  # config 2 reached C over the wire
    assert out["c"]["sync_bytes_recv"] > 0 and out["h"]["frames_recv"]["MsgSeqPush"] > 0
    assert len(out["digest"]) == 64 and out["gets_checked"] > 1000
    assert out["h_only_deltas"] > 0 and out["both_deltas"] > 0
