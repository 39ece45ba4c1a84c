"""The port's client (jylis_tpu_torch/client.py) against the JAX
package's, and against a port node and a JAX node.

On the CPU:

* ``pack_command`` of seeded arguments (str, bytes, int) gives the JAX
  bytes;
* the port's ``Client`` sends one seeded stream of commands of every
  type (errors, nested arrays, SESSION WRAP with an inner error, nil
  bulks) to a port node and to a JAX node, each alone: the decoded
  replies of ``execute_command`` and of ``pipeline_execute`` are equal,
  and equal to what the JAX ``Client`` decodes from the same node;
* ``ClusterClient`` drives its write / read / execute surface against
  each node alone with equal results; then against a cluster of a JAX
  node and a port node it writes, fails over when its node goes away
  and serves a session read with the full history at the survivor.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from jylis_tpu import client as jax_client
from jylis_tpu_torch import client, sessions

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

from test_torch_cluster import start_node  # noqa: E402


class Loop:
    """An event loop in a thread that hosts in-process nodes, so the
    blocking clients can talk to them from the test's thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()


@pytest.fixture(scope="module")
def loop():
    lp = Loop()
    yield lp
    lp.close()


def test_pack_command_equals_jax():
    rng = np.random.default_rng(41)
    for _ in range(200):
        args = []
        for _ in range(int(rng.integers(0, 6))):
            r = rng.random()
            if r < 0.3:
                args.append(int(rng.integers(-1 << 62, 1 << 62)))
            elif r < 0.6:
                args.append(bytes(rng.integers(0, 256, int(rng.integers(0, 20)), dtype=np.uint8)))
            else:
                args.append("s%dé" % int(rng.integers(0, 999)))
        assert client.pack_command(*args) == jax_client.pack_command(*args)


def stream(rng) -> list[list]:
    cmds = []
    for i in range(150):
        k = f"k{int(rng.integers(0, 25))}"
        r = rng.random()
        if r < 0.2:
            cmds.append(["GCOUNT", "INC", k, int(rng.integers(1, 1 << 40))])
        elif r < 0.3:
            cmds.append(["PNCOUNT", "DEC", k, int(rng.integers(1, 99))])
        elif r < 0.4:
            cmds.append(["TREG", "SET", k, f"v{i}", int(rng.integers(0, 99))])
        elif r < 0.5:
            cmds.append(["TLOG", "INS", k, f"e{i}", int(rng.integers(0, 99))])
        elif r < 0.55:
            cmds.append(["UJSON", "SET", k, "a", '{"n": %d}' % i])
        elif r < 0.6:
            cmds.append(["TENSOR", "SET", k, "MAX", 1, np.float32(i).tobytes()])
        elif r < 0.65:
            cmds.append(["SESSION", "WRAP", "GCOUNT", "GET"])  # an inner error
        elif r < 0.7:
            cmds.append(["GCOUNT", "NOPE", k])  # an error reply
        else:
            name = ("GCOUNT", "PNCOUNT", "TREG", "TLOG", "UJSON", "TENSOR")[int(rng.integers(0, 6))]
            cmds.append([name, "GET", k])
    return cmds


def norm(v):
    """A decoded reply with error objects as (type name, text): session
    tokens differ between nodes (their rids), so a WRAP's token becomes
    its length class."""
    if isinstance(v, list):
        return [norm(x) for x in v]
    if isinstance(v, Exception):
        return (type(v).__name__, str(v))
    return v


def drive_client(mod, port: int, cmds):
    c = mod.Client("127.0.0.1", port)
    try:
        one = []
        for cmd in cmds:
            try:
                one.append(c.execute_command(*cmd))
            except mod.ResponseError as e:
                one.append(e)
        piped = c.pipeline_execute(cmds)
    finally:
        c.close()
    return norm(one), norm(piped)


def without_tokens(replies, cmds):
    out = []
    for r, cmd in zip(replies, cmds):
        if cmd[0] == "SESSION" and isinstance(r, list):
            r = [r[0], sessions.decode_token(r[1]) != {}]
        out.append(r)
    return out


def test_client_replies_equal_on_a_port_node_and_a_jax_node(loop):
    cmds = stream(np.random.default_rng(42))
    got = {}
    for kind in ("port", "jax"):
        node = loop.run(start_node(kind, f"c{kind}"))
        try:
            port_side = drive_client(client, node.server.port, cmds)
            # the JAX client on the same node, after the same stream: the
            # repeated writes move on, so only the reads are compared
            jax_side = drive_client(jax_client, node.server.port,
                                    [c for c in cmds if c[1] == "GET"])
            got[kind] = (port_side, jax_side)
        finally:
            loop.run(node.stop())
    p, j = got["port"], got["jax"]
    assert without_tokens(p[0][0], cmds) == without_tokens(j[0][0], cmds)
    assert without_tokens(p[0][1], cmds) == without_tokens(j[0][1], cmds)
    assert p[1] == j[1]
    assert any(isinstance(r, tuple) and r[0] == "ResponseError" for r in p[0][0])


def test_cluster_client_surface_equal_on_a_port_node_and_a_jax_node(loop):
    got = {}
    for kind in ("port", "jax"):
        node = loop.run(start_node(kind, f"cc{kind}"))
        cc = client.ClusterClient([("127.0.0.1", node.server.port)], timeout=10,
                                  sleep_fn=lambda s: None)
        try:
            out = [cc.write("GCOUNT", "INC", "w", 3), cc.write("TREG", "SET", "r", "x", 5),
                   cc.read("GCOUNT", "GET", "w"), cc.execute("TREG", "GET", "r"),
                   cc.execute("PNCOUNT", "DEC", "p", 4), cc.read("PNCOUNT", "GET", "p")]
            with pytest.raises(client.ResponseError) as e:
                cc.write("GCOUNT", "GET")
            out.append(str(e.value))
            token = sessions.decode_token(cc.token)
            cc.token = b"\x00garbage"  # a BADTOKEN resets and retries bare
            out.append(cc.read("GCOUNT", "GET", "w"))
            out.append((cc.stats["badtoken_resets"], cc.stats["failovers"], len(token)))
            out.append(sorted(n["addr"].rsplit(":", 1)[1][:2] for n in cc.nodes.values()))
            got[kind] = out
        finally:
            cc.close()
            loop.run(node.stop())
    assert got["port"] == got["jax"]
    assert got["port"][2] == 3 and got["port"][5] == -4


def test_cluster_client_fails_over_between_a_jax_node_and_a_port_node(loop):
    a = loop.run(start_node("jax", "fa"))
    b = loop.run(start_node("port", "fb", seeds=[a.addr]))
    stopped = []
    cc = client.ClusterClient([("127.0.0.1", a.server.port), ("127.0.0.1", b.server.port)],
                              timeout=10, max_retries=40, backoff_cap_ms=200)
    try:
        assert cc.write("GCOUNT", "INC", "fk", 3) == b"OK"
        before = sessions.decode_token(cc.token)
        victim, survivor = (a, b) if cc._ep[1] == a.server.port else (b, a)
        probe = client.Client("127.0.0.1", survivor.server.port)
        deadline = time.time() + 60
        while probe.execute_command("GCOUNT", "GET", "fk") != 3:
            assert time.time() < deadline, "the write never reached the survivor"
            time.sleep(0.05)
        probe.close()
        loop.run(victim.stop())
        stopped.append(victim)
        assert cc.write("GCOUNT", "INC", "fk", 4) == b"OK"
        assert cc.stats["failovers"] >= 1 and cc.stats["last_mttr_s"] > 0
        assert sessions.dominates(sessions.decode_token(cc.token), before)
        assert cc.read("GCOUNT", "GET", "fk") == 7
    finally:
        cc.close()
        for n in (a, b):
            if n not in stopped:
                loop.run(n.stop())
