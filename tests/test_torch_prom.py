"""The Prometheus endpoint in the port (jylis_tpu_torch/obs/prom.py)
against the JAX package's.

On the CPU: a port ``Database`` (both engines) and a JAX ``Database``
fed one seeded stream of commands of every type (GETs that drain, an
armed admission policy with refusals, sessions, SLO thresholds) render
the same exposition text once the histogram timings are masked: every
family, label, sample count and order, the commands served, the serving
split, the drain counters, the SESSION and OVERLOAD families and the
gauges. ``MetricsHTTP`` answers GET /metrics with the render and
anything else with a 404, byte for byte as the JAX responder does.
"""

import asyncio
import re

import numpy as np
import pytest
import torch

from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.obs import prom as jax_prom
from jylis_tpu.server.resp import Respond as JaxRespond
from jylis_tpu_torch.models.database import Database
from jylis_tpu_torch.obs import prom
from jylis_tpu_torch.server.resp import Respond

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

IDENTITY = 0x9A0


def stream(rng, n: int = 300) -> list[list]:
    cmds = []
    for i in range(n):
        k = f"k{int(rng.integers(0, 40))}"
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
            cmds.append(["UJSON", "SET", k, "a", str(i)])
        elif r < 0.6:
            cmds.append(["TENSOR", "SET", k, "LWW", i + 1, np.float32(i).tobytes()])
        elif r < 0.65:
            cmds.append(["MAP", "TREG", "SET", k, "f", f"x{i}", i])
        elif r < 0.7:
            cmds.append(["BCOUNT", "GRANT", k, 5])
        elif r < 0.8:
            cmds.append(["SESSION", "WRAP", "GCOUNT", "INC", k, 1])
        else:
            name = ("GCOUNT", "PNCOUNT", "TREG", "TLOG", "UJSON", "TENSOR")[int(rng.integers(0, 6))]
            cmds.append([name, "GET", k])
    return cmds


# the families whose values are wall-clock times: their samples keep
# their names, labels and order, and lose their numbers
_TIMED = re.compile(
    rb"^(jylis_seam_latency_seconds\{|jylis_seam_latency_seconds_sum\{|"
    rb"jylis_seam_latency_log2_seconds_bucket\{|jylis_seam_latency_log2_seconds_sum\{|"
    rb"jylis_overload\{key=\"ewma_us\"\}|jylis_gauge\{name=\"serving.queued_bytes\"\})")


def masked(text: str) -> list[bytes]:
    out = []
    for line in text.encode().split(b"\n"):
        if _TIMED.match(line):
            line = line.rsplit(b" ", 1)[0] + b" <t>"
        out.append(line)
    return out


async def feed(db, resp_cls, cmds) -> None:
    db.set_admission("control>read>write>bulk,lat=1000", 1 << 30)
    db.metrics.spans.set_slo_ms([10, 100])
    for cmd in cmds:
        out = bytearray()
        await db.apply_async(resp_cls(out.extend),
                             [a if isinstance(a, bytes) else str(a).encode() for a in cmd])
    # foreign deltas, then every repo drained: the drain families count
    foreign = [(b"k%d" % i, {0xF00 + i % 3: i + 1}) for i in range(64)]
    if isinstance(db, JaxDatabase):
        db.converge_deltas(("GCOUNT", foreign))
    else:
        db.converge("GCOUNT", foreign)
    db.drain_all()
    # admission outcomes as the server's gate records them
    for cls, seconds in (("read", 0.001), ("write", 0.002), ("bulk", 0.0)):
        assert db.admission.admit(cls) is None
        db.admission.done(cls, seconds)
    db.admission.admit("bulk", forced=True)


@pytest.mark.parametrize("engine", ["python", "auto"])
@pytest.mark.parametrize("seed", [31, 32])
def test_render_equals_jax_with_timings_masked(seed, engine):
    cmds = stream(np.random.default_rng(seed))
    port = Database(IDENTITY, device="cpu", engine=engine)
    jax = JaxDatabase(identity=IDENTITY, engine="python")
    asyncio.run(feed(port, Respond, cmds))
    asyncio.run(feed(jax, JaxRespond, cmds))
    got, want = masked(prom.render(port)), masked(jax_prom.render(jax))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    assert len(got) == len(want)
    text = b"\n".join(got)
    for family in (b"jylis_cmds_total{", b"jylis_drain_total{", b"jylis_session_total{",
                   b"jylis_overload_total{", b"jylis_converge_slo{", b"jylis_serving_total{"):
        assert family in text
    assert re.search(rb'jylis_overload_total\{kind="shed_bulk"\} 1', text)


async def fetch(port: int, request: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(request)
        await writer.drain()
        return await asyncio.wait_for(reader.read(), 30)
    finally:
        writer.close()


REQUESTS = (b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n",
            b"GET /metrics?x=1 HTTP/1.1\r\n\r\n",
            b"GET / HTTP/1.1\r\n\r\n", b"POST /metrics HTTP/1.1\r\n\r\n")


def test_metrics_http_serves_the_render_as_jax():
    async def drive(mod, db):
        http = mod.MetricsHTTP(db, 0)
        await http.start()
        try:
            return [await fetch(http.port, r) for r in REQUESTS]
        finally:
            await http.dispose()

    port_db = Database(IDENTITY, device="cpu", engine="python")
    jax_db = JaxDatabase(identity=IDENTITY, engine="python")
    cmds = stream(np.random.default_rng(33), 60)
    asyncio.run(feed(port_db, Respond, cmds))
    asyncio.run(feed(jax_db, JaxRespond, cmds))
    got = asyncio.run(drive(prom, port_db))
    want = asyncio.run(drive(jax_prom, jax_db))
    for g, w in zip(got, want):
        g_head, _, g_body = g.partition(b"\r\n\r\n")
        w_head, _, w_body = w.partition(b"\r\n\r\n")
        assert g_head.split(b"\r\n")[0] == w_head.split(b"\r\n")[0]
        assert masked(g_body.decode()) == masked(w_body.decode())
    assert got[0].startswith(b"HTTP/1.1 200 OK\r\n") and b"jylis_cmds_total" in got[0]
    assert got[2].startswith(b"HTTP/1.1 404") and got[3].startswith(b"HTTP/1.1 404")
