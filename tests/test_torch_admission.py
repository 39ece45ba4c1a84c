"""Overload armor in the port (jylis_tpu_torch/admission.py and the
server's gate) against the JAX package.

At tolerance 0, on the CPU:

* ``classify`` of a seeded stream of commands over every type, SESSION
  WRAP / READ nested up to the unwrap bound, SYSTEM and unknown words;
* ``parse_policy`` of valid and invalid specs (the same dicts, the same
  error messages) and ``busy_reply``;
* ``AdmissionController`` under a scripted clock: a seeded stream of
  admissions, completions with latencies that cross the entry, exit and
  severe thresholds, idle gaps, forced sheds and slow-consumer byte
  accounting gives the same decisions, hints, states and OVERLOAD
  totals, and the same registry gauges;
* ``gate`` with the ``admission.shed`` failpoint armed in each
  package's own registry;
* a port Server and a JAX Server with an admission policy, the failpoint
  armed with a budget, and one seeded command stream over a socket give
  the same reply bytes (BUSY refusals with their class and hint fields
  included) and the same OVERLOAD section.
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jylis_tpu import admission as jax_admission
from jylis_tpu import faults as jax_faults
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.obs.registry import MetricsRegistry as JaxRegistry
from jylis_tpu.server.server import Server as JaxServer
from jylis_tpu.utils.config import Config as JaxConfig
from jylis_tpu.utils.log import Log as JaxLog
from jylis_tpu_torch import admission, faults
from jylis_tpu_torch.models.database import Database
from jylis_tpu_torch.obs.registry import MetricsRegistry
from jylis_tpu_torch.server.server import Server
from jylis_tpu_torch.utils.config import Config
from jylis_tpu_torch.utils.log import Log

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

from test_torch_cluster import call  # noqa: E402

SEEDS = [21, 22, 23]
TYPES = {
    b"GCOUNT": (b"GET", b"INC"), b"PNCOUNT": (b"GET", b"INC", b"DEC"),
    b"TREG": (b"GET", b"SET"), b"TLOG": (b"GET", b"INS", b"SIZE", b"CUTOFF", b"TRIM",
                                          b"TRIMAT"),
    b"UJSON": (b"GET", b"SET", b"INS", b"RM", b"CLR"), b"TENSOR": (b"GET", b"SET", b"MRG"),
    b"MAP": (b"KEYS", b"TREG", b"GCOUNT"), b"BCOUNT": (b"GET", b"GRANT", b"INC", b"TRANSFER"),
    b"SYSTEM": (b"METRICS", b"DIGEST", b"GETLOG"), b"NOPE": (b"X",),
}


def rand_cmd(rng, depth: int = 0) -> list[bytes]:
    r = rng.random()
    if depth < 6 and r < 0.15:
        return [b"SESSION", b"WRAP"] + rand_cmd(rng, depth + 1)
    if depth < 6 and r < 0.25:
        return [b"SESSION", b"READ", b"tok"] + rand_cmd(rng, depth + 1)
    if r < 0.28:
        return [[b"SESSION"], [b"SESSION", b"TOKEN"], [b"SESSION", b"READ", b"t"], []][
            int(rng.integers(0, 4))]
    name = list(TYPES)[int(rng.integers(0, len(TYPES)))]
    ops = TYPES[name]
    cmd = [name]
    if rng.random() < 0.9:
        cmd.append(ops[int(rng.integers(0, len(ops)))])
        cmd += [b"k", b"1"][: int(rng.integers(0, 3))]
    return cmd


@pytest.mark.parametrize("seed", SEEDS)
def test_classify_equals_jax(seed):
    rng = np.random.default_rng(seed)
    seen = set()
    for _ in range(3000):
        cmd = rand_cmd(rng)
        got = admission.classify(cmd)
        assert got == jax_admission.classify(cmd), cmd
        seen.add(got)
    assert seen == set(admission.CLASSES)


SPECS = [
    "", "control>read>write>bulk", "bulk>write>read>control,lat=5,depth=3,protect=1",
    "READ>Control>bulk>write,protect=3", "control>read>write>bulk,lat=0.5",
    "control>read>write", "control>read>write>bulk>read", "control>read>write>nope",
    "control>read>write>bulk,lat", "control>read>write>bulk,lat=x", "control>read>write>bulk,foo=1",
    "control>read>write>bulk,protect=0", "control>read>write>bulk,protect=4",
    "control>read>write>bulk,depth=1.5", " control > read > write > bulk , lat=7 ",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_policy_equals_jax(spec):
    def parse(mod):
        try:
            return ("ok", mod.parse_policy(spec))
        except mod.PolicySpecError as e:
            return ("err", str(e))

    assert parse(admission) == parse(jax_admission)
    for cls in admission.CLASSES:
        for hint in (25, 1000):
            assert admission.busy_reply(cls, hint, "why") == \
                jax_admission.busy_reply(cls, hint, "why")


class Clock:
    """A scripted perf_counter, shared by both packages' controllers."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self) -> float:
        return self.t


def controller_ops(rng, n: int = 4000):
    ops = []
    for _ in range(n):
        r = rng.random()
        cls = admission.CLASSES[int(rng.integers(0, 4))]
        if r < 0.5:
            ops.append(("admit", cls, bool(rng.random() < 0.05)))
        elif r < 0.85:
            # latencies around the entry (lat=8), exit and severe bounds
            ms = float(rng.choice([0.0, 0.5, 3.0, 9.0, 40.0, 200.0]))
            ops.append(("done", cls, ms / 1e3))
        elif r < 0.93:
            ops.append(("tick", float(rng.choice([0.001, 0.05, 0.6, 1.5]))))
        elif r < 0.98:
            ops.append(("queued", int(rng.integers(0, 5)), int(rng.integers(0, 3000))))
        else:
            ops.append(("drop", int(rng.integers(0, 5))))
    return ops


@pytest.mark.parametrize("policy", ["control>read>write>bulk,lat=8,depth=6",
                                    "bulk>write>read>control,lat=8,protect=1", ""])
@pytest.mark.parametrize("seed", SEEDS)
def test_controller_decisions_equal_jax_under_a_scripted_clock(seed, policy, monkeypatch):
    clock = Clock()
    fake = SimpleNamespace(perf_counter=clock.perf_counter)
    monkeypatch.setattr(admission, "time", fake)
    monkeypatch.setattr(jax_admission, "time", fake)
    reg, jreg = MetricsRegistry(), JaxRegistry()
    port = admission.AdmissionController(policy, 4096, registry=reg)
    jax = jax_admission.AdmissionController(policy, 4096, registry=jreg)
    refused = 0
    for op in controller_ops(np.random.default_rng(seed)):
        kind = op[0]
        if kind == "tick":
            clock.t += op[1]
            continue
        if kind == "admit":
            got, want = port.admit(op[1], forced=op[2]), jax.admit(op[1], forced=op[2])
            refused += got is not None
        elif kind == "done":
            got, want = port.done(op[1], op[2]), jax.done(op[1], op[2])
        elif kind == "queued":
            got, want = port.note_conn_queued(op[1], op[2]), jax.note_conn_queued(op[1], op[2])
        else:
            got, want = port.drop_conn(op[1]), jax.drop_conn(op[1])
        assert got == want, op
        assert port.metrics_totals() == jax.metrics_totals(), op
        assert (port.overloaded, port.severe) == (jax.overloaded, jax.severe)
        clock.t += 0.0002
    assert reg.gauges == jreg.gauges
    assert [e[1:] for e in reg.trace.dump()] == [e[1:] for e in jreg.trace.dump()]
    assert refused > 0


def test_gate_consults_each_package_failpoint():
    async def drive(mod, fmod):
        adm = mod.AdmissionController("control>read>write>bulk")
        fmod.reset()
        try:
            fmod.arm("admission.shed", "error", budget=3)
            out = [await mod.gate(adm, cls) for cls in ("write", "control", "bulk", "read")]
        finally:
            fmod.reset()
        return out, adm.metrics_totals()

    port = asyncio.run(drive(admission, faults))
    jax = asyncio.run(drive(jax_admission, jax_faults))
    assert port == jax
    assert port[0][1] is None and port[0][3] is None  # control immune; budget spent
    assert isinstance(port[0][0], int) and isinstance(port[0][2], int)


def server_stream(rng, n: int = 400) -> list[list]:
    cmds = []
    for i in range(n):
        k = f"k{int(rng.integers(0, 30))}"
        r = rng.random()
        if r < 0.2:
            cmds.append(["GCOUNT", "INC", k, int(rng.integers(1, 99))])
        elif r < 0.3:
            cmds.append(["GCOUNT", "GET", k])
        elif r < 0.4:
            cmds.append(["TREG", "SET", k, f"v{i}", i])
        elif r < 0.5:
            cmds.append(["TENSOR", "SET", k, "MAX", 1, np.float32(i).tobytes()])
        elif r < 0.6:
            cmds.append(["TENSOR", "GET", k])
        elif r < 0.7:
            cmds.append(["BCOUNT", "GRANT", k, 9])
        elif r < 0.75:
            cmds.append(["SYSTEM", "GETLOG", 0])
        elif r < 0.85:
            cmds.append(["SESSION", "WRAP", "MAP", "GCOUNT", "SET", k, "f", 2])
        else:
            cmds.append(["UJSON", "SET", k, "a", str(i)])
    return cmds


def types_without_engine(cmds):
    """The commands the port's native engine does not settle (every
    command then passes the Python-path gate in both packages)."""
    return [c for c in cmds if c[0] in ("TENSOR", "BCOUNT", "SYSTEM", "SESSION", "MAP")]


async def serve_stream(kind: str, engine: str, cmds) -> tuple[list[bytes], list[bytes]]:
    jax = kind == "jax"
    cfg = (JaxConfig if jax else Config)()
    cfg.port = "0"
    cfg.log = (JaxLog if jax else Log).create_none()
    if jax:
        db = JaxDatabase(identity=7, engine="python")
    else:
        db = Database(7, device="cpu", engine=engine)
    db.set_admission("control>read>write>bulk,lat=1000", 1 << 30)
    server = (JaxServer if jax else Server)(cfg, db)
    await server.start()
    fmod = jax_faults if jax else faults
    fmod.reset()
    try:
        fmod.arm("admission.shed", "error", budget=len(cmds) // 3)
        replies = []
        for i in range(0, len(cmds), 50):
            replies += await call(server.port, cmds[i:i + 50])
    finally:
        fmod.reset()
        await server.dispose()
    out = bytearray()
    await db.apply_async(_respond(kind)(out.extend),
                         [b"SYSTEM", b"METRICS"])
    # every OVERLOAD line but the latency EWMA, which is wall-clock time
    overload = [ln for ln in bytes(out).split(b"\r\n")
                if ln.startswith(b"OVERLOAD ") and not ln.startswith(b"OVERLOAD ewma_us ")]
    return replies, overload


def _respond(kind: str):
    from jylis_tpu.server.resp import Respond as JaxRespond
    from jylis_tpu_torch.server.resp import Respond

    return JaxRespond if kind == "jax" else Respond


@pytest.mark.parametrize("engine", ["python", "auto"])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_server_gate_replies_equal_jax(seed, engine):
    cmds = server_stream(np.random.default_rng(seed))
    if engine == "auto":
        cmds = types_without_engine(cmds)
    port = asyncio.run(serve_stream("port", engine, cmds))
    jax = asyncio.run(serve_stream("jax", engine, cmds))
    for i, (got, want) in enumerate(zip(port[0], jax[0])):
        assert got == want, (i, cmds[i])
    assert len(port[0]) == len(jax[0]) == len(cmds)
    busy = [r for r in port[0] if r.startswith(b"-BUSY")]
    assert busy and all(b"class=" in r and b"retry-after-ms=" in r for r in busy)
    assert port[1] == jax[1]
    shed = sum(int(ln.split()[2]) for ln in port[1] if ln.startswith(b"OVERLOAD shed_"))
    assert shed == len(busy)
