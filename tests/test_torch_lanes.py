"""Multi-lane serving in the port (jylis_tpu_torch/lanes.py and the lane
branches of main.py) against the JAX package.

On the CPU:

* the lane functions: ``lane_of``, ``lane_identity``, ``bus_address``,
  ``bus_config``, ``resolve_auto_lanes``, ``aggregate_expositions`` and
  ``_parse_lane_failpoints`` equal the JAX package's on seeded inputs;
  ``Supervisor._child_argv`` differs from the JAX supervisor's only by
  the module it runs and the ``--device`` it passes on, and the
  manifest ``lanes.json`` is the same document;
* the flags: the option strings of ``python -m jylis_tpu_torch`` are the
  JAX package's plus ``--device``, with the same defaults;
* a real ``--lanes 2 --device cpu`` node (a supervisor process and two
  lane workers): writes land on both lanes, each is read back at the
  other, both lanes' SYSTEM DIGEST equal that of two JAX Databases (one
  per lane identity) fed each lane's commands and joined; the
  supervisor's aggregated Prometheus endpoint carries both lanes; a
  SIGKILLed lane is respawned under a new pid, replays its own journal
  segment, rejoins the bus and the digests are equal again;
* a lane asked for ``--device cuda`` on a host without a card exits
  non-zero: no lane falls back to the CPU.
"""

import argparse
import asyncio
import json
import os
import re
import signal
import subprocess
import socket
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from jylis_tpu import lanes as jax_lanes
from jylis_tpu.models.database import Database as JaxDatabase
from jylis_tpu.server.resp import Respond as JaxRespond
from jylis_tpu.utils import config as jax_config
from jylis_tpu.utils.address import Address as JaxAddress
from jylis_tpu.utils.log import Log as JaxLog
from jylis_tpu_torch import lanes
from jylis_tpu_torch.client import Client
from jylis_tpu_torch.utils import config
from jylis_tpu_torch.utils.address import Address
from jylis_tpu_torch.utils.log import Log
from jylis_tpu_torch.utils.net import free_port

torch.set_num_threads(1)  # tier-1 shares the cores among its pytest workers
from torch_cpu_share import yield_cpu  # noqa: E402,F401 (autouse: yields the cores)
from jax_python_paths import jax_python_paths  # noqa: E402,F401 (autouse: no JAX native build)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configs(n_lanes: int, name: str = "lanes", cport: str = "9101"):
    """A port Config and a JAX Config with the same fields."""
    out = []
    for mod, addr_cls, log_cls in ((config, Address, Log), (jax_config, JaxAddress, JaxLog)):
        cfg = mod.Config()
        cfg.port = "7001"
        cfg.addr = addr_cls("127.0.0.1", cport, name)
        cfg.lanes = n_lanes
        cfg.lane_bus = [40000 + i for i in range(n_lanes)]
        cfg.lane_bus_heartbeat = 0.1
        cfg.data_dir = "/d"
        cfg.trace_sample = 3
        cfg.dial_timeout = 2.5
        cfg.log = log_cls.create_none()
        out.append(cfg)
    return out


def test_lane_functions_equal_jax():
    rng = np.random.default_rng(51)
    for _ in range(500):
        key = bytes(rng.integers(0, 256, int(rng.integers(0, 24)), dtype=np.uint8))
        n = int(rng.integers(1, 9))
        assert lanes.lane_of(key, n) == jax_lanes.lane_of(key, n)
    for cpus in (None, 1, 3, 4, 7, 8, 64):
        assert config.resolve_auto_lanes(cpus) == jax_config.resolve_auto_lanes(cpus)
    for n in (2, 3, 8):
        cfg, jcfg = configs(n, name=f"n{n}")
        for k in range(n):
            assert lanes.lane_identity(cfg, k) == jax_lanes.lane_identity(jcfg, k)
            assert str(lanes.bus_address(cfg, k)) == str(jax_lanes.bus_address(jcfg, k))
            b, jb = lanes.bus_config(cfg, k), jax_lanes.bus_config(jcfg, k)
            for field in ("port", "heartbeat_time", "system_log_trim", "dial_timeout",
                          "dial_backoff_cap", "data_dir", "trace_sample"):
                assert getattr(b, field) == getattr(jb, field), field
            assert str(b.addr) == str(jb.addr)
            assert [str(s) for s in b.seed_addrs] == [str(s) for s in jb.seed_addrs]
        assert len({lanes.lane_identity(cfg, k) for k in range(n)}) == n


def without_spans(lines):
    """SYSTEM METRICS lines (str, or a RESP array reply's bytes) without
    the port's SPAN section, which a JAX node lacks."""
    if isinstance(lines, bytes):  # *N, then $len and the line, each
        lines = lines.split(b"\r\n")[2::2]
        return [ln for ln in lines if not ln.startswith(b"SPAN ")]
    return [ln for ln in lines if not ln.startswith("SPAN ")]


def test_lane_section_of_system_metrics_equals_jax():
    """A lane's SYSTEM METRICS leads with the LANE section, byte for byte
    as a JAX lane's; a node that is no lane has none. Every line but the
    port's SPAN section is compared."""
    from jylis_tpu.obs.registry import MetricsRegistry as JaxRegistry
    from jylis_tpu.utils import metrics as jax_metrics
    from jylis_tpu_torch.models.database import Database
    from jylis_tpu_torch.obs.registry import MetricsRegistry
    from jylis_tpu_torch.server.resp import Respond
    from jylis_tpu_torch.utils import metrics

    for lane in ({"id": 0, "count": 2}, {"id": 3, "count": 8}, None):
        # fresh registries: the process-wide default holds other tests' drains
        assert without_spans(metrics.metric_lines(lane=lane, registry=MetricsRegistry())) == \
            jax_metrics.metric_lines(lane=lane, registry=JaxRegistry())
    outs = []
    for db, resp_cls in ((Database(5, device="cpu", engine="python"), Respond),
                         (JaxDatabase(identity=5, engine="python"), JaxRespond)):
        db.system.lane_fn = lambda: {"id": 1, "count": 2}
        out = bytearray()
        db.apply(resp_cls(out.extend), [b"SYSTEM", b"METRICS"])
        outs.append(bytes(out))
    assert without_spans(outs[0]) == without_spans(outs[1])
    assert b"\r\nSPAN gc.full items 0" in outs[0] and b"SPAN " not in outs[1]
    assert outs[0].startswith(b"*") and b"LANE id 1\r\n$12\r\nLANE count 2" in outs[0]


def test_parse_lane_failpoints_equals_jax():
    for spec in ("", "junk", "1:lane.tick=crash:1;0:x=error", "a:b;2:c=d;;3:",
                 " 1 : admission.shed=error ; 0:lane.tick=sleep:0.1:2"):
        assert lanes._parse_lane_failpoints(spec) == jax_lanes._parse_lane_failpoints(spec)


def exposition(rng, lane: int) -> str:
    lines = ["# HELP jylis_cmds_total Commands served per data type.",
             "# TYPE jylis_cmds_total counter"]
    for t in ("GCOUNT", "TREG"):
        lines.append(f'jylis_cmds_total{{type="{t}"}} {int(rng.integers(0, 1000))}')
    lines += [f'jylis_gauge{{name="cluster.backlog_ms"}} {rng.random() * 9:.3f}',
              f'jylis_seam_latency_seconds_count{{seam="server.py_dispatch"}} {lane + 4}',
              f'jylis_seam_latency_seconds_sum{{seam="server.py_dispatch"}} {rng.random():.9f}',
              f'jylis_seam_latency_log2_seconds_bucket{{seam="x",le="+Inf"}} {lane * 3}',
              f'jylis_converge_slo_total{{kind="sampled"}} {10 + lane}',
              f'jylis_converge_slo_total{{kind="ok_50"}} {5 + lane}',
              f'jylis_converge_slo{{le="50"}} {rng.random():.6f}',
              "not a sample line", "", f"jylis_trace_events {lane}"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", [52, 53])
def test_aggregate_expositions_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 4):
        bodies = {k: (None if rng.random() < 0.25 else exposition(rng, k)) for k in range(n)}
        assert lanes.aggregate_expositions(bodies) == jax_lanes.aggregate_expositions(bodies)


def test_child_argv_differs_from_jax_only_by_device(tmp_path):
    async def argvs():
        cfg, jcfg = configs(2)
        for c in (cfg, jcfg):
            c.port = "0"
            c.data_dir = str(tmp_path / ("port" if c is cfg else "jax"))
            c.metrics_port = 0
        cfg.device = "cuda:0"
        argv = ["--port", "0", "--lanes", "2", "--addr", "127.0.0.1:9101:lanes"]
        sup, jsup = lanes.Supervisor(cfg, argv), jax_lanes.Supervisor(jcfg, argv)
        # the same resolved ports on both, so the argv compare is exact
        jsup.resp_port, jsup.bus_ports = sup.resp_port, sup.bus_ports
        out = [(sup._child_argv(k), jsup._child_argv(k)) for k in range(2)]
        for s in (sup, jsup):
            os.makedirs(s.config.data_dir)
            s.write_manifest()
        return out, sup, jsup

    out, sup, jsup = asyncio.run(argvs())
    for k, (got, want) in enumerate(out):
        assert got[:3] == [sys.executable, "-m", "jylis_tpu_torch"]
        assert want[:3] == [sys.executable, "-m", "jylis_tpu"]
        assert got[-2:] == ["--device", "cuda:0"]
        assert got[3:-2] == want[3:]
        assert got[got.index("--lane-id") + 1] == str(k)
    docs = [json.load(open(os.path.join(s.config.data_dir, lanes.MANIFEST_NAME)))
            for s in (sup, jsup)]
    assert docs[0] == docs[1]
    assert lanes.MANIFEST_NAME == jax_lanes.MANIFEST_NAME
    assert (lanes.RESTART_BACKOFF_S, lanes.RESTART_BACKOFF_CAP_S) == \
        (jax_lanes.RESTART_BACKOFF_S, jax_lanes.RESTART_BACKOFF_CAP_S)


def test_supervisor_ports_lie_below_the_ephemeral_range():
    """The bus and metrics ports the supervisor hands its lanes, which a
    respawned lane binds again, lie below the host's ephemeral range
    (the JAX package's free_port takes them from it), so while a lane is
    down no outgoing connection can be given its port; each is free."""
    from jylis_tpu_torch.utils import net

    cfg, _ = configs(2)
    cfg.port, cfg.metrics_port = "0", 9100
    sup = lanes.Supervisor(cfg, [])
    low = net._ephemeral_low()
    ports = [*sup.bus_ports, *sup.metrics_ports]
    assert len(set(ports)) == 4
    for port in ports:
        assert 1024 <= port < low
        with socket.socket() as s:
            s.bind(("0.0.0.0", port))


def parser_of(mod) -> argparse.ArgumentParser:
    """The ArgumentParser a package's config_from_cli builds."""
    seen = []
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen.append(self)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            mod.config_from_cli([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen[0]


def test_flags_equal_jax_plus_device():
    def options(parser):
        return {opt: (a.default, a.type, a.nargs, type(a).__name__)
                for a in parser._actions for opt in a.option_strings}

    port, jax = options(parser_of(config)), options(parser_of(jax_config))
    assert set(port) == set(jax) | {"--device"}
    for opt, spec in jax.items():
        if opt != "--version":
            assert port[opt] == spec, opt
    assert port["--device"][0] == "cuda"
    # --admission-policy is validated at parse time, --lanes takes auto
    with pytest.raises(SystemExit):
        config.config_from_cli(["--admission-policy", "control>read"])
    cfg = config.config_from_cli(["--lanes", "auto", "--admission-policy",
                                  "bulk>write>read>control,lat=3"])
    assert cfg.lanes == config.resolve_auto_lanes()
    assert cfg.admission_policy == "bulk>write>read>control,lat=3"


# ---- a real --lanes 2 node on the CPU --------------------------------------


def lane_of_conn(c: Client) -> int:
    for line in c.execute_command("SYSTEM", "METRICS"):
        if line.startswith(b"LANE id "):
            return int(line.split()[2])
    raise AssertionError("no LANE section")


def connect(port: int, deadline_s: float = 120.0) -> Client:
    deadline = time.time() + deadline_s
    while True:
        try:
            return Client("127.0.0.1", port, timeout=60)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)


def lane_clients(port: int, n_lanes: int = 2) -> dict[int, Client]:
    """One connection per lane: the kernel shares new connections among
    the lanes; each learns its lane from SYSTEM METRICS."""
    out, spare = {}, []
    deadline = time.time() + 120
    while len(out) < n_lanes:
        assert time.time() < deadline, f"only lanes {sorted(out)} answered"
        c = connect(port)
        lane = lane_of_conn(c)
        if lane in out:
            spare.append(c)
        else:
            out[lane] = c
    for c in spare:
        c.close()
    return out


def lane_script(rng, lane: int, n: int = 60) -> list[list]:
    """Monotone writes only (their effect does not depend on what the
    lane has seen of the other lane), of every type."""
    cmds = []
    for i in range(n):
        k = f"k{int(rng.integers(0, 40))}"
        r = rng.random()
        if r < 0.25:
            cmds.append(["GCOUNT", "INC", k, int(rng.integers(1, 1 << 62))])
        elif r < 0.4:
            cmds.append(["PNCOUNT", "DEC" if i % 2 else "INC", k, int(rng.integers(1, 999))])
        elif r < 0.55:
            cmds.append(["TREG", "SET", k, f"v{lane}-{i}", int(rng.integers(0, 1 << 40))])
        elif r < 0.7:
            cmds.append(["TLOG", "INS", k, f"e{lane}-{i}", int(rng.integers(0, 1 << 40))])
        elif r < 0.8:
            cmds.append(["UJSON", "INS", k, "tags", f'"t{lane}-{i}"'])
        elif r < 0.9:
            cmds.append(["TENSOR", "SET", k, "MAX", 1, np.float32(rng.random()).tobytes()])
        else:
            cmds.append(["BCOUNT", "GRANT", k, int(rng.integers(1, 99))])
    return cmds


def reference_digest(addr: tuple, scripts: dict[int, list]) -> str:
    """Two JAX Databases, one per lane identity, each fed its lane's
    commands, then joined both ways: the digest the lanes converge to."""
    jcfg = jax_config.Config()
    jcfg.addr = JaxAddress(*addr)
    dbs = {k: JaxDatabase(identity=jax_lanes.lane_identity(jcfg, k), engine="python")
           for k in scripts}
    for k, cmds in scripts.items():
        for cmd in cmds:
            out = bytearray()
            dbs[k].apply(JaxRespond(out.extend),
                         [a if isinstance(a, bytes) else str(a).encode() for a in cmd])
            assert not out.startswith(b"-"), (cmd, bytes(out))
    dbs[0].flush_deltas(dbs[1].converge_deltas)
    dbs[1].flush_deltas(dbs[0].converge_deltas)
    d0, d1 = (dbs[k]._sync_digest_blocking().hex().encode() for k in (0, 1))
    assert d0 == d1
    return d0


def wait_digests(clients: dict[int, Client], want: bytes, deadline_s: float = 60.0) -> None:
    deadline = time.time() + deadline_s
    while True:
        got = {k: c.execute_command("SYSTEM", "DIGEST") for k, c in clients.items()}
        if all(g == want for g in got.values()):
            return
        assert time.time() < deadline, f"lanes {got} never reached {want}"
        time.sleep(0.1)


def read_manifest(data_dir) -> dict:
    with open(os.path.join(data_dir, "lanes.json"), encoding="utf-8") as f:
        return json.load(f)


def test_two_lane_node_converges_to_jax_and_heals_a_killed_lane(tmp_path):
    port, cport, mport = free_port(), free_port(), free_port()
    addr = ("127.0.0.1", str(cport), "lanes")
    data = tmp_path / "d"
    log = open(tmp_path / "node.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jylis_tpu_torch", "--device", "cpu", "--port", str(port),
         "--addr", ":".join(addr), "--lanes", "2", "--data-dir", str(data),
         "--metrics-port", str(mport), "--heartbeat-time", "0.2",
         "--lane-bus-heartbeat", "0.1"],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
    )
    clients = {}
    try:
        clients = lane_clients(port)
        pids = [lane["pid"] for lane in read_manifest(data)["lanes"]]
        rng = np.random.default_rng(54)
        scripts = {k: lane_script(rng, k) for k in (0, 1)}
        for k, cmds in scripts.items():
            replies = clients[k].pipeline_execute(cmds)
            assert all(r == b"OK" for r in replies), replies
        want = reference_digest(addr, scripts)
        wait_digests(clients, want)
        # every GCOUNT key read back at the lane that did not write it
        totals = {}
        for k, cmds in scripts.items():
            for c in cmds:
                if c[0] == "GCOUNT":
                    totals[c[2]] = (totals.get(c[2], 0) + c[3]) & ((1 << 64) - 1)
        for key, total in totals.items():
            assert all(clients[k].execute_command("GCOUNT", "GET", key) == total
                       for k in (0, 1))
        body = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=30).read()
        assert b'lane="0"' in body and b'lane="1"' in body
        assert b'jylis_lane_up{lane="1"} 1' in body
        # SIGKILL lane 1: the supervisor writes a new pid, the lane
        # replays its own segment and rejoins the bus
        assert read_manifest(data)["lanes"][1]["pid"] == pids[1]  # no restart before
        os.kill(pids[1], signal.SIGKILL)
        clients.pop(1).close()
        deadline = time.time() + 60
        while read_manifest(data)["lanes"][1]["pid"] in (pids[1], None):
            assert time.time() < deadline, "lane 1 was never respawned"
            time.sleep(0.2)
        assert os.path.exists(data / "journal.lane1.jylis")
        more = {0: lane_script(rng, 0, 20), 1: []}
        assert all(r == b"OK" for r in clients[0].pipeline_execute(more[0]))
        clients = lane_clients(port) | {0: clients[0]}
        want = reference_digest(addr, {k: scripts[k] + more[k] for k in (0, 1)})
        wait_digests(clients, want)
        assert read_manifest(data)["lanes"][0]["pid"] == pids[0]
        # the respawned lane replayed its own journal segment
        replayed = [ln for ln in clients[1].execute_command("SYSTEM", "METRICS")
                    if ln.startswith(b"JOURNAL replayed_batches ")]
        assert replayed and int(replayed[0].split()[2]) > 0, replayed
    finally:
        for c in clients.values():
            c.close()
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    assert proc.returncode == 0
    # one logo for the node; each lane names its pid and device at boot
    # and its kernel launches at its clean shutdown
    text = (tmp_path / "node.log").read_text()
    assert text.count("distributed CRDT database, PyTorch and CUDA") == 1
    lanes_up = re.findall(r"serving lane (\d)/2 \(pid (\d+)\) .* device (\S+)", text)
    assert sorted(k for k, _, _ in lanes_up) == ["0", "1", "1"]
    assert {dev for _, _, dev in lanes_up} == {"cpu"}
    assert len(re.findall(r"kernel launches since warmup \(pid \d+\): \{", text)) == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a card")
def test_a_lane_asked_for_cuda_without_a_card_exits_non_zero(tmp_path):
    bus = [free_port(), free_port()]
    out = subprocess.run(
        [sys.executable, "-m", "jylis_tpu_torch", "--device", "cuda", "--port", "0",
         "--addr", f"127.0.0.1:{free_port()}:nocard", "--lanes", "2", "--lane-id", "1",
         "--lane-bus", ",".join(map(str, bus)), "--data-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
