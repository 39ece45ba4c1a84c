"""One run of one cell: ``python -m cardbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, from the root of a checkout.

The process builds one ``jylis_tpu_torch`` node in-process with the
entry point's own ``main.build_node`` and ``main.serve`` (``--device
cuda``, the native engine, the default 10 s heartbeat, its data dir and
journal under ``TMPDIR``), so ``torch.profiler`` sees the node's CUDA
work. It drives the node only from worker processes over loopback: the
synthetic cluster peers (traffic/peer.py) and the open-loop RESP reader
(traffic/loadgen.py). Set-up fills the state the traffic needs over the
same wire and runs the cell's mix for ``warmup_s`` so every drain shape
the window meets has run; then the window, then the readback that
decides ``correct`` (the data type's module, types/<type>.py, and
judge.py), then the metrics (metrics/<name>.py).

The last line of stdout is the result; the numbers compared, each with
its limit, are the last lines of stderr. Without a CUDA card, or with
fewer cards than the cell asks for, the run prints no result and exits
2; with JAX or the JAX package loaded once the window has closed, 3.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from . import types

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "jylis_tpu")
READBACK_CHUNK = 4096
WORKER_TIMEOUT_S = 240.0


def process_start() -> float:
    """This process's start on the monotonic clock (from /proc; the
    first import of this module where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.monotonic()


# ---- the cell ---------------------------------------------------------------


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration and
    traffic files, and the metrics it reports at each trace setting."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return make_cell(name, cell["chips"], root / conf["file"], cell["traffic"], e2e, layer)


def make_cell(name: str, chips: int, config_file: Path, traffic: str, end_to_end: list,
              per_layer: list, types_dir: Path = types.DIR) -> dict:
    """A cell from its configuration file and the name of its traffic mix;
    its data type's module is found in ``types_dir`` (types.load)."""
    return {
        "name": name, "chips": chips,
        "config": json.loads(Path(config_file).read_text()),
        "traffic": json.loads((PKG / "traffic" / f"{traffic}.json").read_text()),
        "end_to_end": end_to_end, "per_layer": per_layer, "types": str(types_dir),
    }


def reader(metric: str):
    """The metric's reader, ``metrics/<name>.py``'s ``read(record)``."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"cardbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---- worker processes -----------------------------------------------------------


class Worker:
    """A traffic process speaking JSON lines on its stdin and stdout."""

    def __init__(self, module: str, spec: dict):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module], cwd=ROOT, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, bufsize=1,
        )
        self.send(spec)

    def send(self, obj: dict) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def recv(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"{self.proc.args[-1]} ended (rc {self.proc.wait()})")
        return json.loads(line)

    def call(self, obj: dict) -> dict:
        self.send(obj)
        return self.recv()

    def stop(self) -> None:
        if self.proc.poll() is None:
            try:
                self.send({"cmd": "exit"})
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


class Async:
    """A result from a worker call made on a thread, so the peers and
    the reader run their phase together."""

    def __init__(self, worker: Worker, obj: dict):
        self.out: dict | Exception | None = None
        self.thread = threading.Thread(target=self._go, args=(worker, obj), daemon=True)
        self.thread.start()

    def _go(self, worker, obj) -> None:
        try:
            self.out = worker.call(obj)
        except Exception as e:  # re-raised on the caller's thread by get()
            self.out = e

    def get(self) -> dict:
        self.thread.join(WORKER_TIMEOUT_S)
        if self.thread.is_alive():
            raise TimeoutError("a traffic worker did not answer")
        if isinstance(self.out, Exception):
            raise self.out
        return self.out


# ---- the node -------------------------------------------------------------------


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Node:
    """The system under test: a node wired by ``main.build_node`` and
    served by ``main.serve`` on an event loop in a thread of this
    process."""

    def __init__(self, device: str, data_dir: str):
        import errno

        from jylis_tpu_torch.main import build_node, serve
        from jylis_tpu_torch.utils.config import config_from_cli

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        for attempt in range(8):
            self.cport = free_port()
            config = config_from_cli([
                "--device", device, "-p", "0", "-a", f"127.0.0.1:{self.cport}:cardbench-node",
                "--data-dir", data_dir, "-L", "warn",
            ])
            self.stack = build_node(config)
            # the shutdown snapshot is not part of what a run measures
            self.stack.snapshot_path = ""
            try:
                self.dispose = self.call(serve(self.stack))
                break
            except OSError as e:
                self.call(self._abort())
                if e.errno != errno.EADDRINUSE or attempt == 7:
                    raise
        self.db = self.stack.database
        self.resp_port = self.stack.server.port

    def call(self, coro, timeout: float = WORKER_TIMEOUT_S):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    async def _abort(self) -> None:
        self.stack.cluster.dispose()
        await self.stack.server.dispose()
        if self.stack.journal is not None:
            self.stack.journal.close()

    def locked(self, fn):
        """``fn()`` in a worker thread under every repo lock: nothing
        converges or drains meanwhile."""
        async def go():
            async with self.db.all_locks():
                return await asyncio.to_thread(fn)
        return self.call(go())

    def close(self) -> None:
        async def go():
            self.dispose.dispose()
            await self.dispose.done.wait()
            rest = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
            for t in rest:
                t.cancel()
            await asyncio.gather(*rest, return_exceptions=True)

        try:
            self.call(go(), timeout=120)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)


class Resp:
    """A blocking RESP client for the readback."""

    def __init__(self, port: int):
        from .traffic.loadgen import _Conn

        self.conn = _Conn("127.0.0.1", port)

    def pipeline(self, cmds: list[list[bytes]]) -> list:
        from .traffic.loadgen import _pack

        out = []
        for i in range(0, len(cmds), READBACK_CHUNK):
            chunk = cmds[i : i + READBACK_CHUNK]
            self.conn.sock.sendall(b"".join(_pack(c) for c in chunk))
            out.extend(self.conn.read_reply() for _ in chunk)
        return out

    def metrics(self) -> dict[str, float]:
        """SYSTEM METRICS as {"<section> <counter>": value}."""
        (lines,) = self.pipeline([[b"SYSTEM", b"METRICS"]])
        out = {}
        for raw in lines if isinstance(lines, list) else []:
            if isinstance(raw, bytes) and b" " in raw:
                name, _, value = raw.decode().rpartition(" ")
                try:
                    out[name] = float(value)
                except ValueError:
                    pass
        return out

    def close(self) -> None:
        self.conn.close()


# ---- the run --------------------------------------------------------------------


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_proc0: float | None = None) -> dict:
    """Everything of one run but the printing; returns the result."""
    from . import judge
    from .traffic.gen import key_bytes

    t_proc0 = process_start() if t_proc0 is None else t_proc0
    cfg, traffic = cell["config"], cell["traffic"]
    kind = types.load(cfg["type"], cell["types"])
    spec = {"config": cfg, "traffic": traffic, "seed": seed, "types": cell["types"]}
    peers = Worker("cardbench.traffic.peer", spec)
    reader_w = None
    data_dir = tempfile.mkdtemp(prefix="cardbench-node-")
    node = None
    try:
        peers.recv()  # prepared
        node = Node(device, data_dir)
        if traffic.get("gets_per_s"):
            reader_w = Worker("cardbench.traffic.loadgen", {**spec, "resp_port": node.resp_port})
            reader_w.recv()
        peers.call({"cmd": "connect", "cport": node.cport, "resp_port": node.resp_port})
        filled = peers.call({"cmd": "fill"})
        phase(peers, reader_w, traffic["warmup_s"], 0)
        resp = Resp(node.resp_port)
        before = resp.metrics()
        tracer = None
        if trace:
            from .trace import Tracer

            tracer = Tracer(node.db)
            tracer.start()
        t_start = time.monotonic() + 0.05
        setup_s = t_start - t_proc0
        ran, got = phase(peers, reader_w, seconds, 1, t_start)
        node.locked(lambda: None)  # the last converge and its drain have ended
        trace_rec = tracer.stop() if tracer is not None else None
        after = resp.metrics()
        dev = device_record(device)
        if trace_rec is not None:
            dev.update(busy_s=trace_rec["busy_s"], window_s=trace_rec["window_s"])

        keys = key_bytes(cfg["key_format"], cfg["keys"])
        node_state = kind.readback(node, resp, cfg, keys, seed)
        resp.close()
    finally:
        for w in (peers, reader_w):
            if w is not None:
                w.stop()
        if node is not None:
            node.close()
        shutil.rmtree(data_dir, ignore_errors=True)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    checks = judge.judge(kind, cfg, traffic, seed, ran["frames"], node_state, got)
    record = {
        "cell": cell["name"], "config": cfg, "type_module": kind, "traffic": traffic,
        "setup_s": setup_s, "fill_s": filled["seconds"], "window_s": ran["window_s"],
        "merges": ran["merges"], "push_ack_ms": ran["ack_ms"], "gets": got,
        "forced_reads": ran["reads"], "system_metrics": {"before": before, "after": after},
        "trace": trace_rec, "device": dev,
    }
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = ran["merges"] + (got["sent"] if got else 0) + ran["reads"]["sent"]
    failed = ((sum(v is None for v in got["lat_ms"]) if got else 0)
              + ran["reads"]["failed"])
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev,
    }
    if trace_rec is not None:
        result["breakdown"] = trace_rec["breakdown"]
    result["checks"] = checks
    return {"result": result, "loaded": loaded, "record": record}


def phase(peers: Worker, reader_w: Worker | None, seconds: float, n: int,
          t_start: float | None = None):
    """One phase of the mix on the peers and the reader together; the
    peers' record and the reader's (None without one)."""
    t_start = time.monotonic() + 0.05 if t_start is None else t_start
    cmd = {"cmd": "run", "t_start": t_start, "seconds": seconds, "phase": n}
    jobs = [Async(peers, cmd)] + ([Async(reader_w, cmd)] if reader_w is not None else [])
    outs = [j.get() for j in jobs]
    return outs[0], (outs[1] if reader_w is not None else None)


def device_record(device: str) -> dict:
    import torch

    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        out["power_limit_w"] = float(smi.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        out["power_limit_w"] = None
    return out


def main(argv: list[str] | None = None) -> int:
    t_proc0 = process_start()
    ap = argparse.ArgumentParser(prog="python -m cardbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    build = ROOT / "build" / "cardbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cardbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed & ((1 << 64) - 1), args.seconds, bool(args.trace),
                   "cuda", t_proc0)
    if out["loaded"]:
        print(f"cardbench: loaded after the window: {', '.join(out['loaded'])}", file=sys.stderr)
        return 3
    result = out["result"]
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
