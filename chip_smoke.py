#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jylis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from jylis_tpu_torch/csrc/ (nvcc, sm_90a, into
build/jylis_tpu_torch/), then:

1. kernel phases, state resident on the card. The counter drains run at
   the shapes the node phase (3.) gives them, K = 131,072 x R = 16 dense
   and B = 512 (400 live rows) sparse, and at the north-star size: the
   dense drains at K = 1,048,576 x R = 64, the sparse drains at the same
   K and R with B = 1024 (the batch of __graft_entry__.entry()) and
   B = 65,536. The TENSOR dense join runs at N = 1,000,000 x D = 64.
   Each kernel is held bit for bit against its plain PyTorch version on
   the same inputs (tolerance 0: integer lattices), then both are timed
   with CUDA events, and the kernel's own device time is read from a
   torch.profiler trace;
2. the TENSOR anti-entropy sweep (64 replica rounds, bench.py's sweep
   shape) through ops.tensor.join_dense, checked against the plain sweep
   and against numpy on the first rows;
3. the node phase: the port's RESP Server on an ephemeral port with
   state on cuda, driven over a raw socket — local INC/DEC/GET,
   anti-entropy deltas from 8 replica ids over 100,000 keys fed through
   Database.converge_async, GETs that take the dense drain, then a few
   hundred more keys that take the sparse drain — every reply held
   against a numpy/Python reference. Then each repo's whole state, read
   back from the card, and every key's served value are held against
   the reference too. The four counter kernels must have launched
   during this phase, the state must be on cuda, and its shape must be
   the one the kernel phases checked.

Each step prints one JSON line (a kernel phase's "launches" counts that
phase's compare and timing launches). The line before the last two is
{"kernels": [...]} (per kernel: launches on its main path, error against
the plain version, kernel / plain / bound times at the main path's
shape, and the counters' times at the north-star size under
"north_star"); then the card's name
and power limit as nvidia-smi reports them; the last line is
{"ok": true, "device": {...}}. Any failure raises, so the exit code is
not 0; without a GPU the script exits 1 before printing any result.
"""

from __future__ import annotations

import asyncio
import json
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 20261017
K_COUNTER = 1 << 20  # keys of the north-star counter phases
R_COUNTER = 64  # replica columns
B_ENTRY = 1024  # __graft_entry__.entry()'s batch
B_LARGE = 65_536
T_KEYS, T_DIM, T_ROUNDS = 1_000_000, 64, 64  # bench.py:1600-1602
NODE_KEYS, NODE_REPLICAS = 100_000, 8  # BASELINE.json config 2
NODE_MORE = 400  # keys of the node phase's sparse drain
# the shapes the node phase hands the counter drains: the repos size the
# keyspace to bucket(keys, 1024) and the replica columns to bucket(8
# replicas + this node, 8); the sparse drain pads 400 rows to bucket(400)
K_NODE, R_NODE, B_NODE = 131_072, 16, 512
TIMED_RUNS = 7
U64 = (1 << 64) - 1

# Least-time model of an H100 SXM ("NVIDIA H100 80GB HBM3"): HBM at
# 3.35 TB/s (NVIDIA data sheet); integer work at the INT32 rate, 64 lanes
# per SM x 132 SMs at the 1.98 GHz boost clock (Hopper architecture white
# paper). Operations are counted as the kernels' source notes count them,
# each 64-bit operation as one, so the operations' time is a lower bound:
# a u64 max and a u64 add per counter, at most 4 compares, 2 okey maps
# and 4 selects per TENSOR cell.
CARD_RATES = {"H100 80GB HBM3": (3.35e12, 132 * 64 * 1.98e9)}
OPS_PER_COUNTER = 2
OPS_PER_CELL = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def hbm_check() -> dict:
    """The card's own memory clock, to confirm the data-sheet rate the
    bound uses: H100/H200 HBM moves 2 transfers per clock over a
    5120-bit bus (NVIDIA data sheets)."""
    mhz = float(smi_line("clocks.max.memory").split()[0])
    return {"mem_clock_max_mhz": mhz,
            "implied_hbm_bytes_per_s": mhz * 1e6 * 2 * 5120 / 8}


def bound(nbytes: float, nops: float, card: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the INT32 rate of ``card``."""
    rates = next((v for k, v in CARD_RATES.items() if k in card), None)
    if rates is None:
        raise RuntimeError(f"no peak rates for {card!r} in CARD_RATES")
    t_bytes = nbytes / rates[0] * 1e3
    t_ops = nops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int = 1) -> float:
    """Median over TIMED_RUNS of CUDA-event time per call of ``fn``
    (``reps`` calls between one event pair), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(TIMED_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / reps)
    return statistics.median(runs)


def device_ms(torch, fn, kernel: str, calls: int = 5):
    """Mean device time per launch of the kernel whose name contains
    ``kernel``, from a torch.profiler (CUPTI) trace of ``calls`` calls of
    ``fn``: the kernel alone, without the host's launch overhead that
    the event times of small launches include. None when the trace holds
    no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, n = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += ev.device_time_total
            n += ev.count
    return total_us / n / 1e3 if n else None


def max_abs_err(torch, pairs) -> int:
    """Largest |kernel - plain| over every compared tensor (0 = equal)."""
    err = 0
    for a, b in pairs:
        if not torch.equal(a, b):
            d = (a.to(torch.float64) - b.to(torch.float64)).abs().max().item()
            err = max(err, int(d) or 1)
    return err


def u64_np(rng, shape) -> np.ndarray:
    """Uniform u64 values: half of them >= 2^63, row sums wrap."""
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


# ---- kernel phases -------------------------------------------------------------


def _clone(st):
    return type(st)(*(x.clone() for x in st))


def dense_case(torch, mod, state, deltas, card: str) -> dict:
    """counter_drain_dense at ``state``'s shape: bit for bit against the
    plain version, then timed."""
    np_ = len(state)
    k, r = state[0].shape
    sk, sp = _clone(state), _clone(state)
    l0 = mod.drain_dense.launches
    sums_k = mod.drain_dense(sk, *deltas)
    sums_p = mod.drain_dense_plain(sp, *deltas)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(sums_k, sums_p), *zip(sk, sp)])
    name = f"counter_drain_dense<{np_}>"
    if err:
        raise AssertionError(f"{name} K={k} R={r}: kernel != plain ({err})")
    ms = time_ms(torch, lambda: mod.drain_dense(sk, *deltas))
    dev_ms = device_ms(
        torch, lambda: mod.drain_dense(sk, *deltas), "counter_drain_dense"
    )
    plain_ms = time_ms(torch, lambda: mod.drain_dense_plain(sp, *deltas))
    nbytes = np_ * k * r * 8 * 3 + k * 8
    b_ms, b_by = bound(nbytes, np_ * k * r * OPS_PER_COUNTER, card)
    row = dict(
        shape=f"K={k} R={r}", max_abs_err=err, kernel_ms=ms,
        device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        bytes=nbytes, launches=mod.drain_dense.launches - l0,
    )
    emit({"phase": name, **row, "card": card})
    return row


def sparse_case(torch, mod, state, rng, b: int, live: int, card: str) -> dict:
    """counter_drain_sparse on ``live`` unique rows of ``state`` padded
    to ``b`` slots as the repos pad them: bit for bit against the plain
    version, pad sums 0, then timed."""
    from jylis_tpu_torch.ops import planes
    from jylis_tpu_torch.utils.batching import pad_rows

    np_ = len(state)
    k, r = state[0].shape
    dev = state[0].device
    ki = pad_rows(b)
    ki[:live] = rng.choice(k, size=live, replace=False)
    ki_t = torch.from_numpy(ki).to(dev)
    dl = [planes.to_tensor(u64_np(rng, (b, r)), dev) for _ in range(np_)]
    sk, sp = _clone(state), _clone(state)
    l0 = mod.drain_sparse.launches
    sums_k = mod.drain_sparse(sk, ki_t, *dl)
    sums_p = mod.drain_sparse_plain(sp, ki_t, *dl)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(sums_k, sums_p), *zip(sk, sp)])
    name = f"counter_drain_sparse<{np_}>"
    if err:
        raise AssertionError(f"{name} K={k} R={r} B={b}: kernel != plain ({err})")
    if int(sums_k[live:].abs().max().item()) != 0:
        raise AssertionError(f"{name}: pad slots must sum to 0")
    ms = time_ms(torch, lambda: mod.drain_sparse(sk, ki_t, *dl), reps=20)
    dev_ms = device_ms(
        torch, lambda: mod.drain_sparse(sk, ki_t, *dl), "counter_drain_sparse"
    )
    plain_ms = time_ms(torch, lambda: mod.drain_sparse_plain(sp, ki_t, *dl), reps=5)
    nbytes = np_ * live * r * 8 * 3 + b * 4 + b * 8
    b_ms, b_by = bound(nbytes, np_ * live * r * OPS_PER_COUNTER, card)
    row = dict(
        shape=f"K={k} R={r} B={b} live={live}", max_abs_err=err,
        kernel_ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        launches=mod.drain_sparse.launches - l0,
    )
    emit({"phase": name, **row, "card": card})
    return row


def counter_phases(torch, card: str) -> dict:
    """Every counter drain at the shapes the node phase gives it (the
    row kept for the kernels line) and at the north-star size (kept
    under "north_star"), plus the sparse drains at B = 65,536."""
    from jylis_tpu_torch.ops import gcount, planes, pncount

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    results = {}
    for np_, mod in ((1, gcount), (2, pncount)):
        dname, sname = f"counter_drain_dense<{np_}>", f"counter_drain_sparse<{np_}>"
        for k, r in ((K_NODE, R_NODE), (K_COUNTER, R_COUNTER)):
            st = mod.GCountState if np_ == 1 else mod.PNCountState
            state = st(*(planes.to_tensor(u64_np(rng, (k, r)), dev)
                         for _ in range(np_)))
            deltas = [planes.to_tensor(u64_np(rng, (k, r)), dev)
                      for _ in range(np_)]
            drow = dense_case(torch, mod, state, deltas, card)
            if k == K_NODE:
                results[dname] = drow
                results[sname] = sparse_case(
                    torch, mod, state, rng, B_NODE, NODE_MORE, card
                )
            else:
                results[dname]["north_star"] = drow
                results[sname]["north_star"] = sparse_case(
                    torch, mod, state, rng, B_ENTRY, B_ENTRY - B_ENTRY // 16, card
                )
                sparse_case(torch, mod, state, rng, B_LARGE,
                            B_LARGE - B_LARGE // 16, card)
            del state, deltas
            torch.cuda.empty_cache()
    return results


def tensor_inputs(torch, seed: int, dev):
    """bench.py's TENSOR delta shape (:1605-1624): random val bits, zero
    ts_hi, ts_lo in [0, 4), rid in [0, 8) — every lexicographic stage of
    the select sees ties."""
    rng = np.random.default_rng(seed)
    shape = (T_KEYS, T_DIM)

    def bits():
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)

    planes = (bits(), np.zeros(shape, np.uint32), bits() & 3, bits() & 7)
    return tuple(torch.from_numpy(p.view(np.int32)).to(dev) for p in planes)


def tensor_phase(torch, card: str) -> dict:
    from jylis_tpu_torch.ops import tensor

    dev = torch.device("cuda")
    state = tensor.TensorState(*tensor_inputs(torch, SEED + 1, dev))
    deltas = tensor.TensorState(*tensor_inputs(torch, SEED + 2, dev))
    sk = tensor.TensorState(*(x.clone() for x in state))
    sp = tensor.TensorState(*(x.clone() for x in state))
    l0 = tensor.join_dense.launches
    tensor.join_dense(sk, deltas)
    tensor.join_dense_plain(sp, deltas)
    torch.cuda.synchronize()
    err = max_abs_err(torch, list(zip(sk, sp)))
    ms = time_ms(torch, lambda: tensor.join_dense(sk, deltas))
    dev_ms = device_ms(
        torch, lambda: tensor.join_dense(sk, deltas), "tensor_join_dense"
    )
    plain_ms = time_ms(torch, lambda: tensor.join_dense_plain(sp, deltas))
    n = T_KEYS * T_DIM
    nbytes = 12 * 4 * n
    b_ms, b_by = bound(nbytes, n * OPS_PER_CELL, card)
    row = dict(
        shape=f"N={T_KEYS} D={T_DIM}", max_abs_err=err, kernel_ms=ms,
        device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        bytes=nbytes, launches=tensor.join_dense.launches - l0,
    )
    emit({"phase": "tensor_join_dense", **row, "card": card})
    if err:
        raise AssertionError(f"tensor_join_dense: kernel != plain ({err})")
    return {"tensor_join_dense": row}


def okey_np(u: np.ndarray) -> np.ndarray:
    return np.where(u >> 31, ~u, u | np.uint32(0x80000000))


def tensor_sweep(torch) -> dict:
    """The dense TENSOR anti-entropy sweep (bench.py _tensor_sweep): the
    bottom state joined with T_ROUNDS replica deltas, round i's delta
    being the base delta with val and ts_lo xor i. Launch counts are
    read from this run alone."""
    from jylis_tpu_torch.ops import tensor

    dev = torch.device("cuda")
    d = tensor.TensorState(*tensor_inputs(torch, SEED + 2, dev))

    def round_delta(i):
        return tensor.TensorState(d.val ^ i, d.ts_hi, d.ts_lo ^ i, d.rid)

    plain = tensor.init(T_KEYS, T_DIM, dev)
    for i in range(T_ROUNDS):
        tensor.join_dense_plain(plain, round_delta(i))

    tensor.join_dense.launches = 0
    t0 = time.perf_counter()
    state = tensor.init(T_KEYS, T_DIM, dev)
    for i in range(T_ROUNDS):
        tensor.join_dense(state, round_delta(i))
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = tensor.join_dense.launches

    if not all(torch.equal(a, b) for a, b in zip(state, plain)):
        raise AssertionError("tensor sweep: kernel state != plain state")
    # independent numpy reference on the first rows
    rows = 2048
    dn = [p[:rows].cpu().numpy().view(np.uint32) for p in d]
    v = np.full((rows, T_DIM), 0xFFFFFFFF, np.uint32)
    th, tl, rid = (np.zeros((rows, T_DIM), np.uint32) for _ in range(3))
    for i in range(T_ROUNDS):
        bv, bth, btl, br = dn[0] ^ np.uint32(i), dn[1], dn[2] ^ np.uint32(i), dn[3]
        ts_a = (th.astype(np.uint64) << np.uint64(32)) | tl
        ts_b = (bth.astype(np.uint64) << np.uint64(32)) | btl
        win = (ts_b > ts_a) | (
            (ts_b == ts_a) & ((br > rid) | ((br == rid) & (okey_np(bv) > okey_np(v))))
        )
        v, th, tl, rid = (np.where(win, b, a) for a, b in
                          ((v, bv), (th, bth), (tl, btl), (rid, br)))
    got = [p[:rows].cpu().numpy().view(np.uint32) for p in state]
    if not all(np.array_equal(g, w) for g, w in zip(got, (v, th, tl, rid))):
        raise AssertionError("tensor sweep: != numpy reference")
    if launches != T_ROUNDS:
        raise AssertionError(f"tensor sweep launched {launches} != {T_ROUNDS}")
    out = {"launches": launches, "rounds": T_ROUNDS, "sweep_s": sweep_s}
    emit({"phase": "tensor_sweep", **out})
    return out


# ---- node phase ---------------------------------------------------------------


def resp_cmd(*parts) -> bytes:
    out = [b"*%d\r\n" % len(parts)]
    for p in parts:
        p = p if isinstance(p, bytes) else str(p).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(p), p))
    return b"".join(out)


class Client:
    """Blocking RESP client over a raw socket (one reply per command)."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        self.buf = b""

    def call(self, *parts) -> bytes:
        self.sock.sendall(resp_cmd(*parts))
        return self.reply()

    def pipeline(self, cmds) -> list[bytes]:
        self.sock.sendall(b"".join(resp_cmd(*c) for c in cmds))
        return [self.reply() for _ in cmds]

    def reply(self) -> bytes:
        # every reply these commands get is one CRLF-terminated line
        while b"\r\n" not in self.buf:
            data = self.sock.recv(1 << 16)
            if not data:
                raise ConnectionError("server closed the connection")
            self.buf += data
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def close(self) -> None:
        self.sock.close()


def signed(v: int) -> int:
    v &= U64
    return v - (1 << 64) if v >> 63 else v


def check_full_state(name: str, repo, ref, expect) -> int:
    """Every row the drain kernels wrote, held against the reference:
    the repo's whole state (``dump_state``: every key's nonzero
    per-replica counters, read back from the card) and every key's
    served value (the value cache the kernels' row sums filled). Returns
    the number of keys checked."""
    pols = ref[name]
    keys = sorted(set().union(*pols))
    want = []
    for key in keys:
        ds = tuple(dict(pol.get(key, {})) for pol in pols)
        if any(ds):
            want.append((key, ds[0] if len(ds) == 1 else ds))
    got = repo.dump_state()
    if got != want:
        bad = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w),
                   min(len(got), len(want)))
        raise AssertionError(
            f"{name} state: {len(got)} keys vs {len(want)} in the reference; "
            f"first difference at {want[bad][0] if bad < len(want) else bad}"
        )
    for key in keys:
        if b":%d" % repo._get_value(key) != expect(name, key):
            raise AssertionError(f"{name} served value of {key} != reference")
    return len(keys)


def node_phase(torch) -> dict:
    from jylis_tpu_torch.models.database import Database
    from jylis_tpu_torch.ops import gcount, pncount
    from jylis_tpu_torch.server.server import Server
    from jylis_tpu_torch.utils.config import Config

    rng = np.random.default_rng(SEED + 3)
    identity = 0x5EED
    rids = [int(x) for x in rng.integers(1 << 40, 1 << 62, NODE_REPLICAS)]
    keys = [b"k%06d" % i for i in range(NODE_KEYS)]

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro, timeout=600):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    db = Database(identity=identity, device="cuda")
    server = Server(Config(port="0"), db)
    on_loop(server.start())
    client = Client(server.port)
    # reference: per type, per polarity, key -> {rid: value}
    ref = {"GCOUNT": ({},), "PNCOUNT": ({}, {})}

    def expect(name: str, key: bytes) -> bytes:
        pols = ref[name]
        tot = [sum(pol.get(key, {}).values()) & U64 for pol in pols]
        v = tot[0] if name == "GCOUNT" else signed(tot[0] - tot[1])
        return b":%d" % v

    own = {}  # (type, polarity, key) -> this node's own counter, wrapping

    def own_inc(name, pol, key, amount):
        # the own counter wraps at 2^64, but the lattice joins its values
        # by max: the state's own column is the largest own value any
        # drain saw, so a wrap shows only until the next drain (the JAX
        # package does the same)
        v = own[name, pol, key] = (own.get((name, pol, key), 0) + amount) & U64
        d = ref[name][pol].setdefault(key, {})
        d[identity] = max(d.get(identity, 0), v)

    def converge(name, batch_keys, hi):
        """One round of deltas from every replica over ``batch_keys``."""
        pols = len(ref[name])
        vals = rng.integers(0, hi, size=(pols, len(batch_keys), NODE_REPLICAS),
                            dtype=np.uint64)
        batch = []
        for j, key in enumerate(batch_keys):
            ds = []
            for p in range(pols):
                d = {rid: int(v) for rid, v in zip(rids, vals[p, j]) if v}
                cur = ref[name][p].setdefault(key, {})
                for rid, v in d.items():
                    cur[rid] = max(cur.get(rid, 0), v)
                ds.append(d)
            batch.append((key, ds[0] if pols == 1 else tuple(ds)))
        for i in range(0, len(batch), 10_000):
            on_loop(db.converge_async(name, batch[i : i + 10_000]))

    try:
        # local writes
        replies = client.pipeline([
            ("GCOUNT", "INC", "g0", 5), ("GCOUNT", "GET", "g0"),
            ("PNCOUNT", "INC", "p0", 10), ("PNCOUNT", "DEC", "p0", 15),
            ("PNCOUNT", "GET", "p0"), ("GCOUNT", "INC", "g0", U64),
            ("GCOUNT", "GET", "g0"),
        ])
        want = [b"+OK", b":5", b"+OK", b"+OK", b":-5", b"+OK", b":4"]
        if replies != want:
            raise AssertionError(f"local writes: {replies} != {want}")
        own_inc("GCOUNT", 0, b"g0", 5)
        own_inc("GCOUNT", 0, b"g0", U64)
        own_inc("PNCOUNT", 0, b"p0", 10)
        own_inc("PNCOUNT", 1, b"p0", 15)
        # own contributions on some keys the replicas also write
        cmds = []
        for key in keys[:200]:
            a = int(rng.integers(1, 1 << 62))
            cmds.append(("GCOUNT", "INC", key, a))
            own_inc("GCOUNT", 0, key, a)
            op, pol = (("INC", 0), ("DEC", 1))[int(rng.integers(0, 2))]
            cmds.append(("PNCOUNT", op, key, a))
            own_inc("PNCOUNT", pol, key, a)
        if set(client.pipeline(cmds)) != {b"+OK"}:
            raise AssertionError("INC/DEC on converged keys not acknowledged")

        gcount.drain_dense.launches = gcount.drain_sparse.launches = 0
        pncount.drain_dense.launches = pncount.drain_sparse.launches = 0
        t0 = time.perf_counter()
        capacity, checked = {}, 0
        for name in ("GCOUNT", "PNCOUNT"):
            # two rounds per replica: the max wins, and values >= 2^63
            converge(name, keys, 1 << 64)
            converge(name, keys, 1 << 64)
        converge_s = time.perf_counter() - t0
        sample = [keys[int(i)] for i in rng.choice(NODE_KEYS, 300, replace=False)]
        sample += keys[:50]  # keys with own contributions too
        t0 = time.perf_counter()
        for name in ("GCOUNT", "PNCOUNT"):
            got = client.pipeline([(name, "GET", k) for k in sample])
            want = [expect(name, k) for k in sample]
            if got != want:
                bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
                raise AssertionError(
                    f"{name} dense GET {sample[bad]}: {got[bad]} != {want[bad]}"
                )
        dense_get_s = time.perf_counter() - t0
        dense = (gcount.drain_dense.launches, pncount.drain_dense.launches)
        # a few hundred more keys, old and new: the sparse drain
        more = keys[:150] + [b"n%04d" % i for i in range(NODE_MORE - 150)]
        for name in ("GCOUNT", "PNCOUNT"):
            converge(name, more, 1 << 64)
            got = client.pipeline([(name, "GET", k) for k in more])
            want = [expect(name, k) for k in more]
            if got != want:
                bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
                raise AssertionError(
                    f"{name} sparse GET {more[bad]}: {got[bad]} != {want[bad]}"
                )
        launches = {
            "counter_drain_dense<1>": gcount.drain_dense.launches,
            "counter_drain_dense<2>": pncount.drain_dense.launches,
            "counter_drain_sparse<1>": gcount.drain_sparse.launches,
            "counter_drain_sparse<2>": pncount.drain_sparse.launches,
        }
        if min(launches.values()) < 1 or min(dense) < 1:
            raise AssertionError(f"a drain kernel never launched: {launches}")
        for name in ("GCOUNT", "PNCOUNT"):
            repo = db.manager(name).repo
            for plane in repo._state:
                if plane.device.type != "cuda":
                    raise AssertionError(f"{name} state on {plane.device}")
            capacity[name] = (repo._key_cap, repo._rep_cap)
            if capacity[name] != (K_NODE, R_NODE):
                raise AssertionError(
                    f"{name} capacity {capacity[name]} is not the shape the "
                    f"kernel phases held against plain ({K_NODE}, {R_NODE})"
                )
            checked += check_full_state(name, repo, ref, expect)
    finally:
        client.close()
        on_loop(server.dispose())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()
    out = {
        "launches": launches, "keys": NODE_KEYS, "replicas": NODE_REPLICAS,
        "gets_checked": 2 * (len(sample) + len(more)) + 7,
        "rows_checked": checked,
        "converge_s": converge_s, "dense_get_s": dense_get_s,
        "capacity": capacity,
    }
    emit({"phase": "node", **out})
    return out


# ---- main ----------------------------------------------------------------------

KERNELS = {
    "counter_drain_dense<1>": (
        "jylis_tpu_torch/csrc/counter_drain_dense.cu",
        "jylis_tpu/models/repo_counters.py:70 (_drain_g_dense, XLA)",
    ),
    "counter_drain_dense<2>": (
        "jylis_tpu_torch/csrc/counter_drain_dense.cu",
        "jylis_tpu/models/repo_counters.py:76 (_drain_pn_dense, XLA)",
    ),
    "counter_drain_sparse<1>": (
        "jylis_tpu_torch/csrc/counter_drain_sparse.cu",
        "jylis_tpu/models/repo_counters.py:55 (_drain_g, XLA)",
    ),
    "counter_drain_sparse<2>": (
        "jylis_tpu_torch/csrc/counter_drain_sparse.cu",
        "jylis_tpu/models/repo_counters.py:61 (_drain_pn, XLA)",
    ),
    "tensor_join_dense": (
        "jylis_tpu_torch/csrc/tensor_join_dense.cu",
        "bench.py:1728 (_pallas_tensor_join, pl.pallas_call :1773)",
    ),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    from jylis_tpu_torch.ops import _build

    card = smi_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": card, "name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          **hbm_check()})
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)  # build from source
    t0 = time.perf_counter()
    per_source = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "dir": str(_build.BUILD_DIR)})

    rows = counter_phases(torch, card)
    rows.update(tensor_phase(torch, card))
    sweep = tensor_sweep(torch)
    node = node_phase(torch)

    launches = dict(node["launches"], tensor_join_dense=sweep["launches"])
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        r = rows[kname]
        ns = r.get("north_star")
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"], ns["max_abs_err"] if ns else 0),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"], "device_ms": r["device_ms"],
            **({"north_star": {k: ns[k] for k in (
                "shape", "kernel_ms", "device_ms", "plain_ms", "bound_ms")}}
               if ns else {}),
        })
    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
