#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jylis_tpu_torch) on NVIDIA GPUs.

    python3 chip_smoke.py

It needs one card; with several visible it also runs the node on all of
them (see the end of the phase list).

Builds the native host library from jylis_tpu_torch/native/src/ (g++,
the serving engine, the RESP scanner and the wire codec) and the CUDA
kernels from jylis_tpu_torch/csrc/ (nvcc, sm_90a), all into
build/jylis_tpu_torch/, and prints the "native" line first (the
library's path, its build seconds, the compiler's version); then:

1. kernel phases, state resident on the card. The counter drains run at
   the shapes the node phase (3.) gives them, K = 131,072 x R = 16 dense
   and B = 512 (400 live rows) sparse, and at the north-star size: the
   dense drains at K = 1,048,576 x R = 64, the sparse drains at the same
   K and R with B = 1024 (the batch of __graft_entry__.entry()) and
   B = 65,536. The dense drains take a compact batch of B = K / 4, K / 2
   and K unsorted unique rows (row K - 1 among them) and walk every row
   through a slot map; each is held on the state, every row's sum and the
   slots' sums, the map clean after, and timed with its whole-plane
   bound beside its own. The TENSOR dense join runs at N = 1,000,000 x
   D = 64.
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
   the one the kernel phases checked;
4. the TREG and gathered TENSOR kernel phases (run with 1. and 2.):
   treg_drain_dense at K = 1,048,576 with B = K / 4, K / 2 and K staged
   keys and treg_drain_sparse at B = 8,192 (5,000 live) and B = 65,536;
   tensor_converge_batch at the TENSOR node phase's first drain
   (N = B = 131,072 x D = 64, 130,000 live rows) and at
   N = 1,000,000 x D = 64 with B = 65,536. Each is held bit for
   bit against its plain version (ts and ranks >= 2^63, prefix ties,
   unset registers, pads, NaN bits, both zeros, equal ts under other
   rids) and timed on a fresh copy of its inputs per call;
5. the TREG node phase (BASELINE config 3): 1,000,000 keys through
   Database.converge_async in three rounds (the dense drain at
   K = 1,048,576 twice, the second with prefix ties the host settles,
   then 5,000 new keys through the sparse drain), local SET/GET over
   the socket, every reply against a Python reference, then the whole
   device state (ts, rank, vid through the interner) and the mirror
   cache against the reference for every key;
6. the TENSOR node phase: 100,000 keys x 64 dims (LWW, MAX and AVG) in
   two rounds of deltas (contention, NaN payloads, dominance flips),
   SET/MRG/GET over the socket with both BADSHAPE replies and a
   BADPAYLOAD, every reply against a numpy reference of the lattice,
   then every live device row against the repo's mirror rule;
7. the TLOG kernel phases (run with 1. and 2.): tlog_drain_sparse and
   tlog_drain_dense at BASELINE config 4's device size (K = 16,384 rows
   for 10,000 keys, L = 1,024; sparse at B = 16,384 with Ld = 128, dense
   with Ld = 64, TRIM counts of 512), narrow and wide; the dense drain at
   the node phase's L = 512; the socket TRIM's shape (B = 16, one row);
   a row wider than shared memory (L = Ld = 65,536: a cluster of 16
   CTAs); the class boundaries of ops/tlog.py drain_plan (the widest L
   the warp class takes at Ld = 128 and the next, narrow and wide; Ld =
   256 and 257; the dense drain at its crossover); and the cluster
   class's partition edges (8 rows forced into clusters of 8: trims and
   cutoffs at the first and last CTA's share, repeats, an overflow).
   Each is held bit
   for bit against its plain version (ts >= 2^32 and 2^64-1 with CLR,
   duplicates inside a delta and against the state, raised cutoffs,
   pad and negative rows, counts 0, above the length, negative and
   >= the no-op sentinel, rows that overflow under both rules) and
   timed on a fresh state copy per call;
8. the TLOG node phase (BASELINE config 4): 10,000 keys filled to
   1,024 entries each through Database.converge_async, in rounds of
   64 entries (the dense drain, one of them flagging rows and taking
   the tail-overflow retry) and 128 (the sparse drain), one round
   re-delivered, cutoffs raised, the last round in 64-bit ts (the state
   widens); then GET/SIZE/CUTOFF, TRIM to 512 on 1,000 keys (one sparse
   drain each), TRIMAT, CLR and INS over the socket, every reply against
   a Python reference of the lattice, and the whole device state read
   back through the interner against the reference for every key;
9. the UJSON kernel phases (run with 1. and 2.): ujson_join at BASELINE
   config 5b's tree levels (K = 64 keys x D = 512 one-entry deltas) and
   subset join into resident rows of 4,096 dots, at config 5's
   broadcast join (32 replicas, one folded row 65,536 slots wide: past
   shared memory) and its tree; ujson_fold_flat at the node phase's
   flat leg (K = 4,096 x D = 64, and 64 keys), at random planes of a few
   wide keys (K = 2 x D = 64 x W = 512) and at the class boundaries of
   ops/ujson_resident.py flat_plan (UJ_FLAT_BOUNDARIES); ujson_join at
   the class boundaries of ops/ujson_device.py join_plan (random rows of
   the widest width the warp class takes, and of the next; the fewest
   rows it takes, and half as many) and at the cluster class's partition
   edges (twin dots and cloud entries split across CTAs, the epilogue in
   place); narrow and wide, each bit for bit against its plain version
   and timed;
10. the UJSON store phase (BASELINE config 5, published shape): 32
   replica documents resident on the card, 8 rounds of 1,280 set_doc
   deltas through fold_in_broadcast, every replica's state against the
   host join of the 32 writers' documents;
11. the UJSON node phase: config 5b's 64 keys x 8 rounds of 512 INS
   deltas (tree folds), 64 keys of config 5's edits from 32 replica ids
   (the narrow repack), 4,096 keys x 64 mixed deltas in one batch (the
   flat rule), a seq past the narrow layout (the store widens; a tree
   round and a flat round follow), then UJSON GET of every key, read
   trickles, local INS/SET/RM/CLR that demote resident keys and GETs
   over the socket, every reply and every key's state (dump_state,
   canonicalised) against references joined from each writer's own
   final documents;
12. the mesh phases, on a 4-shard mesh over the visible cards when
   there are four or more (a card a shard), two a card on two cards,
   else the one card four times (the line "mesh" says which):
   replica_join (the new kernel) at the north star's 64 replicas x
   1,048,576 keys and at S = 7, bit for bit against its plain version
   and timed beside torch.amax over the same bytes; with two or more
   cards, that S = 64 state sharded P("rep", "keys") over (rep 4, keys
   1) and (2, 2) meshes of the cards through join_replica_axis, every
   block bit for bit against the one-card replica_join, its local
   folds, cross-card copies and leader's fold timed apart (the
   "replica_join_cards" lines); the mesh routes of
   the existing kernels at full width (GCOUNT and PNCOUNT 1,048,576 x 64
   with a routed drain of B = 65,536 and its pad share, TREG 1,048,576 with
   B = 65,536, TLOG config 4 wide with every row and its trim, UJSON's
   row-aligned fold at the flat leg's shape and at D = 130), each
   against its plain versions on the same per-shard slices and against
   the single-device drain of the same batch;
12b. the staged calls of the sparse drains: a 64 MB
   copy to the card from pinned and from pageable memory and back to
   pinned memory (the "transfer" line: the rates the call is bounded
   by); then counter_drain_sparse<1> and <2> at K = 1,048,576 x R = 64
   with B = 1,024 and 65,536 on one device and B = 65,536 over the
   4-shard mesh, and treg_drain_sparse at K = 1,048,576 with B = 8,192
   and 65,536 and B = 65,536 over the mesh, each through the repos'
   staged, unrouted call (parallel.drain_unrouted_*: one staged copy,
   one launch and one read-back per card, no pad slot) from a host
   batch to host results, bit for bit against its plain version and
   against the old path on the same data (on one device the repos'
   earlier pageable sequence, padded to bucket(B), with the earlier
   wrapper's torch.empty outputs; on the mesh route_drain +
   drain_sharded_*), then both timed in turns on the
   CUDA-event clock with the new launch's device time, the kernel's
   bound and the call's bound (the kernel's plus the staged bytes at
   the measured pinned rates; TREG also its layout's sector bound);
   then the dense drains through the same staged call on one device
   (the "dense_call ..." lines): the counters at K = 131,072 x R = 16
   with B = K / 4 and K and at 1,048,576 x 64 with B = K / 4 (cut into
   staged calls past a Stage, each one walk), TREG at K = 1,048,576 with
   B = K / 4 and K, each bit for bit against the same call with the
   plain step and timed from host batch to host results beside the
   kernel's bound and the call's; the parent's whole-plane call is
   timed by scripts/dense_drain_profile.py --root;
13. the mesh node phase: a Database on the mesh and a single-device
   one fed the same RESP script and delta stream (config 2's counters
   and TREG keys with prefix ties, each at MESH_NODE_KEYS = 50,000 keys,
   2,000 TLOG keys with trims,
   UJSON's flat and tree rounds), every reply and each repo's
   dump_state compared; no dense drain may launch on the mesh node (its
   counter and TREG drains are the staged, unrouted ones, a launch a
   drain; TLOG's and UJSON's routed, a launch a shard);
   then, with the counts set to 0 again, parallel.dryrun's
   dryrun_multichip on the mesh's devices (the only path that runs
   replica_join: no serving repo joins over a rep axis);
14. the digest phase: the mesh node phase's script (MESH_NODE_KEYS),
   then MAP (10,000
   (key, field) pairs over the four inner types, with DELs and foreign
   field units), BCOUNT (10,000 keys: GRANT, INC, DEC, TRANSFER, foreign
   escrow, many spends refused OUTOFBOUND) and TENSOR SETs, then a UJSON
   round left pending (60 resident keys x 64 deltas), into three nodes:
   single-device on the card, the 4-shard mesh, and on the CPU. Every
   reply, SYSTEM DIGEST and each line of SYSTEM DIGEST TYPES (over the
   socket, and the blocking digest) must be equal across the three; on
   the card the first SYSTEM DIGEST must launch ujson_fold_flat or
   ujson_join (it folds the pending round before it hashes); a second
   digest after writes to 100 GCOUNT keys must hash those keys and no
   other. The CPU node's digest is the one the CPU tests hold to the JAX
   package's bytes. Its host seconds go on the "digest" line;
15. the cluster phase: two port nodes, each wired by the entry point's
   own code (main.build_node, main.serve, and its Dispose at the end) in
   a process of its own (cluster_peer), RESP Server and Cluster on
   loopback ephemeral ports, heartbeat 1 s; node C holds its state on
   the card and node H on the CPU (the plain versions: the reference).
   H is loaded with BASELINE config 2 (100,000 GCOUNT and 100,000
   PNCOUNT keys from 8 replica ids) through converge_async; C starts
   empty, seeded with H's address, and the digest-checked bootstrap
   sync (digest trees, budgeted range pulls, converge) brings the state
   over the wire, through C's counter drains. Then the digest phase's
   all-type script runs in two stages. C's stage: both nodes converge
   the foreign batches that reach both (counters, MAP, BCOUNT, the flat
   UJSON round) and the even RESP bursts go to C. H's stage, in which C
   takes no input but the wire: H converges the foreign batches that
   reach it alone (every TREG and TLOG batch, the UJSON tree round, the
   flat keys' second round and a deeper TLOG round on every fourth
   key), which no broadcast carries and C gets
   only through the periodic digest exchange's range sync, takes the
   odd bursts and SETs 4,096 TENSOR keys. Both must end with equal
   SYSTEM DIGEST and SYSTEM DIGEST TYPES (every type non-zero) and
   equal GET replies for sampled keys of every type. C's launch counts
   are set to 0 after its warmup and read after the bootstrap and after
   each stage (each read drains C first): on the deltas that reached C
   over the wire (the bootstrap and H's stage) C must have launched a
   dense and a sparse counter drain, treg_drain_sparse,
   tlog_drain_sparse, a UJSON kernel and tensor_converge_batch. The
   "cluster" line holds the host seconds (boot to mesh, bootstrap to
   equal digests, each stage, last write to equal digests), the types
   that differed over time, the frames each node received by message
   kind, the keys they carried, the sync counters each way, and C's
   launches by stage;
16. the persistence phase (persist_phase): nodes wired by
   main.build_node with --data-dir, each in a process of its own, one
   address (one replica identity), the journal on. P1 on the card takes
   the cluster phase's data (config 2 and the whole all-type script) and
   a clean shutdown writes its snapshot and retires its journal; P2 on
   the card restores it at boot (its digests must equal P1's, and its
   restore must launch a counter, TREG, TLOG, UJSON and TENSOR drain
   kernel), takes a second stage of writes of every type over RESP until
   its JOURNAL appends counter settles, and is killed with SIGKILL; P3
   on the card restores the snapshot and replays the journal (its
   digests must equal P2's before the kill); a CPU node on a copy of
   P1's file gives P1's digests and, fed the second stage, P2's replies
   and P3's digests. With two or more cards, P3's shutdown snapshot
   (written keys-sharded over every card) restores on P4, a node on
   ``--device cuda:1`` alone, whose own shutdown snapshot restores on
   P5, a node on every card: both must give the CPU node's digests. The
   "persist" line holds the snapshot's bytes and write seconds, boot to
   listening, the restore's decode + converge and drain_all seconds,
   its launches (in all and by card), and the replay's batches, seconds
   and launches;
17. the lanes phase (lanes_phase): ``python -m jylis_tpu_torch --lanes 2
   --data-dir D --metrics-port M --heartbeat-time 1`` as a user starts
   it, on the default device: the supervisor and two lane workers, each
   a full replica on the card, converging over the loopback lane bus;
   lane 0 is the node's one cluster member. E, a CPU port node seeded
   with the node's address, converges BASELINE config 2 (100,000 GCOUNT
   and PNCOUNT keys from 8 replica ids) before it dials; one connection
   per lane writes
   GCOUNT and PNCOUNT to every one of those keys, key i at lane i % 2.
   Admission: lane 1 has admission.shed armed (JYLIS_LANE_FAILPOINTS)
   and answers its first read, write and bulk command BUSY with class
   and hint. Both lanes, E and a CPU reference of the port (a Database
   per lane identity and one for E, joined) reach one SYSTEM DIGEST, and
   every key read at the lane that did not take its write equals the
   reference. Each lane shows drains of both counter types, no idle
   eviction, its device (cuda:N) on its log line; a SESSION WRAP at
   lane 0 is served by SESSION READ at lane 1 and a mangled token gets
   BADTOKEN; the supervisor's Prometheus endpoint carries both lanes and
   the summed drain counters. No lane may have restarted before lane 1
   is SIGKILLed; its respawn replays its journal segment and the digests
   are equal again. Each lane logs its kernel launches since its warmup
   at its clean shutdown ("lanes_launches": lane 0's, and lane 1's after
   its respawn), in all and by card.
On a host with two or more cards the nodes started with a bare
``--device cuda`` (C, P1-P3, P5, both lanes) take every card: each
must name all of them in its mesh, nvidia-smi must list a new compute
app on every card's UUID while it runs (apps are counted per card: in a
pid namespace the pids differ), and its launches by card must show
counter_drain_sparse<1> and <2> (and for C also treg_drain_sparse,
tlog_drain_sparse and a UJSON kernel) on every card. The "cards" line
at the start gives the cards, their power limits and the peer access
of every pair. On one card each step that needs several prints a line
``{"phase": ..., "ran": false, "why": ...}``.
Before 1., the codec phase, on the card machine's host: config 2's
PNCOUNT state (100,000 keys x 8 replica ids) as 2,048-key PushDeltas
frames, encoded and decoded by the native codec and by the oracle
(``native=False``), each timed (first, while the process's heap is
small); the bytes must be equal and both decodes must give the batches
encoded. Then the card's launch floor: a one-element fill's device time.
Each node phase (and the dryrun) sets its kernels' launch counts to 0
just before it, reads them just after, and fails unless each kernel of
its path launched. Every node of the node phases (3., 5., 6., 8., 10.,
13., 14.) runs the native serving engine (``Database(engine="auto")``,
the default): RESP bursts settle in C++ and the drains take their
batches from the engine's tables. Each node first answers one probe
burst (a GCOUNT GET of an absent key), and its phase line holds its
engine mode and SERVING split ("serving": native_cmds, demoted_cmds,
demotions); a node phase fails unless native_cmds > 0 on each of its
nodes. The cluster phase's nodes run the engine too, and C must have
encoded and decoded PushDeltas frames (plain, seq- or relay-prefixed)
on the native codec path.

Each step prints one JSON line (a kernel phase's "launches" counts that
phase's compare and timing launches). The line before the last two is
{"kernels": [...]} (per kernel: "launches" on the single-device node
phases, replica_join's on the dryrun; "mesh_launches" on the mesh
node, "dryrun_launches" on the dryrun and "digest_launches" on the
digest phase's two nodes on the card, "cluster_launches" on the
cluster phase's card node and "cluster_wire_launches", those of its
launches the wire fed, "restore_launches" in P2's boot restore,
"replay_launches" in P3's journal replay and "lanes_launches" in the
lanes node's two lane processes, each apart; for the row
kernels tlog_drain, ujson_join and ujson_fold_flat, "class" at each
shape and "launch_classes", the main path's launches by class (a warp
or a CTA per row, or a cluster of CTAs per row: ops/row_plan.py);
error
against the plain version, kernel / plain / bound times at the main
path's shape, the mesh routes' times under "mesh_routes", the staged
calls' old and new times under "staged_calls", the
counters' times at the north-star size under "north_star",
other shapes' times under "other_shapes"); then the card's name
and power limit as nvidia-smi reports them; the last line is
{"ok": true, "device": {...}}. Any failure raises, so the exit code is
not 0; without a GPU the script exits 1 before printing any result.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import re
import shutil
import signal
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
# BASELINE.json config 3: 1M TREG keys, random-timestamp merge; the repo
# sizes the keyspace to bucket(keys, 1024). Round 2 contends on 30% of
# the keys (>= K/4: the dense drain again), round 3 adds 5,000 (above
# the 4,096-row drain threshold, under K/4: the sparse drain, B = 8,192)
TREG_KEYS, K_TREG = 1_000_000, 1 << 20
TREG_CONTEND, TREG_NEW, B_TREG_NODE = 0.3, 5_000, 8_192
# the TENSOR node phase: 100,000 keys x 64 dims (bench.py's tensor-merge
# keyspace is 1M keys; cut because the host lattice joins each delta in
# Python). Round 1 maps 70,000 LWW + 20,000 MAX keys to a device row
# each and 10,000 AVG keys to 4 rows each: 130,000 rows, so the repo's
# capacity and its first drain's batch are both bucket(130,000) = 131,072
TENSOR_KEYS, TENSOR_ROWS_R1, TENSOR_FLIPS = 100_000, 130_000, 50
N_TENSOR_NODE = B_TENSOR_NODE = 131_072
# BASELINE.json config 4 (bench.py:1024 config_tlog_trim): TLOG, 10,000
# keys x 1,024 entries, merge + TRIM to 512. The repo sizes the keyspace
# to bucket(10,000, 1024) = 16,384 rows and the slots to 1,024; rounds of
# 128 entries drain sparse (B = bucket(10,000)), rounds of 64 dense
TLOG_KEYS, TLOG_LEN, TLOG_TRIM = 10_000, 1024, 512
K_TLOG, L_TLOG, B_TLOG = 16_384, 1024, 16_384
LD_SPARSE, LD_DENSE = 128, 64
TLOG_VALUES = 65_536  # the node phase's value pool: the interner stays bounded
TLOG_TRIMS = 1000  # keys the node phase TRIMs over the socket
TIMED_RUNS = 7
U64 = (1 << 64) - 1
# where the node phases keep their state; "cpu" runs the plain versions
# (a rehearsal of the phases without a GPU; main() refuses to run then)
DEVICE = "cuda"
# the node phases' probe key: no phase writes it
PROBE_KEY = b"chip_smoke:probe"

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
OPS_PER_REGISTER = 10  # 6 compares and 4 selects per TREG register


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


def time_ms(torch, fn, reps: int = 1, reset=None) -> float:
    """Median over TIMED_RUNS of CUDA-event time per call of ``fn``
    (``reps`` calls between one event pair), after one warm-up.
    ``reset``, when given, runs before each event pair, outside it: it
    puts back the inputs a call that joins in place consumed."""
    if reset is not None:
        reset()
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(TIMED_RUNS):
        if reset is not None:
            reset()
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
    the event times of small launches include. A trace now and then
    comes back without the kernel's records, so up to 3 traces are
    taken; None when none of them holds the kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us, n = 0.0, 0
        for ev in prof.key_averages():
            if kernel in ev.key:
                total_us += ev.device_time_total
                n += ev.count
        if n:
            return total_us / n / 1e3
    return None


def launch_floor(torch) -> dict:
    """The card's shortest kernel as the sparse drains see it: a
    one-element fill's device time (the same profiler read as every
    kernel's) and its CUDA-event time a call."""
    x = torch.zeros(1, device=DEVICE)
    out = {"fill_device_ms": device_ms(torch, lambda: x.fill_(1.0), "FillFunctor", calls=20),
           "fill_event_ms": time_ms(torch, lambda: x.fill_(1.0))}
    emit({"phase": "launch_floor", **out})
    return out


def reset_counts(*wrappers) -> None:
    """Set the launch counts of kernel wrappers to 0: ``.launches``, the
    per-card ``.by_card`` and, on the row kernels, ``.classes``."""
    from jylis_tpu_torch.ops import _build

    _build.reset(*wrappers)


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


def dense_batches(k: int) -> tuple:
    """The dense drains' batch sizes at ``k`` keys: the least the repos
    drain dense (K / DENSE_FRACTION), K / 2 and every row."""
    return (k // 4, k // 2, k)


def dense_rows_np(rng, k: int, b: int) -> np.ndarray:
    """``b`` unique rows of ``k`` in no order, row k - 1 among them."""
    rows = rng.permutation(k)[:b].astype(np.int32)
    if k - 1 not in rows:
        rows[0] = k - 1
    return rows


def dense_counter_bytes(np_: int, k: int, r: int, b: int) -> tuple:
    """(this design's, the whole-plane design's) bytes of a counter dense
    drain, each input byte read once and each output byte written once:
    the state and the map read, every row's sum written, and per slot its
    row, its delta row read, its state row written and its sum; the
    earlier drain read a delta plane as large as the state and wrote the
    whole state back."""
    new = np_ * k * r * 8 + 4 * k + 8 * k + b * (4 + 2 * np_ * r * 8 + 8)
    return new, np_ * k * r * 8 * 3 + k * 8


def call_device_ms(torch, fn, kernels, calls: int = 5) -> dict:
    """Device ms a call of ``fn`` spends in each kernel whose name holds
    one of ``kernels`` (their sum under "total"), from one
    torch.profiler (CUPTI) trace of ``calls`` calls; up to 3 traces when
    one comes back without a kernel's records, None for a kernel never
    seen."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    got = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        got = {k: 0.0 for k in kernels}
        seen = set()
        for ev in prof.key_averages():
            for k in kernels:
                if k in ev.key and ev.count:
                    got[k] += ev.device_time_total / calls / 1e3
                    seen.add(k)
        if len(seen) == len(kernels):
            break
    else:
        got = {k: (v if k in seen else None) for k, v in got.items()}
    got["total"] = (None if any(v is None for v in got.values())
                    else sum(got.values()))
    return got


def launch_host_ms(torch, fn, calls: int = 50) -> float:
    """Host ms a call of ``fn`` takes to return, over ``calls`` calls
    back to back with no wait in between (the wrapper's checks and the
    launches' enqueue; the card runs behind), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return t


def dense_case(torch, mod, state, rng, b: int, card: str) -> dict:
    """counter_drain_dense on a staged compact batch of ``b`` unsorted
    unique rows (K - 1 among them) of ``state``: bit for bit against the
    plain version (the state, every row's sum, the slots' sums) with the
    slot map clean after, then timed: CUDA events a call (the parent's
    clock for this row), the device time of the walk and the scatter."""
    from jylis_tpu_torch.ops import planes
    from jylis_tpu_torch.ops.staging import DensePlan

    np_ = len(state)
    k, r = state[0].shape
    dev = state[0].device
    ki = torch.from_numpy(dense_rows_np(rng, k, b)).to(dev)
    deltas = [planes.to_tensor(u64_np(rng, (b, r)), dev) for _ in range(np_)]
    pk, pp = DensePlan(_clone(state)), DensePlan(_clone(state))
    l0 = mod.drain_dense.launches
    full_k, out_k = mod.drain_dense(pk, ki, *deltas)
    full_p, out_p = mod.drain_dense_plain(pp, ki, *deltas)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(full_k, full_p), (out_k, out_p), *zip(pk.state, pp.state)])
    name = f"counter_drain_dense<{np_}>"
    clean = bool((pk.slots.map == -1).all().item())
    if err or not clean:
        raise AssertionError(f"{name} K={k} R={r} B={b}: kernel != plain ({err}), "
                             f"slot map clean {clean}")
    call = lambda: mod.drain_dense(pk, ki, *deltas, out_k)  # noqa: E731
    ms = time_ms(torch, call)
    dev_ms = call_device_ms(torch, call, ("counter_drain_dense", "scatter_slots"))
    launch_ms = launch_host_ms(torch, call)
    plain_ms = time_ms(torch, lambda: mod.drain_dense_plain(pp, ki, *deltas, out_p))
    nbytes, old_bytes = dense_counter_bytes(np_, k, r, b)
    b_ms, b_by = bound(nbytes, np_ * (k + b) * r, card)
    row = dict(
        shape=f"K={k} R={r} B={b}", max_abs_err=err, kernel_ms=ms,
        device_ms=dev_ms["total"], walk_device_ms=dev_ms["counter_drain_dense"],
        scatter_device_ms=dev_ms["scatter_slots"], launch_host_ms=launch_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        old_bound_ms=bound(old_bytes, np_ * k * r * OPS_PER_COUNTER, card)[0],
        old_bytes=old_bytes, launches=mod.drain_dense.launches - l0,
    )
    emit({"phase": name, **row, "card": card})
    del pk, pp, deltas
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
    under "north_star"), plus the sparse drains at B = 65,536. The dense
    drains take staged batches of B = K / 4 (the row kept), K / 2 and K
    (under "other_shapes")."""
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
            drow, *more = [dense_case(torch, mod, state, rng, b, card)
                           for b in dense_batches(k)]
            if k == K_NODE:
                results[dname] = drow
                drow["other_shapes"] = more
                results[sname] = sparse_case(
                    torch, mod, state, rng, B_NODE, NODE_MORE, card
                )
            else:
                results[dname]["north_star"] = drow
                results[dname]["other_shapes"] += more
                results[sname]["north_star"] = sparse_case(
                    torch, mod, state, rng, B_ENTRY, B_ENTRY - B_ENTRY // 16, card
                )
                sparse_case(torch, mod, state, rng, B_LARGE,
                            B_LARGE - B_LARGE // 16, card)
            del state
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

    reset_counts(tensor.join_dense)
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


# ---- the TREG and gathered TENSOR kernels ------------------------------------

TS_POOL = np.array([0, 1, 7, 1 << 63, (1 << 63) + 5, U64], np.uint64)


def treg_planes(rng, n: int):
    """(ts, rank, vid) of ``n`` registers: ts and ranks half from a pool
    of repeats (>= 2^63 among them), half uniform u64; a tenth unset
    (0, 0, -1); some set registers at ts 0."""
    def mix():
        pool = TS_POOL[rng.integers(0, len(TS_POOL), n)]
        return np.where(rng.random(n) < 0.5, pool, u64_np(rng, n)).astype(np.uint64)

    ts, rank = mix(), mix()
    ts[rng.random(n) < 0.05] = 0
    vid = rng.integers(0, 1 << 30, n).astype(np.int32)
    unset = rng.random(n) < 0.1
    ts[unset], rank[unset], vid[unset] = 0, 0, -1
    return ts, rank, vid


def treg_deltas(rng, state_np, rows):
    """Delta registers for ``rows`` of ``state_np``: a third copy their
    row's ts and rank under another vid (ties the host settles), the
    identity (0, 0, -1) stands for "no delta", and a delta (0, 0, vid)
    meeting an unset row wins by presence alone."""
    n = len(rows)
    ts, rank, vid = treg_planes(rng, n)
    tie = rng.random(n) < 1 / 3
    ts[tie] = state_np[0][rows[tie]]
    rank[tie] = state_np[1][rows[tie]]
    vid[tie] = rng.integers(0, 1 << 30, int(tie.sum())).astype(np.int32)
    return ts, rank, vid


def treg_tensors(torch, planes_np, dev):
    from jylis_tpu_torch.ops import planes

    ts, rank, vid = planes_np
    return (planes.to_tensor(ts, dev), planes.to_tensor(rank, dev),
            torch.from_numpy(np.ascontiguousarray(vid)).to(dev))


def changed(torch, before, after) -> int:
    """Elements a join rewrote (TREG: registers; TENSOR: cells). B
    strictly beats A only where the element changes, so for TREG this is
    the number of wins."""
    diff = torch.zeros_like(before[0], dtype=torch.bool)
    for a, b in zip(before, after):
        diff |= a != b
    return int(diff.sum().item())


def restorer(state, pristine):
    """A function that copies ``pristine`` back into ``state``: the kernel
    phases time each in-place join on a fresh copy of its inputs (a join
    that already ran writes nothing the second time)."""
    def go():
        for a, b in zip(state, pristine):
            a.copy_(b)
    return go


def treg_dense_bytes(k: int, b: int, wins: int) -> tuple:
    """(this design's, the whole-plane design's) bytes of a TREG dense
    drain: the tie flag written a key; a slot's row, delta, state and
    outputs (4 + 20 + 20 + 13 B); 20 B of state written a win. The
    earlier drain read the state and a delta a key."""
    return k + b * 57 + wins * 20, k * 41 + wins * 20


def treg_dense_case(torch, rng, st_np, st0, b: int, card: str) -> dict:
    """treg_drain_dense on a staged compact batch of ``b`` unsorted
    unique keys (K - 1 among them; a third tie their row): bit for bit
    against the plain version (the state, every key's tie flag, the
    slots' (tie, ts, vid)), then timed on a fresh copy of the state per
    call: CUDA events, the device time of the slots' pass and the
    clear."""
    from jylis_tpu_torch.ops import treg
    from jylis_tpu_torch.ops.staging import DensePlan

    dev = st0.vid.device
    k = st0.vid.shape[0]
    rows = dense_rows_np(rng, k, b)
    d = treg_tensors(torch, treg_deltas(rng, st_np, rows.astype(np.int64)), dev)
    ki = torch.from_numpy(rows).to(dev)
    pk, pp = DensePlan(_clone(st0)), DensePlan(_clone(st0))
    l0 = treg.drain_dense.launches
    tie_k, out_k = treg.drain_dense(pk, ki, *d)
    tie_p, out_p = treg.drain_dense_plain(pp, ki, *d)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(tie_k, tie_p), *zip(out_k, out_p), *zip(pk.state, pp.state)])
    ties = int(tie_k.sum().item())
    wins = changed(torch, st0, pk.state)
    if err or not ties or not wins:
        raise AssertionError(f"treg_drain_dense B={b}: err {err}, ties {ties}, wins {wins}")
    reset = restorer(pk.state, st0)
    call = lambda: treg.drain_dense(pk, ki, *d, out_k)  # noqa: E731
    ms = time_ms(torch, call, reset=reset)
    dev_ms = call_device_ms(torch, lambda: (reset(), call()),
                            ("treg_drain_dense", "treg_dense_clear"))
    launch_ms = launch_host_ms(torch, call)
    plain_ms = time_ms(torch, lambda: treg.drain_dense_plain(pp, ki, *d, out_p),
                       reset=restorer(pp.state, st0))
    nbytes, old_bytes = treg_dense_bytes(k, b, wins)
    b_ms, b_by = bound(nbytes, b * OPS_PER_REGISTER, card)
    row = dict(shape=f"K={k} B={b}", max_abs_err=err, kernel_ms=ms,
               device_ms=dev_ms["total"], slots_device_ms=dev_ms["treg_drain_dense"],
               clear_device_ms=dev_ms["treg_dense_clear"], launch_host_ms=launch_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
               old_bound_ms=bound(old_bytes, k * OPS_PER_REGISTER, card)[0],
               old_bytes=old_bytes, wins=wins, ties=ties,
               launches=treg.drain_dense.launches - l0)
    emit({"phase": "treg_drain_dense", **row, "card": card})
    del pk, pp, d
    return row


def treg_phases(torch, card: str) -> dict:
    """treg_drain_dense at K = 1,048,576 with staged batches of B = K / 4
    (the row kept), K / 2 and K, and treg_drain_sparse at B = 8,192
    (5,000 live) and B = 65,536, on the keyspace the TREG node phase
    gives them: each bit for bit against its plain version, then
    timed."""
    from jylis_tpu_torch.ops import treg
    from jylis_tpu_torch.utils.batching import pad_rows

    rng = np.random.default_rng(SEED + 10)
    dev = torch.device("cuda")
    st_np = treg_planes(rng, K_TREG)
    st0 = treg.TRegState(*treg_tensors(torch, st_np, dev))
    sk, sp = _clone(st0), _clone(st0)
    out = {}

    for b in dense_batches(K_TREG):
        row = treg_dense_case(torch, rng, st_np, st0, b, card)
        if "treg_drain_dense" in out:
            out["treg_drain_dense"].setdefault("other_shapes", []).append(row)
        else:
            out["treg_drain_dense"] = row

    for b, live in ((B_TREG_NODE, TREG_NEW), (B_LARGE, B_LARGE - B_LARGE // 16)):
        ki = pad_rows(b)
        ki[:live] = rng.choice(K_TREG, size=live, replace=False)
        ki[-1] = -1  # a negative row is a pad slot too
        rows = np.where(np.arange(b) < live, ki, 0)
        d = treg_tensors(torch, treg_deltas(rng, st_np, rows), dev)
        ki_t = torch.from_numpy(ki).to(dev)
        restorer(sk, st0)()
        restorer(sp, st0)()
        l0 = treg.drain_sparse.launches
        res_k = treg.drain_sparse(sk, ki_t, *d)
        res_p = treg.drain_sparse_plain(sp, ki_t, *d)
        torch.cuda.synchronize()
        err = max_abs_err(torch, [*zip(res_k, res_p), *zip(sk, sp)])
        ties = int(res_k[0].sum().item())
        wins = changed(torch, st0, sk)
        pads_zero = not any(x[live:].any().item() for x in res_k)
        if err or not ties or not wins or not pads_zero:
            raise AssertionError(
                f"treg_drain_sparse B={b}: err {err}, ties {ties}, wins {wins}, "
                f"pad slots zero {pads_zero}")
        ms = time_ms(torch, lambda: treg.drain_sparse(sk, ki_t, *d),
                     reset=restorer(sk, st0))
        dev_ms = device_ms(
            torch, lambda: (restorer(sk, st0)(), treg.drain_sparse(sk, ki_t, *d)),
            "treg_drain_sparse")
        plain_ms = time_ms(torch, lambda: treg.drain_sparse_plain(sp, ki_t, *d),
                           reset=restorer(sp, st0))
        # per slot: index read, tie and (ts, vid) written; per live slot:
        # delta read and row gathered; the row written where B wins
        nbytes = b * (4 + 1 + 12) + live * (20 + 20) + wins * 20
        b_ms, b_by = bound(nbytes, live * OPS_PER_REGISTER, card)
        row = dict(shape=f"K={K_TREG} B={b} live={live}", max_abs_err=err,
                   kernel_ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, wins=wins,
                   ties=ties, launches=treg.drain_sparse.launches - l0)
        emit({"phase": "treg_drain_sparse", **row, "card": card})
        if b == B_TREG_NODE:
            out["treg_drain_sparse"] = row
        else:
            out["treg_drain_sparse"]["other_shapes"] = [row]
    del st0, sk, sp
    torch.cuda.empty_cache()
    return out


def tensor_cells(rng, shape):
    """(val, ts_hi, ts_lo, rid) u32 planes: random f32 bits with NaN
    payloads, -0.0 and +0.0 mixed in; ts_hi 0, ts_lo in [0, 4) and rid in
    [0, 8) (bench.py's TENSOR delta shape), so equal timestamps with
    other rids are common."""
    val = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    special = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x00000000,
                        0x80000000], np.uint32)
    pick = rng.random(shape) < 0.1
    val[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
    return (val, np.zeros(shape, np.uint32),
            rng.integers(0, 4, size=shape, dtype=np.uint32),
            rng.integers(0, 8, size=shape, dtype=np.uint32))


def tensor_batch_case(torch, rng, n: int, b: int, live: int, card: str) -> dict:
    """tensor_converge_batch on ``live`` unique rows of an (n, T_DIM)
    state padded to ``b`` slots as the repo pads them: bit for bit
    against the plain version, then timed."""
    from jylis_tpu_torch.ops import tensor
    from jylis_tpu_torch.utils.batching import pad_rows

    dev = torch.device("cuda")

    def on_dev(p):
        return tensor.TensorState(
            *(torch.from_numpy(x.view(np.int32)).to(dev) for x in p))

    st0 = on_dev(tensor_cells(rng, (n, T_DIM)))
    dl = on_dev(tensor_cells(rng, (b, T_DIM)))
    ki = pad_rows(b)
    ki[:live] = rng.choice(n, size=live, replace=False)
    ki[-1] = -1
    ki_t = torch.from_numpy(ki).to(dev)
    sk, sp = _clone(st0), _clone(st0)
    l0 = tensor.converge_batch.launches
    tensor.converge_batch(sk, ki_t, *dl)
    tensor.converge_batch_plain(sp, ki_t, *dl)
    torch.cuda.synchronize()
    err = max_abs_err(torch, list(zip(sk, sp)))
    cells = changed(torch, st0, sk)
    if err or not cells:
        raise AssertionError(
            f"tensor_converge_batch N={n} B={b}: err {err}, cells changed {cells}")
    ms = time_ms(torch, lambda: tensor.converge_batch(sk, ki_t, *dl),
                 reset=restorer(sk, st0))
    dev_ms = device_ms(
        torch, lambda: (restorer(sk, st0)(), tensor.converge_batch(sk, ki_t, *dl)),
        "tensor_converge_batch")
    plain_ms = time_ms(torch, lambda: tensor.converge_batch_plain(sp, ki_t, *dl),
                       reset=restorer(sp, st0))
    nbytes = live * T_DIM * 48 + b * 4
    b_ms, b_by = bound(nbytes, live * T_DIM * OPS_PER_CELL, card)
    row = dict(shape=f"N={n} D={T_DIM} B={b} live={live}", max_abs_err=err,
               kernel_ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes, cells_changed=cells,
               launches=tensor.converge_batch.launches - l0)
    emit({"phase": "tensor_converge_batch", **row, "card": card})
    del st0, dl, sk, sp
    torch.cuda.empty_cache()
    return row


def tensor_batch_phases(torch, card: str) -> dict:
    """The gathered TENSOR join at the shape of the TENSOR node phase's
    first drain, and at bench.py's tensor-merge keyspace."""
    rng = np.random.default_rng(SEED + 11)
    row = tensor_batch_case(torch, rng, N_TENSOR_NODE, B_TENSOR_NODE,
                            TENSOR_ROWS_R1, card)
    row["other_shapes"] = [
        tensor_batch_case(torch, rng, T_KEYS, B_LARGE, B_LARGE - B_LARGE // 16, card)
    ]
    return {"tensor_converge_batch": row}


# ---- the TLOG kernels ------------------------------------------------------------


def tlog_rows_np(rng, k: int, length: int, lens, wide: bool):
    """A canonical TLOG state as numpy planes: row r holds lens[r]
    entries, ts non-increasing with runs of equal ts, vids strictly
    decreasing (so equal ts order by vid); a wide state's row 0 starts at
    ts 2^64-1 (CLR's wrap). Returns (planes, length, cutoff, ts, vid):
    u32 planes (PAD past each length), and the (k, L) ts and vids the
    rows were cut from (the deltas copy and perturb them)."""
    from jylis_tpu_torch.ops import tlog

    gaps = rng.integers(0, 3, (k, length)).astype(np.uint64)
    hi = (1 << 62) if wide else (1 << 32) - 2
    top = rng.integers(4 * length, hi, k).astype(np.uint64)
    if wide:
        top[0], gaps[0, 0] = U64, 0
    ts = top[:, None] - np.cumsum(gaps, 1, dtype=np.uint64)
    vid = (np.arange(length - 1, -1, -1)[None, :]
           + length * rng.integers(0, 1000, k)[:, None]).astype(np.int64)
    lens = np.asarray(lens, np.int64)
    live = np.arange(length)[None, :] < lens[:, None]
    nt = ~ts
    pl = [(nt >> np.uint64(32)).astype(np.uint32), nt.astype(np.uint32),
          tlog.encode_vid_np(vid)]
    pl = [np.where(live, p, np.uint32(0xFFFFFFFF)) for p in (pl if wide else pl[1:])]
    last = ts[np.arange(k), np.maximum(lens - 1, 0)]
    cut = np.where((lens > 0) & (rng.random(k) < 0.5), last - (last > 0), 0)
    return pl, lens.astype(np.int32), cut.astype(np.uint64), ts, vid


def tlog_delta_np(rng, ts, vid, lens, rows, ld: int):
    """(d_ts, d_vid, d_cut) delta rows for ``rows``: fresh entries near
    the row's own timestamps (some below its cutoff), copies of the
    row's entries (duplicates against the state), copies of the previous
    column (duplicates inside the delta), vid -1 slots, and a fifth of
    the rows with a raised cutoff (at one of its entries)."""
    n, length = len(rows), ts.shape[1]
    pick = rng.integers(0, length, (n, ld))
    d_ts = ts[rows[:, None], pick] + rng.integers(0, 3, (n, ld)).astype(np.uint64)
    d_vid = rng.integers(0, 1 << 30, (n, ld)).astype(np.int64)
    lens = np.asarray(lens)[rows]
    kind = rng.random((n, ld))
    own = (kind < 0.3) & (lens[:, None] > 0)
    at = (rng.random((n, ld)) * np.maximum(lens, 1)[:, None]).astype(np.int64)
    d_ts[own] = ts[rows[:, None], at][own]
    d_vid[own] = vid[rows[:, None], at][own]
    if ld > 1:
        rep = (kind >= 0.3) & (kind < 0.45)
        rep[:, 0] = False
        src = np.where(rep)
        d_ts[src], d_vid[src] = d_ts[src[0], src[1] - 1], d_vid[src[0], src[1] - 1]
    d_vid[kind > 0.9] = -1
    at = (rng.random(n) * np.maximum(lens, 1)).astype(np.int64)
    d_cut = np.where(rng.random(n) < 0.2, ts[rows, at], 0).astype(np.uint64)
    return d_ts, d_vid, d_cut


def tlog_counts_np(rng, n: int) -> np.ndarray:
    """Trim counts: TRIM to 512 (bench.py:1035) on all but 1 in 16 slots,
    which take CLR (0), 1, counts above the length, negative, and the
    no-op sentinel and above."""
    from jylis_tpu_torch.ops import tlog

    edge = np.array([0, 1, 3, 2000, -1, tlog.TRIM_NOOP, tlog.TRIM_NOOP + 7,
                     1 << 40], np.int64)
    out = np.full(n, TLOG_TRIM, np.int64)
    pick = rng.random(n) < 1 / 16
    out[pick] = edge[rng.integers(0, len(edge), int(pick.sum()))]
    return out


def _tensors(st):
    return [x for x in st if x is not None]


def tlog_case(torch, rng, wide: bool, dense: bool, k: int, length: int,
              b: int, live: int, ld: int, card: str) -> dict:
    """tlog_drain_<dense|sparse> at one shape: a canonical state with
    uneven rows (some near L: both overflow rules fire), a delta over
    ``live`` rows (sparse: padded to ``b`` slots as the repo pads them,
    plus a negative pad), trim counts per row; bit for bit against the
    plain version, then timed on a fresh state copy per call."""
    from jylis_tpu_torch.ops import planes, tlog
    from jylis_tpu_torch.utils.batching import pad_rows

    dev = torch.device("cuda")
    nplanes = 3 if wide else 2
    lens = np.zeros(k, np.int64)
    lens[:live] = rng.integers(0, min(900, length // 2) + 1, live)
    near = rng.random(k) < 0.04
    near[live:] = False
    cap = length - (ld if dense else 0)
    lens[near] = rng.integers(max(cap - 40, 0), length + 1, int(near.sum()))
    pl, lens32, cut, ts, vid = tlog_rows_np(rng, k, length, lens, wide)
    st0 = tlog.TLogState(
        *([] if wide else [None]),
        *(torch.from_numpy(p.view(np.int32)).to(dev) for p in pl),
        torch.from_numpy(lens32).to(dev), planes.to_tensor(cut, dev))
    rows = np.arange(live)
    if not dense:
        rng.shuffle(rows)
    d_ts, d_vid, d_cut = tlog_delta_np(rng, ts, vid, lens, rows, ld)
    if ld == 1:  # a socket TRIM's drain carries no entries
        d_vid[:] = -1
    counts = tlog_counts_np(rng, live)
    if dense:
        # aligned rows: rows >= live get no delta (vid -1) and no trim
        full = [np.zeros((k, ld), np.uint64), np.full((k, ld), -1, np.int64),
                np.zeros(k, np.uint64)]
        full[0][:live], full[1][:live], full[2][:live] = d_ts, d_vid, d_cut
        d_ts, d_vid, d_cut = full
        trim_ki = np.arange(live, dtype=np.int32)
        cnt_rows = np.full(k, tlog.TRIM_NOOP, np.int64)
        cnt_rows[:live] = counts
        slot_rows, slot_counts = np.arange(k), cnt_rows
    else:
        ki = pad_rows(b)
        ki[:live] = rows
        if live < b:
            ki[-1] = -1
        pad = np.zeros((b - live,), np.int64)
        d_ts = np.concatenate([d_ts, np.zeros((b - live, ld), np.uint64)])
        d_vid = np.concatenate([d_vid, np.full((b - live, ld), -1, np.int64)])
        d_cut = np.concatenate([d_cut, pad.astype(np.uint64)])
        counts = np.concatenate([counts, pad + tlog.TRIM_NOOP])
        slot_rows, slot_counts = rows, counts[:live]
    dt = (planes.to_tensor(d_ts, dev), torch.from_numpy(d_vid).to(dev),
          planes.to_tensor(d_cut, dev))
    extra = ((torch.from_numpy(trim_ki).to(dev), torch.from_numpy(counts).to(dev))
             if dense else (torch.from_numpy(counts).to(dev),))
    if dense:
        kern, plain = tlog.drain_dense, tlog.drain_dense_plain

        def run(st, fn):
            return (fn(st, *dt, *extra),)
    else:
        kern, plain = tlog.drain_sparse, tlog.drain_sparse_plain
        ki_t = torch.from_numpy(ki).to(dev)

        def run(st, fn):
            return fn(st, ki_t, *dt, *extra)
    sk = tlog.TLogState(*(None if x is None else x.clone() for x in st0))
    sp = tlog.TLogState(*(None if x is None else x.clone() for x in st0))
    l0 = kern.launches
    out_k = run(sk, kern)
    out_p = run(sp, plain)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [*zip(out_k, out_p), *zip(_tensors(sk), _tensors(sp))])
    ovf = out_k[0].cpu().numpy()
    n_ovf = int(ovf.sum())
    name = f"tlog_drain_{'dense' if dense else 'sparse'}"
    shape = (f"K={k} L={length} Ld={ld} {'wide' if wide else 'narrow'}"
             + ("" if dense else f" B={b} live={live}"))
    if err or (live > 100 and not (0 < n_ovf < live)):
        raise AssertionError(f"{name} {shape}: err {err}, overflow rows {n_ovf}")
    if not dense and (out_k[1][live:].any() or out_k[2][live:].any() or ovf[live:].any()):
        raise AssertionError(f"{name} {shape}: pad slots must report 0")
    nbytes, nops, active, diff = tlog_work(
        torch, st0, sk, lens, cut, slot_rows, d_ts, d_vid, d_cut, slot_counts, ovf,
        k if dense else b, dense)
    reset = restorer(_tensors(sk), _tensors(st0))
    ms = time_ms(torch, lambda: run(sk, kern), reset=reset)
    dev_ms = device_ms(torch, lambda: (reset(), run(sk, kern)), "tlog_drain")
    plain_ms = time_ms(torch, lambda: run(sp, plain),
                       reset=restorer(_tensors(sp), _tensors(st0)))
    b_ms, b_by = bound(nbytes, nops, card)
    plan = tlog.drain_plan(k if dense else b, length, ld, nplanes).rows
    row = dict(shape=shape, max_abs_err=err, kernel_ms=ms, device_ms=dev_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
               operations=nops, overflow_rows=n_ovf, rows_merged=int(active.sum()),
               rows_changed=int(diff.sum()), launches=kern.launches - l0,
               **{"class": row_class(plan)})
    emit({"phase": name, **row, "card": card})
    del st0, sk, sp, dt, extra
    torch.cuda.empty_cache()
    return row


def row_class(plan) -> str:
    """A row kernel's launch class (ops/row_plan.py) as a label: "warp x2"
    (rows a CTA), "cta x1", "cluster of 16" (CTAs a row; "in device
    scratch" where the shares live there)."""
    if plan.kind == "cluster":
        return f"cluster of {plan.cluster}" + (" in device scratch" if plan.scratch else "")
    return f"{plan.kind} x{plan.rows_per_cta}"


def tlog_work(torch, before, after, lens, cut, slot_rows, d_ts, d_vid, d_cut,
              slot_counts, ovf, nslots: int, dense: bool):
    """(bytes, compares, merged rows, changed rows) of one tlog_drain
    launch, by the least work this run's data needs: every
    slot's delta and scalars; the state row where the kernel merges it
    (a valid delta entry, a raised cutoff or a trim), written back where
    it changed. ``before`` / ``after``: the state around the drain;
    ``slot_rows``, the delta arrays, ``slot_counts`` and ``ovf``: the live
    slots, in slot order; ``nslots``: the launch's slots, pads included."""
    from jylis_tpu_torch.ops import tlog

    k, length = before.ntl.shape
    nplanes = 3 if before.wide else 2
    ld = d_ts.shape[1]
    new_len = after.length.cpu().numpy().astype(np.int64)
    diff = torch.zeros(k, dtype=torch.bool, device=before.ntl.device)
    for a, c in zip(_tensors(before)[:nplanes], _tensors(after)[:nplanes]):
        diff |= (a != c).any(1)
    diff = diff.cpu().numpy()
    sr = np.asarray(slot_rows)
    n = len(sr)
    cut_v = np.maximum(cut[sr], d_cut[:n])
    d_valid = ((d_vid[:n] >= 0) & (d_ts[:n] >= cut_v[:, None])).any(1)
    flagged = np.asarray(ovf)[:n].astype(bool)
    active = d_valid | (cut_v > cut[sr]) | (np.asarray(slot_counts)[:n] < tlog.TRIM_NOOP)
    if dense:
        active &= ~flagged
    old = np.asarray(lens)[sr]
    nbytes = n * (ld * 16 + 28) + (nslots if dense else nslots * 17)
    nbytes += int((old[active] * nplanes * 4).sum()) + 12 * int((active & ~flagged).sum())
    nbytes += int((np.maximum(old, new_len[sr])[diff[sr]] * nplanes * 4).sum())
    # per merged row: a sort of its valid delta entries (a merge sort's v
    # log2 v compares, the least a sort needs), a filter per column, a
    # search per valid entry, and per old and merged entry
    nvd = ((d_vid[:n] >= 0) & (d_ts[:n] >= cut_v[:, None])).sum(1)[active]
    lg = (length + ld).bit_length()
    sort = np.where(nvd > 1, nvd * np.ceil(np.log2(np.maximum(nvd, 2))), 0)
    nops = int(sort.sum()) + int(active.sum()) * ld + int(nvd.sum()) * lg
    nops += int((old[active] + new_len[sr][active] * lg).sum())
    return nbytes, nops, active, diff


@contextlib.contextmanager
def forced_cluster(*mods):
    """Every row the wrappers of ``mods`` (ops/tlog.py,
    ops/ujson_device.py) launch takes the cluster class while the block
    runs: their WARP_ROW_BYTES and CTA_ROW_BYTES at 0."""
    saved = [(m, m.WARP_ROW_BYTES, m.CTA_ROW_BYTES) for m in mods]
    for m in mods:
        m.WARP_ROW_BYTES = m.CTA_ROW_BYTES = 0
    try:
        yield
    finally:
        for m, w, c in saved:
            m.WARP_ROW_BYTES, m.CTA_ROW_BYTES = w, c


def tlog_edge_case(torch, card: str) -> dict:
    """tlog_drain_sparse's cluster class at its partition edges: 8 wide
    rows of L = Ld = 256 forced into clusters of 8 (32 delta and 32
    state slots a CTA); per row a TRIM 1, a TRIM at the merged row's
    last entry, a CLR, a cutoff raised to the merged row's first and to
    its last entry, a delta of three entries repeated over every CTA's
    share, a row the sparse rule flags, and a plain merge; bit for bit
    against the plain drain, then timed."""
    from jylis_tpu_torch.ops import planes, tlog

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 22)
    k, length, ld = 8, 256, 256
    lens = np.array([40, 60, 60, 50, 70, 30, 230, 80])
    pl, lens32, cut, ts, vid = tlog_rows_np(rng, k, length, lens, True)
    st0 = tlog.TLogState(*(torch.from_numpy(p.view(np.int32)).to(dev) for p in pl),
                         torch.from_numpy(lens32).to(dev), planes.to_tensor(cut, dev))
    rows = np.arange(k)
    d_ts, d_vid, d_cut = tlog_delta_np(rng, ts, vid, lens, rows, ld)
    d_cut[:] = 0
    pick = rng.integers(0, 3, ld)
    d_ts[5], d_vid[5] = d_ts[5, pick], np.abs(d_vid[5, pick])
    ki = torch.from_numpy(rows.astype(np.int32)).to(dev)
    dt = [planes.to_tensor(d_ts, dev), torch.from_numpy(d_vid).to(dev),
          planes.to_tensor(d_cut, dev)]
    noop = torch.full((k,), tlog.TRIM_NOOP, dtype=torch.int64, device=dev)
    merged = tlog.TLogState(*(x.clone() for x in st0))
    tlog.drain_sparse_plain(merged, ki, *dt, noop)
    m = merged.length.cpu().numpy().astype(np.int64)
    counts = np.full(k, tlog.TRIM_NOOP, np.int64)
    counts[0], counts[1], counts[2] = 1, max(m[1], 1), 0
    mts = tlog.decode_ts_np(merged.nth.cpu().numpy(), merged.ntl.cpu().numpy())
    d_cut[3], d_cut[4] = mts[3, 0], mts[4, max(m[4] - 1, 0)]
    dt[2] = planes.to_tensor(d_cut, dev)
    cnt = torch.from_numpy(counts).to(dev)
    sk = tlog.TLogState(*(x.clone() for x in st0))
    sp = tlog.TLogState(*(x.clone() for x in st0))
    with forced_cluster(tlog):
        plan = tlog.drain_plan(k, length, ld, 3).rows
        l0 = tlog.drain_sparse.launches
        out_k = tlog.drain_sparse(sk, ki, *dt, cnt)
        launched = tlog.drain_sparse.launches - l0
        out_p = tlog.drain_sparse_plain(sp, ki, *dt, cnt)
        torch.cuda.synchronize()
        err = max_abs_err(torch, [*zip(out_k, out_p), *zip(_tensors(sk), _tensors(sp))])
        ovf = out_k[0].cpu().numpy()
        if err or plan.kind != "cluster" or launched != 1 or not ovf[6] or ovf.sum() != 1:
            raise AssertionError(f"tlog_drain_sparse partition edges: err {err}, "
                                 f"{plan.kind}, launches {launched}, overflow {ovf}")
        reset = restorer(_tensors(sk), _tensors(st0))
        ms = time_ms(torch, lambda: tlog.drain_sparse(sk, ki, *dt, cnt), reset=reset)
    plain_ms = time_ms(torch, lambda: tlog.drain_sparse_plain(sp, ki, *dt, cnt),
                       reset=restorer(_tensors(sp), _tensors(st0)))
    row = dict(shape=f"partition edges: K={k} L=Ld={ld} wide, trims and cutoffs at the "
                     "first and last CTA's share, a delta of repeats, an overflow",
               max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms, launches=launched,
               **{"class": row_class(plan)})
    emit({"phase": "tlog_drain_sparse", **row, "card": card})
    return row


def tlog_phases(torch, card: str) -> dict:
    """Both TLOG drains at BASELINE config 4's device size (K = 16,384
    rows for 10,000 keys, L = 1,024; sparse at B = 16,384 with Ld = 128,
    dense with Ld = 64; TRIM counts of 512), narrow and wide, the dense
    drain at the node phase's L = 512, the shape a socket TRIM gives the
    sparse drain (B = 16, one live row, no entries),
    and a row wider than shared memory holds (L = Ld = 65,536, wide: a
    cluster of 16 CTAs); then the class boundaries, and the cluster
    class's partition edges."""
    rng = np.random.default_rng(SEED + 20)
    out = {}
    for dense, name in ((False, "tlog_drain_sparse"), (True, "tlog_drain_dense")):
        ld = LD_DENSE if dense else LD_SPARSE
        rows = [tlog_case(torch, rng, wide, dense, K_TLOG, L_TLOG, B_TLOG,
                          TLOG_KEYS, ld, card) for wide in (False, True)]
        out[name] = rows[0]
        out[name]["other_shapes"] = rows[1:]
    # the node phase's dense rounds run at L <= 512 (its retry's shape)
    out["tlog_drain_dense"]["other_shapes"].append(
        tlog_case(torch, rng, False, True, K_TLOG, 512, K_TLOG, TLOG_KEYS,
                  LD_DENSE, card))
    for wide in (False, True):
        out["tlog_drain_sparse"]["other_shapes"].append(
            tlog_case(torch, rng, wide, False, K_TLOG, L_TLOG, 16, 1, 1, card))
    out["tlog_drain_sparse"]["other_shapes"].append(
        tlog_case(torch, rng, True, False, 4, 1 << 16, 4, 3, 1 << 16, card))
    # the class boundaries (ops/tlog.py drain_plan): the widest L the warp
    # class takes at Ld = 128 and the next L, narrow and wide; Ld = 256
    # (8 delta entries a lane) and 257 (a CTA per row); the dense drain at
    # the crossover
    for wide in (False, True):
        lx = tlog_warp_max_len(3 if wide else 2, LD_SPARSE)
        for length in (lx, lx + 4):
            out["tlog_drain_sparse"]["other_shapes"].append(
                tlog_case(torch, rng, wide, False, 2048, length, 2048, 2000, LD_SPARSE, card))
    for ld in (256, 257):
        out["tlog_drain_sparse"]["other_shapes"].append(
            tlog_case(torch, rng, False, False, 2048, L_TLOG, 2048, 2000, ld, card))
    lx = tlog_warp_max_len(2, LD_DENSE)
    for length in (lx, lx + 4):
        out["tlog_drain_dense"]["other_shapes"].append(
            tlog_case(torch, rng, False, True, 2048, length, 2048, 2000, LD_DENSE, card))
    out["tlog_drain_sparse"]["other_shapes"].append(tlog_edge_case(torch, card))
    return out


def tlog_warp_max_len(nplanes: int, ld: int, b: int = 2048) -> int:
    """The widest L (a multiple of 4) whose rows the warp class of
    tlog_drain takes at Ld = ``ld`` in a launch of ``b`` slots."""
    from jylis_tpu_torch.ops import tlog

    length = 4
    while tlog.drain_plan(b, length + 4, ld, nplanes).rows.kind == "warp":
        length += 4
    return length


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

    def _fill(self) -> None:
        """Read what the socket has into the buffer."""
        data = self.sock.recv(1 << 16)
        if not data:
            raise ConnectionError("server closed the connection")
        self.buf += data

    def _line(self) -> bytes:
        """One CRLF-terminated line, without its CRLF."""
        while b"\r\n" not in self.buf:
            self._fill()
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def reply(self) -> bytes:
        """One whole RESP reply, its raw bytes: a line, a bulk string or
        an array of replies."""
        line = self._line()
        out = line + b"\r\n"
        if line[:1] == b"$" and int(line[1:]) >= 0:
            n = int(line[1:]) + 2
            while len(self.buf) < n:
                self._fill()
            out += self.buf[:n]
            self.buf = self.buf[n:]
        elif line[:1] == b"*":
            out += b"".join(self.reply() for _ in range(int(line[1:])))
        return out

    def pipeline(self, cmds, chunk: int = 256) -> list[bytes]:
        """Send ``cmds`` in pipelined chunks and read each chunk's whole
        replies before the next (so neither side's buffers fill up)."""
        out = []
        for i in range(0, len(cmds), chunk):
            part = cmds[i : i + chunk]
            self.sock.sendall(b"".join(resp_cmd(*c) for c in part))
            out += [self.reply() for _ in part]
        return out

    def close(self) -> None:
        self.sock.close()


class Node:
    """The port's RESP Server with its state on DEVICE, serving from an
    event loop in a thread, and a raw-socket client to it."""

    def __init__(self, identity: int, mesh=None, device=None):
        from jylis_tpu_torch.models.database import Database
        from jylis_tpu_torch.server.server import Server
        from jylis_tpu_torch.utils.config import Config

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        # the native serving engine, as a node runs by default
        self.db = Database(identity=identity, device=device or DEVICE, mesh=mesh,
                           engine="auto")
        self.server = Server(Config(port="0"), self.db)
        self.run(self.server.start())
        self.client = Client(self.server.port)
        # a probe burst the engine settles in C++ (an absent key: no
        # state changes), so a phase whose commands all defer to Python
        # (TENSOR has no native table) still shows its engine serving
        if self.client.pipeline([("GCOUNT", "GET", PROBE_KEY)]) != [b":0\r\n"]:
            raise AssertionError("the probe burst's reply is not :0")
        self.served = None

    def serving(self) -> dict:
        """The node's engine mode and SERVING split; fails unless the
        native engine settled commands."""
        out = {"engine": "native" if self.db.native_engine is not None else "python",
               **self.db.serving_totals()}
        if out["engine"] != "native" or out["native_cmds"] < 1:
            raise AssertionError(f"a node served no command natively: {out}")
        return out

    def run(self, coro, timeout: float = 600):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def converge(self, name: str, batch) -> None:
        """One anti-entropy batch through Database.converge_async (which
        drains in a worker thread when the repo's window trips)."""
        self.run(self.db.converge_async(name, batch))

    def repo(self, name: str):
        return self.db.manager(name).repo

    def close(self) -> None:
        self.served = self.serving()
        self.client.close()
        self.run(self.server.dispose())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()


def check_replies(what: str, got, want) -> None:
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError(f"{what} reply {bad}: {got[bad][:80]!r} != {want[bad][:80]!r}")


def bulk(b: bytes) -> bytes:
    return b"$%d\r\n%s\r\n" % (len(b), b)


def prefix_rank(v: bytes) -> int:
    """The big-endian first 8 bytes, zero padded (the register's rank)."""
    return int.from_bytes((v[:8] + bytes(8))[:8], "big")



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
        if b":%d\r\n" % repo._get_value(key) != expect(name, key):
            raise AssertionError(f"{name} served value of {key} != reference")
    return len(keys)


def node_phase(torch) -> dict:
    from jylis_tpu_torch.ops import gcount, pncount

    rng = np.random.default_rng(SEED + 3)
    identity = 0x5EED
    rids = [int(x) for x in rng.integers(1 << 40, 1 << 62, NODE_REPLICAS)]
    keys = [b"k%06d" % i for i in range(NODE_KEYS)]
    node = Node(identity)
    client = node.client
    # reference: per type, per polarity, key -> {rid: value}
    ref = {"GCOUNT": ({},), "PNCOUNT": ({}, {})}

    def expect(name: str, key: bytes) -> bytes:
        pols = ref[name]
        tot = [sum(pol.get(key, {}).values()) & U64 for pol in pols]
        v = tot[0] if name == "GCOUNT" else signed(tot[0] - tot[1])
        return b":%d\r\n" % v

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
            node.converge(name, batch[i : i + 10_000])

    try:
        # local writes
        replies = client.pipeline([
            ("GCOUNT", "INC", "g0", 5), ("GCOUNT", "GET", "g0"),
            ("PNCOUNT", "INC", "p0", 10), ("PNCOUNT", "DEC", "p0", 15),
            ("PNCOUNT", "GET", "p0"), ("GCOUNT", "INC", "g0", U64),
            ("GCOUNT", "GET", "g0"),
        ])
        want = [b"+OK\r\n", b":5\r\n", b"+OK\r\n", b"+OK\r\n", b":-5\r\n",
                b"+OK\r\n", b":4\r\n"]
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
        if set(client.pipeline(cmds)) != {b"+OK\r\n"}:
            raise AssertionError("INC/DEC on converged keys not acknowledged")

        reset_counts(gcount.drain_dense, gcount.drain_sparse, pncount.drain_dense,
                     pncount.drain_sparse)
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
        if DEVICE == "cuda" and (min(launches.values()) < 1 or min(dense) < 1):
            raise AssertionError(f"a drain kernel never launched: {launches}")
        for name in ("GCOUNT", "PNCOUNT"):
            repo = node.repo(name)
            for plane in repo._state:
                if plane.device.type != DEVICE:
                    raise AssertionError(f"{name} state on {plane.device}")
            capacity[name] = (repo._key_cap, repo._rep_cap)
            if capacity[name] != (K_NODE, R_NODE):
                raise AssertionError(
                    f"{name} capacity {capacity[name]} is not the shape the "
                    f"kernel phases held against plain ({K_NODE}, {R_NODE})"
                )
            checked += check_full_state(name, repo, ref, expect)
    finally:
        node.close()
    out = {
        "launches": launches, "keys": NODE_KEYS, "replicas": NODE_REPLICAS,
        "gets_checked": 2 * (len(sample) + len(more)) + 7,
        "rows_checked": checked,
        "converge_s": converge_s, "dense_get_s": dense_get_s,
        "capacity": capacity,
    }
    out["serving"] = node.served
    emit({"phase": "node", **out})
    return out


def treg_node_phase(torch, n_keys: int = TREG_KEYS) -> dict:
    """BASELINE config 3: n_keys TREG registers, random-timestamp merge
    through Database.converge_async (round 1: every key, the dense drain
    at K = 1,048,576; round 2: contending deltas on 30% of the keys, a
    third at an equal ts with a value sharing its 8-byte prefix, so the
    host settles device ties and patches vids; round 3: 5,000 new keys,
    the sparse drain), then local SET/GET over a raw socket, every reply
    against a Python reference, then the whole device state read back
    and held against the reference for every key."""
    from jylis_tpu_torch.ops import planes, treg

    rng = np.random.default_rng(SEED + 12)
    keys = [b"r%07d" % i for i in range(n_keys)]
    ref: dict[bytes, tuple[int, bytes]] = {}  # key -> LWW winner (ts, value)

    def put(key, ts, value):
        cur = ref.get(key)
        if cur is None or (ts, value) > cur:
            ref[key] = (ts, value)

    def values(n, replicas):
        """An 8-byte random prefix, the writing replica's tag, 0-7 more
        bytes: ranks >= 2^63 for half of them."""
        raw = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
        raw[:, 8] = replicas
        lens = rng.integers(9, 17, n)
        return [row[:ln].tobytes() for row, ln in zip(raw, lens)]

    def timestamps(n):
        ts = u64_np(rng, n)
        pool = rng.random(n)
        ts[pool < 0.05] = 0  # a set register at ts 0
        ts[(pool >= 0.05) & (pool < 0.1)] = U64
        return [int(t) for t in ts]

    node = Node(identity=0x7E6)
    try:
        reset_counts(treg.drain_dense, treg.drain_sparse)
        t0 = time.perf_counter()
        vals = values(n_keys, rng.integers(0, NODE_REPLICAS, n_keys))
        batch = list(zip(keys, zip(vals, timestamps(n_keys))))
        for key, (v, ts) in batch:
            put(key, ts, v)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        node.converge("TREG", batch)
        r1_s = time.perf_counter() - t0
        r1 = (treg.drain_dense.launches, treg.drain_sparse.launches)

        # round 2: a third ties (equal ts, shared prefix), a third newer,
        # a third older
        sel = rng.choice(n_keys, int(n_keys * TREG_CONTEND), replace=False)
        kind = rng.integers(0, 3, len(sel))
        fresh = values(len(sel), rng.integers(0, NODE_REPLICAS, len(sel)))
        batch, ties = [], 0
        for i, k, v in zip(sel.tolist(), kind.tolist(), fresh):
            key = keys[i]
            ts, cur = ref[key]
            if k == 0:
                v = cur[:8] + v[8:]
                if v == cur:
                    v += b"!"
                ties += 1
            elif k == 1:
                ts = min(ts + 1, U64)
            else:
                ts = max(ts - 1, 0)
            batch.append((key, (v, ts)))
            put(key, ts, v)
        patched = sum(1 for (key, (v, ts)), k in zip(batch, kind.tolist())
                      if k == 0 and ref[key] == (ts, v))
        t0 = time.perf_counter()
        node.converge("TREG", batch)
        r2_s = time.perf_counter() - t0
        r2 = (treg.drain_dense.launches, treg.drain_sparse.launches)

        # round 3: new keys, above the drain threshold, under K / 4
        new = [b"n%06d" % i for i in range(TREG_NEW)]
        batch = list(zip(new, zip(values(TREG_NEW, rng.integers(0, 8, TREG_NEW)),
                                  timestamps(TREG_NEW))))
        for key, (v, ts) in batch:
            put(key, ts, v)
        t0 = time.perf_counter()
        node.converge("TREG", batch)
        r3_s = time.perf_counter() - t0
        r3 = (treg.drain_dense.launches, treg.drain_sparse.launches)

        # local SET/GET over the socket
        cmds = []
        old = rng.choice(n_keys, 200, replace=False).tolist()
        for j, i in enumerate(old):
            key = keys[i]
            ts, cur = ref[key]
            v = cur[:8] + b"local%d" % j if j % 2 else b"\xfelocal%d" % j
            ts = (ts, min(ts + 1, U64), max(ts - 1, 0))[j % 3]
            cmds.append(("TREG", "SET", key, v, ts))
            put(key, ts, v)
        for j in range(100):
            key, v, ts = b"s%03d" % j, b"v%d" % j, int(rng.integers(0, 1 << 63))
            cmds.append(("TREG", "SET", key, v, ts))
            put(key, ts, v)
        got = node.client.pipeline(cmds)
        check_replies("TREG SET", got, [b"+OK\r\n"] * len(cmds))
        sample = [keys[i] for i in rng.choice(n_keys, 3000, replace=False)]
        sample += [c[2] for c in cmds] + new[:100] + [b"missing"]
        t0 = time.perf_counter()
        got = node.client.pipeline([("TREG", "GET", k) for k in sample])
        get_s = time.perf_counter() - t0
        want = [b"$-1\r\n" if k not in ref else
                b"*2\r\n" + bulk(ref[k][1]) + b":%d\r\n" % ref[k][0]
                for k in sample]
        check_replies("TREG GET", got, want)

        # the whole device state against the reference
        repo = node.repo("TREG")
        repo.drain()  # the socket's SETs: one more sparse drain
        launches = {"treg_drain_dense": treg.drain_dense.launches,
                    "treg_drain_sparse": treg.drain_sparse.launches}
        t0 = time.perf_counter()
        st = repo._state
        for plane in st:
            if plane.device.type != DEVICE:
                raise AssertionError(f"TREG state on {plane.device}")
        if n_keys == TREG_KEYS and repo._key_cap != K_TREG:
            raise AssertionError(
                f"TREG capacity {repo._key_cap} is not the shape the kernel "
                f"phase held against plain ({K_TREG})")
        ts, rank = planes.to_u64_np(st.ts), planes.to_u64_np(st.rank)
        vid = st.vid.cpu().numpy()
        rows = repo._tbl.rows()
        order = [repo._tbl.key_of(r) for r in range(rows)]
        if len(order) != len(ref) or set(order) != set(ref):
            raise AssertionError("TREG table keys != reference keys")
        win = [ref[k] for k in order]
        if not np.array_equal(ts[:rows], np.fromiter((w[0] for w in win), np.uint64, rows)):
            raise AssertionError("TREG device ts != reference")
        if not np.array_equal(rank[:rows], np.fromiter(
                (prefix_rank(w[1]) for w in win), np.uint64, rows)):
            raise AssertionError("TREG device rank != reference")
        if [repo._interner.lookup(v) for v in vid[:rows].tolist()] != [w[1] for w in win]:
            raise AssertionError("TREG device vid != reference value")
        if ts[rows:].any() or rank[rows:].any() or (vid[rows:] != -1).any():
            raise AssertionError("TREG rows past the keys are not unset")
        if [repo._cache[r] for r in range(rows)] != list(
                zip(ts[:rows].tolist(), vid[:rows].tolist())):
            raise AssertionError("TREG mirror cache != device state")
        check_s = time.perf_counter() - t0
    finally:
        node.close()
    if DEVICE == "cuda" and (r1 != (1, 0) or r2 != (2, 0) or r3 != (2, 1)
                             or launches["treg_drain_sparse"] != 2):
        raise AssertionError(
            f"TREG drains: rounds {r1} {r2} {r3}, then {launches}: expected "
            "dense, dense, sparse, sparse")
    out = {"launches": launches, "keys": len(ref), "capacity": repo._key_cap,
           "ties": ties, "ties_won": patched, "gets_checked": len(sample),
           "sets_checked": len(cmds), "generate_s": gen_s, "round1_s": r1_s,
           "round2_s": r2_s, "round3_s": r3_s, "get_s": get_s,
           "check_s": check_s}
    out["serving"] = node.served
    emit({"phase": "treg_node", **out})
    return out


# ---- TENSOR node phase: a reference of the lattice, written out ---------------

CANON_NAN = 0x7FC00000


def canon(u: np.ndarray) -> np.ndarray:
    """Every NaN payload collapses to the one canonical quiet NaN."""
    u = u.copy()
    nan = ((u & 0x7F800000) == 0x7F800000) & ((u & 0x007FFFFF) != 0)
    u[nan] = CANON_NAN
    return u


def lww_take(a, b) -> np.ndarray:
    """Per cell: B's (ts, rid, okey(val)) lexicographically greater."""
    av, ats, ar = a
    bv, bts, br = b
    return (bts > ats) | ((bts == ats) & (
        (br > ar) | ((br == ar) & (okey_np(bv) > okey_np(av)))))


def avg_read(contribs: dict) -> tuple[bytes, int]:
    """The AVG value: sum(ts_i * v_i) / sum(ts_i) in f64 over sorted
    rids (the unweighted mean when every ts is 0), as canonical f32."""
    acc = np.zeros(T_DIM, np.float64)
    wtot, tmax = 0.0, 0
    with np.errstate(invalid="ignore", over="ignore"):
        for rid in sorted(contribs):
            ts, vec = contribs[rid]
            acc += float(ts) * vec.view("<f4").astype(np.float64)
            wtot += float(ts)
            tmax = max(tmax, ts)
        if wtot == 0.0:
            acc = sum(contribs[r][1].view("<f4").astype(np.float64)
                      for r in sorted(contribs))
            wtot = float(len(contribs))
        out = (acc / wtot).astype("<f4").view(np.uint32)
    return canon(out).tobytes(), tmax


def varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | 0x80 if v else b)
        if not v:
            return bytes(out)


def max_blob(val: np.ndarray) -> bytes:
    """delta/TENSOR bytes of a MAX value (mode 1): mode, dim, val, empty
    ts and rid, no contributions."""
    raw = val.astype("<u4").tobytes()
    return varint(1) + varint(len(val)) + varint(len(raw)) + raw + b"\x00\x00\x00"


def tensor_node_phase(torch, n_keys: int = TENSOR_KEYS) -> dict:
    """n_keys TENSOR keys x 64 dims from 8 replica ids (70% LWW, 20% MAX,
    10% AVG with 4 contributors each) through Database.converge_async;
    round 2 contends on a fifth of them (equal ts under another rid, NaN
    payloads, newer AVG contributions) and flips a few MAX keys to LWW
    (a dominance flip retires their device rows); then SET/MRG/GET over a
    raw socket, with both BADSHAPE replies and a BADPAYLOAD, every reply
    against the reference above; then every live device row against the
    mirror rule of the repo's drain."""
    from jylis_tpu_torch.ops import tensor
    from jylis_tpu_torch.ops.tensor_host import Tensor

    rng = np.random.default_rng(SEED + 13)
    D = T_DIM
    rids = [int(x) for x in rng.integers(1 << 40, 1 << 62, NODE_REPLICAS)]
    rid32 = np.array([r & 0xFFFFFFFF for r in rids], np.uint32)
    keys = [b"v%06d" % i for i in range(n_keys)]
    kind = np.where(np.arange(n_keys) % 10 < 7, 2, np.where(np.arange(n_keys) % 10 < 9, 1, 3))
    lww, mx, avg = (np.flatnonzero(kind == m) for m in (2, 1, 3))
    bottom = np.full(D, 0xFFFFFFFF, np.uint32)
    # reference state: LWW (val, ts, rid) and MAX val per key; AVG
    # contributions per key; the mode of each key
    ref_l = {keys[i]: (bottom.copy(), np.zeros(D, np.uint64), np.zeros(D, np.uint32))
             for i in lww}
    ref_m = {keys[i]: bottom.copy() for i in mx}
    ref_a = {keys[i]: {} for i in avg}

    def f32(n):
        v = rng.standard_normal((n, D)).astype("<f4").view(np.uint32)
        nan = rng.random((n, D)) < 0.01
        v[nan] = 0x7FC00001  # a non-canonical NaN: the host canonicalises
        v[rng.random((n, D)) < 0.01] = 0x80000000  # -0.0 beside +0.0
        return v

    def lww_delta(key, val, ts, rid):
        a = ref_l[key]
        b = (canon(val), ts, rid)
        take = lww_take(a, b)
        for x, y in zip(a, b):
            x[take] = y[take]
        return Tensor.from_wire(2, D, val.tobytes(), ts.astype("<u8").tobytes(),
                                rid.astype("<u4").tobytes(), {})

    def max_delta(key, val):
        a = ref_m[key]
        b = canon(val)
        take = okey_np(b) > okey_np(a)
        a[take] = b[take]
        return Tensor.from_wire(1, D, val.tobytes(), b"", b"", {})

    def avg_delta(key, rid, ts, val):
        cur = ref_a[key].get(rid)
        vec = canon(val)
        if cur is None or (ts, tuple(okey_np(vec).tolist())) > (
                cur[0], tuple(okey_np(cur[1]).tolist())):
            ref_a[key][rid] = (ts, vec)
        return Tensor.from_wire(3, D, b"", b"", b"", {rid: (ts, val.tobytes())})

    node = Node(identity=0x7E5 + (1 << 40))
    ident32 = np.uint32((0x7E5 + (1 << 40)) & 0xFFFFFFFF)
    try:
        reset_counts(tensor.converge_batch)
        t0 = time.perf_counter()
        batch = []
        base = np.array([0, 5, 1 << 63, U64 - 4], np.uint64)
        bases = base[rng.integers(0, 4, len(lww))]
        for rep in range(2):
            who = rng.integers(0, NODE_REPLICAS, len(lww))
            vals = f32(len(lww))
            ts = bases[:, None] + rng.integers(0, 3, (len(lww), D)).astype(np.uint64)
            for j, i in enumerate(lww.tolist()):
                who_j = (who[j] + rep) % NODE_REPLICAS
                batch.append((keys[i], lww_delta(
                    keys[i], vals[j], ts[j], np.full(D, rid32[who_j], np.uint32))))
        for _rep in range(2):
            vals = f32(len(mx))
            for j, i in enumerate(mx.tolist()):
                batch.append((keys[i], max_delta(keys[i], vals[j])))
        for j, i in enumerate(avg.tolist()):
            vals = f32(4)
            for c, r in enumerate(rng.choice(NODE_REPLICAS, 4, replace=False).tolist()):
                ts = int(rng.integers(0, 3)) if j % 5 == 0 else int(rng.integers(1, 1 << 40))
                batch.append((keys[i], avg_delta(keys[i], rids[r], ts, vals[c])))
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        node.converge("TENSOR", batch)
        r1_s = time.perf_counter() - t0
        r1 = tensor.converge_batch.launches

        # round 2: contention on a fifth of the keys, and a few flips
        batch = []
        sel_l = rng.choice(lww, len(lww) // 5, replace=False)
        vals = f32(len(sel_l))
        vals[:, ::7] = 0x7FC00001
        for j, i in enumerate(sel_l.tolist()):
            key = keys[i]
            _v, ts, rid = ref_l[key]
            other = rid32[rng.integers(0, NODE_REPLICAS)]
            batch.append((key, lww_delta(key, vals[j], ts.copy(),
                                         np.full(D, other, np.uint32))))
        sel_m = rng.choice(mx, len(mx) // 5, replace=False)
        vals = f32(len(sel_m))
        vals[:, ::5] = 0xFFC00000  # NaN: the MAX top
        for j, i in enumerate(sel_m.tolist()):
            batch.append((keys[i], max_delta(keys[i], vals[j])))
        sel_a = rng.choice(avg, len(avg) // 5, replace=False)
        vals = f32(len(sel_a))
        for j, i in enumerate(sel_a.tolist()):
            key = keys[i]
            r = sorted(ref_a[key])[j % len(ref_a[key])]
            ts = ref_a[key][r][0] + (j % 2)  # equal ts: okey tuple decides
            batch.append((key, avg_delta(key, r, ts, vals[j])))
        flip = [keys[i] for i in np.setdiff1d(mx, sel_m)[:TENSOR_FLIPS].tolist()]
        vals = f32(len(flip))
        for j, key in enumerate(flip):
            del ref_m[key]
            ref_l[key] = (bottom.copy(), np.zeros(D, np.uint64), np.zeros(D, np.uint32))
            batch.append((key, lww_delta(key, vals[j], np.full(D, 9, np.uint64),
                                         np.full(D, rid32[0], np.uint32))))
        repo = node.repo("TENSOR")
        retired = {repo._dev_rows[repo._tbl.find(k)][-1] for k in flip}
        t0 = time.perf_counter()
        node.converge("TENSOR", batch)
        r2_s = time.perf_counter() - t0
        r2 = tensor.converge_batch.launches

        # SET / MRG / GET over the socket
        cmds, want = [], []
        for j in range(20):
            vals = f32(3)
            k_l, k_m, k_a = b"sl%02d" % j, b"sm%02d" % j, b"sa%02d" % j
            ts = int(rng.integers(0, 1 << 63))
            ref_l[k_l] = (bottom.copy(), np.zeros(D, np.uint64), np.zeros(D, np.uint32))
            lww_delta(k_l, vals[0], np.full(D, ts, np.uint64), np.full(D, ident32, np.uint32))
            ref_m[k_m] = bottom.copy()
            max_delta(k_m, vals[1])
            ref_a[k_a] = {}
            avg_delta(k_a, 0x7E5 + (1 << 40), ts, vals[2])
            cmds += [("TENSOR", "SET", k_l, "LWW", ts, vals[0].tobytes()),
                     ("TENSOR", "SET", k_m, "MAX", ts, vals[1].tobytes()),
                     ("TENSOR", "SET", k_a, "AVG", ts, vals[2].tobytes())]
            want += [b"+OK\r\n"] * 3
        for j, i in enumerate(rng.choice(lww, 40, replace=False).tolist()):
            key, vals = keys[i], f32(1)[0]
            ts = int(ref_l[key][1].max()) if j % 2 else int(rng.integers(0, 1 << 63))
            lww_delta(key, vals, np.full(D, ts, np.uint64), np.full(D, ident32, np.uint32))
            cmds.append(("TENSOR", "SET", key, "LWW", ts, vals.tobytes()))
            want.append(b"+OK\r\n")
        for i in rng.choice(mx, 40, replace=False).tolist():
            key = keys[i]
            if key in ref_m:
                vals = f32(1)[0]
                max_delta(key, vals)
                cmds.append(("TENSOR", "MRG", key, max_blob(vals)))
                want.append(b"+OK\r\n")
        lk = keys[int(lww[0])]
        cmds += [("TENSOR", "SET", lk, "MAX", 1, f32(1)[0].tobytes()),
                 ("TENSOR", "SET", lk, "LWW", 1, f32(1)[0][:32].tobytes()),
                 ("TENSOR", "SET", lk, "LWW", 1, b"\x00" * 5),
                 ("TENSOR", "MRG", lk, b"\x01\x40\x00")]
        want += [b"-BADSHAPE (key holds LWW/64, write is MAX/64)\r\n",
                 b"-BADSHAPE (key holds LWW/64, write is LWW/32)\r\n",
                 b"-BADSHAPE (tensor payload must be a non-empty multiple of 4 "
                 b"bytes: packed little-endian float32)\r\n",
                 b"-BADPAYLOAD (MRG payload must be a canonical delta/TENSOR "
                 b"encoding)\r\n"]
        got = node.client.pipeline(cmds)
        check_replies("TENSOR SET/MRG", got, want)

        def render(key):
            if key in ref_l:
                v, ts, _r = ref_l[key]
                return b"*3\r\n" + bulk(b"LWW") + bulk(v.tobytes()) + b":%d\r\n" % int(ts.max())
            if key in ref_m:
                return b"*3\r\n" + bulk(b"MAX") + bulk(ref_m[key].tobytes()) + b":0\r\n"
            if key in ref_a:
                v, tmax = avg_read(ref_a[key])
                return b"*3\r\n" + bulk(b"AVG") + bulk(v) + b":%d\r\n" % tmax
            return b"$-1\r\n"

        sample = [keys[i] for i in rng.choice(n_keys, 3000, replace=False)]
        sample += flip + [c[2] for c in cmds] + [b"missing"]
        t0 = time.perf_counter()
        got = node.client.pipeline([("TENSOR", "GET", k) for k in sample])
        get_s = time.perf_counter() - t0
        check_replies("TENSOR GET", got, [render(k) for k in sample])

        # every live device row against the mirror rule
        repo.drain()
        launches = tensor.converge_batch.launches
        t0 = time.perf_counter()
        for plane in repo._state:
            if plane.device.type != DEVICE:
                raise AssertionError(f"TENSOR state on {plane.device}")
        if n_keys == TENSOR_KEYS and (repo._row_cap, repo._dim_cap) != (N_TENSOR_NODE, D):
            raise AssertionError(
                f"TENSOR capacity {(repo._row_cap, repo._dim_cap)} is not the "
                f"shape the kernel phase held against plain ({N_TENSOR_NODE}, {D})")
        val, th, tl, rid = (p.cpu().numpy().view(np.uint32) for p in repo._state)
        tsp = (th.astype(np.uint64) << np.uint64(32)) | tl
        live = 0
        for ref, mode in ((ref_l, 2), (ref_m, 1)):
            ks = sorted(ref)
            dev = []
            for k in ks:
                m = repo._dev_rows[repo._tbl.find(k)]
                if list(m) != [-1]:
                    raise AssertionError(f"TENSOR {k}: device rows {m}")
                dev.append(m[-1])
            dev = np.asarray(dev)
            live += len(dev)
            if mode == 2:
                want_v = np.stack([ref[k][0] for k in ks])
                want_ts = np.stack([ref[k][1] for k in ks])
                want_r = np.stack([ref[k][2] for k in ks])
            else:
                want_v = np.stack([ref[k] for k in ks])
                want_ts = np.zeros_like(tsp[dev])
                want_r = np.zeros_like(rid[dev])
            for name, g, w in (("val", val[dev], want_v), ("ts", tsp[dev], want_ts),
                               ("rid", rid[dev], want_r)):
                if not np.array_equal(g, w):
                    bad = int(np.flatnonzero((g != w).any(axis=1))[0])
                    raise AssertionError(
                        f"TENSOR {'LWW' if mode == 2 else 'MAX'} {ks[bad]!r}: device "
                        f"{name} != reference")
        for k, contribs in ref_a.items():
            m = repo._dev_rows[repo._tbl.find(k)]
            if sorted(m) != sorted(contribs):
                raise AssertionError(f"TENSOR AVG {k}: device rows {m}")
            for r, (_ts, vec) in contribs.items():
                dev = m[r]
                live += 1
                ver = repo._avg_ver[dev]
                if (not np.array_equal(val[dev], vec) or (rid[dev] != (r & 0xFFFFFFFF)).any()
                        or (tsp[dev] != ver).any()):
                    raise AssertionError(f"TENSOR AVG {k} rid {r}: device row != mirror")
        mapped = {d for m in repo._dev_rows.values() for d in m.values()}
        if retired & mapped or len(retired) != len(flip):
            raise AssertionError("a flipped key's old device row is still mapped")
        check_s = time.perf_counter() - t0
    finally:
        node.close()
    if DEVICE == "cuda" and (r1 != 1 or r2 != 2 or launches != 3):
        raise AssertionError(
            f"tensor_converge_batch launches: {r1}, {r2}, {launches}: expected one "
            "per drain (round 1, round 2, the final drain)")
    out = {"launches": {"tensor_converge_batch": launches},
           "keys": len(ref_l) + len(ref_m) + len(ref_a), "dim": D,
           "live_rows_checked": live, "rows_allocated": repo._next_dev,
           "capacity": [repo._row_cap, repo._dim_cap], "flips": len(flip),
           "replies_checked": len(cmds) + len(sample), "generate_s": gen_s,
           "round1_s": r1_s, "round2_s": r2_s, "get_s": get_s, "check_s": check_s}
    out["serving"] = node.served
    emit({"phase": "tensor_node", **out})
    return out


# ---- TLOG node phase: BASELINE config 4 through the serving path --------------


class TlogRef:
    """One key's log, the lattice written out (tlog.md:116-133): a set of
    (ts, value) entries and a grow-only cutoff; entries below the cutoff
    are gone."""

    __slots__ = ("ents", "cut")

    def __init__(self, ents=(), cut: int = 0):
        self.ents = set(ents)
        self.cut = cut

    def raise_cut(self, c: int) -> None:
        if c > self.cut:
            self.cut = c
            self.ents = {e for e in self.ents if e[0] >= c}

    def ins(self, ts: int, value: bytes) -> None:
        if ts >= self.cut:
            self.ents.add((ts, value))

    def latest(self):
        return sorted(self.ents, reverse=True)

    def trim(self, count: int) -> None:
        desc = self.latest()
        if count == 0:
            if desc:  # CLR: latest + 1, wrapping to 0 at 2^64-1
                self.raise_cut((desc[0][0] + 1) & U64)
        elif count <= len(desc):
            self.raise_cut(desc[count - 1][0])

    def get(self, n: int = U64) -> bytes:
        desc = self.latest()[:n]
        return b"*%d\r\n" % len(desc) + b"".join(
            b"*2\r\n" + bulk(v) + b":%d\r\n" % ts for ts, v in desc)


def tlog_node_phase(torch, n_keys: int = TLOG_KEYS) -> dict:
    """BASELINE config 4 on a real Server with state on DEVICE: n_keys
    keys filled to 1,024 entries each through Database.converge_async.
    Rounds 1-3: 64 entries to every key (the dense drain); round 4: 64 to
    the first half only; round 5: 64 to the second half, while the first
    half's rows (256 entries, L = 256) trip the dense rule (length >
    L - Ld) and the drain retries at L = 512; rounds 6-11: 128 entries to
    every key (the sparse drain, B = 16,384); round 7 is delivered twice
    (the second time all duplicates), round 9 raises every cutoff (below
    the entries), round 11 carries 64-bit timestamps (the state widens).
    Entries come in pairs of equal ts with two values from a pool of
    TLOG_VALUES. Then over the socket: GET key n and GET/SIZE/CUTOFF of
    drained rows, TRIM to 512 on TLOG_TRIMS keys (one sparse drain each,
    B = 16), TRIMAT and CLR, then INS on trimmed, cleared and new keys and
    reads of their merged views, every reply against TlogRef; then the
    whole device state, read back through the interner, against the
    reference for every key."""
    from jylis_tpu_torch.ops import planes, tlog
    from jylis_tpu_torch.utils.batching import bucket

    rng = np.random.default_rng(SEED + 21)
    keys = [b"log%05d" % i for i in range(n_keys)]
    pool = [b"val%05d" % i for i in range(TLOG_VALUES)]
    half = n_keys // 2
    # the reference, in bulk: every key's entries as (ts, pool index)
    ref_ts = np.zeros((n_keys, 0), np.uint64)
    ref_v = np.zeros((n_keys, 0), np.int64)
    ref_cut = np.zeros(n_keys, np.uint64)

    def entries(m, n, wide=False):
        """(m, n) ts and pool indices: pairs of equal ts, two values."""
        lo, hi = ((1 << 32) + 1, 1 << 40) if wide else (1 << 20, (1 << 31) - 1)
        ts = np.repeat(rng.integers(lo, hi, (m, n // 2)), 2, axis=1).astype(np.uint64)
        v = rng.integers(0, TLOG_VALUES, (m, n))
        v[:, 1::2] = (v[:, 0::2] + 1 + rng.integers(0, 100, (m, n // 2))) % TLOG_VALUES
        return ts, v

    def batch_of(sel, ts, v, cuts=None):
        out = []
        for j, i in enumerate(sel):
            ents = list(zip([pool[x] for x in v[j].tolist()], ts[j].tolist()))
            out.append((keys[i], (ents, 0 if cuts is None else int(cuts[j]))))
        return out

    node = Node(identity=0x7106)
    repo = node.repo("TLOG")
    rounds = []
    try:
        reset_counts(tlog.drain_dense, tlog.drain_sparse)
        sel_all = np.arange(n_keys)
        plan = [(sel_all, 64, False, False), (sel_all, 64, False, False),
                (sel_all, 64, False, False), (sel_all[:half], 64, False, False),
                (sel_all[half:], 64, False, False)]
        plan += [(sel_all, 128, r == 9, r == 11) for r in range(6, 12)]
        for r, (sel, n, raise_cut, wide) in enumerate(plan, start=1):
            t0 = time.perf_counter()
            ts, v = entries(len(sel), n, wide)
            cuts = rng.integers(1, 1 << 19, len(sel)).astype(np.uint64) if raise_cut else None
            batch = batch_of(sel, ts, v, cuts)
            full_ts = np.zeros((n_keys, n), np.uint64)
            full_v = np.full((n_keys, n), -1, np.int64)
            full_ts[sel], full_v[sel] = ts, v
            ref_ts = np.concatenate([ref_ts, full_ts], 1)
            ref_v = np.concatenate([ref_v, full_v], 1)
            if cuts is not None:
                ref_cut[sel] = np.maximum(ref_cut[sel], cuts)
            gen_s = time.perf_counter() - t0
            l0 = (tlog.drain_dense.launches, tlog.drain_sparse.launches)
            cap0 = repo._len_cap
            t0 = time.perf_counter()
            node.converge("TLOG", batch)
            conv_s = time.perf_counter() - t0
            rounds.append(dict(
                round=r, keys=len(sel), entries=n, generate_s=gen_s,
                converge_s=conv_s, len_cap=[cap0, repo._len_cap],
                dense=tlog.drain_dense.launches - l0[0],
                sparse=tlog.drain_sparse.launches - l0[1],
                wide=repo._state.wide))
            if r == 7:  # delivered again: every entry a duplicate
                l1 = tlog.drain_sparse.launches
                t0 = time.perf_counter()
                node.converge("TLOG", batch)
                rounds.append(dict(round="7 again", keys=len(sel), entries=n,
                                   converge_s=time.perf_counter() - t0,
                                   sparse=tlog.drain_sparse.launches - l1))
        # round 5's drain needs L = 256 by its rows' sizes; the dense rule
        # flags the first half's 256-entry rows, so only a retry makes 512
        r5 = rounds[4]
        if r5["len_cap"] != [256, 512] or (DEVICE == "cuda" and r5["dense"] != 2):
            raise AssertionError(f"TLOG round 5: no dense tail-overflow retry: {r5}")
        retries = r5["dense"] - 1 if DEVICE == "cuda" else 1
        converge_launches = {"tlog_drain_dense": tlog.drain_dense.launches,
                             "tlog_drain_sparse": tlog.drain_sparse.launches}
        converge_classes = {"tlog_drain_dense": dict(tlog.drain_dense.classes),
                            "tlog_drain_sparse": dict(tlog.drain_sparse.classes)}
        if not repo._state.wide or repo._len_cap != L_TLOG or repo._key_cap != bucket(n_keys):
            raise AssertionError(
                f"TLOG state after the rounds: wide {repo._state.wide}, "
                f"capacity {(repo._key_cap, repo._len_cap)}")

        # the reference per key for what the socket touches
        def ref_of(i):
            ok = ref_v[i] >= 0
            return TlogRef(zip(ref_ts[i][ok].tolist(), (pool[x] for x in ref_v[i][ok].tolist())),
                           int(ref_cut[i]))

        touched: dict[int, TlogRef] = {}

        def ref(i):
            if i not in touched:
                touched[i] = ref_of(i)
            return touched[i]

        order = rng.permutation(n_keys).tolist()
        trim_keys = order[:TLOG_TRIMS]
        get_keys = order[TLOG_TRIMS : TLOG_TRIMS + 100]
        at_keys = order[TLOG_TRIMS + 100 : TLOG_TRIMS + 200]
        clr_keys = order[TLOG_TRIMS + 200 : TLOG_TRIMS + 250]
        new_keys = [b"fresh%03d" % j for j in range(50)]
        cmds, want = [], []
        replies = 0

        def send(cmd, expect):
            cmds.append(cmd)
            want.append(expect)

        def run(what, chunk=256):
            nonlocal replies
            t0 = time.perf_counter()
            got = node.client.pipeline(cmds, chunk)
            check_replies(what, got, want)
            replies += len(got)
            cmds.clear()
            want.clear()
            return time.perf_counter() - t0

        # reads of drained rows: each first read gathers its row
        for i in trim_keys:
            send(("TLOG", "GET", keys[i], 5), ref(i).get(5))
        for i in get_keys:
            send(("TLOG", "GET", keys[i]), ref(i).get())
            send(("TLOG", "SIZE", keys[i]), b":%d\r\n" % len(ref(i).ents))
            send(("TLOG", "CUTOFF", keys[i]), b":%d\r\n" % ref(i).cut)
        reads_s = run("TLOG GET/SIZE/CUTOFF")
        # trims: one sparse drain each (B = 16, no entries)
        l0 = tlog.drain_sparse.launches
        c0 = dict(tlog.drain_sparse.classes)
        for i in trim_keys:
            send(("TLOG", "TRIM", keys[i], TLOG_TRIM), b"+OK\r\n")
            ref(i).trim(TLOG_TRIM)
        for i in at_keys:
            t = int(rng.integers(1 << 20, 1 << 31))
            send(("TLOG", "TRIMAT", keys[i], t), b"+OK\r\n")
            ref(i).raise_cut(t)
        for i in clr_keys:
            send(("TLOG", "CLR", keys[i]), b"+OK\r\n")
            ref(i).trim(0)
        send(("TLOG", "CLR", b"missing"), b"+OK\r\n")
        trims_s = run("TLOG TRIM/TRIMAT/CLR", chunk=64)
        trim_launches = tlog.drain_sparse.launches - l0
        trim_classes = {c: n - c0.get(c, 0) for c, n in tlog.drain_sparse.classes.items()
                        if n != c0.get(c, 0)}
        # local writes on trimmed and cleared keys and on new keys (pending
        # until the next drain: reads serve the merged view on the host)
        ins_keys = trim_keys[:200] + clr_keys
        for i in ins_keys:
            ts = int(rng.integers(1 << 20, 1 << 41))
            value = pool[int(rng.integers(TLOG_VALUES))]
            send(("TLOG", "INS", keys[i], value, ts), b"+OK\r\n")
            ref(i).ins(ts, value)
        for j, key in enumerate(new_keys):
            send(("TLOG", "INS", key, b"n%d" % j, j + 1), b"+OK\r\n")
        for i in ins_keys + trim_keys[200:400] + at_keys:
            send(("TLOG", "GET", keys[i]), ref(i).get())
            send(("TLOG", "SIZE", keys[i]), b":%d\r\n" % len(ref(i).ents))
            send(("TLOG", "CUTOFF", keys[i]), b":%d\r\n" % ref(i).cut)
        for j, key in enumerate(new_keys):
            send(("TLOG", "GET", key), b"*1\r\n*2\r\n" + bulk(b"n%d" % j) + b":%d\r\n" % (j + 1))
        send(("TLOG", "GET", b"missing"), b"*0\r\n")
        send(("TLOG", "CUTOFF", b"missing"), b":0\r\n")
        ins_s = run("TLOG INS and reads after the trims")

        # the whole device state against the reference
        repo.drain()  # the socket's pending INS: one more sparse drain
        launches = {"tlog_drain_dense": tlog.drain_dense.launches,
                    "tlog_drain_sparse": tlog.drain_sparse.launches}
        classes = {"tlog_drain_dense": dict(tlog.drain_dense.classes),
                   "tlog_drain_sparse": dict(tlog.drain_sparse.classes)}
        t0 = time.perf_counter()
        st = repo._state
        for plane in _tensors(st):
            if plane.device.type != DEVICE:
                raise AssertionError(f"TLOG state on {plane.device}")
        all_ts, all_vid = repo._host_planes()
        length = st.length.cpu().numpy()
        cutoff = planes.to_u64_np(st.cutoff)
        tbl = repo._tbl
        rows = np.array([tbl.find(k) for k in keys])
        if rows.min() < 0 or len(set(rows.tolist())) != n_keys:
            raise AssertionError("TLOG table rows for the keys")
        # entries as one sortable number, ts << 17 | interner id (ts < 2^41,
        # ids < 2^17): pool values -> interner ids first
        vid_of = np.array([repo._interner.intern(v) for v in pool], np.uint64)
        big = np.uint64(U64)
        dev_ts, dev_vid = all_ts[rows], all_vid[rows]
        slot = np.arange(dev_ts.shape[1])[None, :]
        dev_c = np.where(slot < length[rows][:, None],
                         (dev_ts << np.uint64(17)) | dev_vid.astype(np.uint64), big)
        dev_c.sort(axis=1)
        ok = ref_v >= 0
        ref_c = np.where(ok, (ref_ts << np.uint64(17)) | vid_of[np.where(ok, ref_v, 0)], big)
        ref_c.sort(axis=1)
        dup = np.zeros(ref_c.shape, bool)
        dup[:, 1:] = ref_c[:, 1:] == ref_c[:, :-1]
        ref_c[dup] = big
        ref_c.sort(axis=1)
        width = max(ref_c.shape[1], dev_c.shape[1])
        ref_c = np.pad(ref_c, ((0, 0), (0, width - ref_c.shape[1])), constant_values=big)
        dev_c = np.pad(dev_c, ((0, 0), (0, width - dev_c.shape[1])), constant_values=big)
        for i, r in touched.items():  # the keys the socket changed
            c = sorted((ts << 17) | repo._interner.intern(v) for ts, v in r.ents)
            ref_c[i] = big
            ref_c[i, : len(c)] = c
            ref_cut[i] = r.cut
        bad = np.flatnonzero((dev_c != ref_c).any(1) | (cutoff[rows] != ref_cut))
        if len(bad):
            i = int(bad[0])
            raise AssertionError(
                f"TLOG {keys[i]!r}: device row ({length[rows[i]]} entries, cutoff "
                f"{cutoff[rows[i]]}) != reference (cutoff {ref_cut[i]}); "
                f"{len(bad)} keys differ")
        past = slot >= length[rows][:, None]
        if (dev_vid[past] != -1).any():
            raise AssertionError("TLOG slots past a row's length are not PAD")
        check_s = time.perf_counter() - t0
    finally:
        node.close()
    if DEVICE == "cuda" and (min(launches.values()) < 1 or trim_launches != TLOG_TRIMS + 151):
        raise AssertionError(f"TLOG drains: {launches}, trim drains {trim_launches}")
    out = {"launches": launches, "classes": classes, "converge_launches": converge_launches,
           "converge_classes": converge_classes, "trim_classes": trim_classes,
           "keys": n_keys, "entries_per_key": TLOG_LEN, "dense_retries": retries,
           "trim_drains": trim_launches, "capacity": [repo._key_cap, repo._len_cap],
           "rows_checked": n_keys, "replies_checked": replies,
           "rounds": rounds, "reads_s": reads_s, "trims_s": trims_s,
           "ins_reads_s": ins_s, "check_s": check_s}
    out["serving"] = node.served
    emit({"phase": "tlog_node", **out})
    return out


# ---- UJSON ----------------------------------------------------------------------

# BASELINE config 5 (bench.py:1107 config_ujson_32): 32 replica documents,
# each making 40 set_doc edits over 8 fields per round, for 8 rounds:
# 10,240 deltas, every one joined into every replica
UJ5_REPS, UJ5_EDITS, UJ5_ROUNDS = 32, 40, 8
# config 5b (bench.py:1197 config_ujson_multikey): 64 keys, 512 INS
# deltas per key and round from 8 replica ids, 8 rounds
UJ5B_KEYS, UJ5B_FANIN, UJ5B_REPS, UJ5B_ROUNDS = 64, 512, 8, 8
# the UJSON node phase's flat leg (4,096 keys x 64 deltas in one batch:
# D = 64, the flat rule), its replica-growth leg (64 keys x config 5's
# edits from 32 replica ids, 2 rounds) and the wide flat round's keys
UJ_FLAT_KEYS, UJ_FLAT_D, UJ_GROW_KEYS, UJ_WIDE_FLAT = 4096, 64, 64, 512
UJ_TRICKLE, UJ_LOCAL = 100, 30  # keys that get a read trickle / local writes
UJ_IDENTITY = 0xD0C5


def uj_copy(doc):
    """A host UJSON document's copy, its context compacted."""
    from jylis_tpu_torch.ops.ujson_host import UJSON

    c = UJSON()
    c.entries = dict(doc.entries)
    c.ctx.vv = dict(doc.ctx.vv)
    c.ctx.cloud = set(doc.ctx.cloud)
    c.ctx.compact()
    return c


def uj_join(docs):
    """The host join of writer documents: once per writer, not per delta."""
    out = uj_copy(docs[0])
    for d in docs[1:]:
        out.converge(d)
    return out


def uj_canon(doc) -> bytes:
    """A document's canonical bytes, as the JAX repo's sync_canon makes
    them: entries, vv and cloud sorted."""
    ents = sorted((dot, path, token) for dot, (path, token) in doc.entries.items())
    return repr((ents, sorted(doc.ctx.vv.items()), sorted(doc.ctx.cloud))).encode()


def uj_5b_round(docs, rnd, keep=True):
    """Config 5b's round ``rnd`` (bench.py:1213-1233): per key, 512 INS of
    distinct values into ("tags",) from replica ids 100..107 on the key's
    writer document. Returns each key's deltas (None with keep=False)."""
    from jylis_tpu_torch.ops.ujson_host import UJSON

    groups = []
    for k, doc in enumerate(docs):
        g = []
        for e in range(UJ5B_FANIN):
            d = UJSON() if keep else None
            doc.ins(100 + e % UJ5B_REPS, ("tags",), str(k * 100000 + rnd * 1000 + e), d)
            g.append(d)
        groups.append(g if keep else None)
    return groups


def uj_5_round(writers, rnd, rid0=0):
    """Config 5's round ``rnd`` (bench.py:1131-1141): writer r (replica id
    rid0 + r) makes 40 set_doc edits over 8 fields; returns the deltas."""
    from jylis_tpu_torch.ops.ujson_host import UJSON

    out = []
    for r, doc in enumerate(writers):
        for e in range(UJ5_EDITS):
            d = UJSON()
            doc.set_doc(rid0 + r, ("field%d" % (e % 8),),
                        str(rnd * 100000 + r * 1000 + e), d)
            out.append(d)
    return out


UJ_FLAT_RIDS = (110, 111, 112)


def uj_flat_deltas(ws, k: int, rnd: int):
    """64 deltas of one flat-leg key from its writers A, B, C (replica
    ids UJ_FLAT_RIDS): A inserts 24 values; B observes A, removes 8 of
    A's values and sets a field 8 times; C inserts 16 values and removes
    8 of them."""
    from jylis_tpu_torch.ops.ujson_host import UJSON

    a, b, c = ws
    ra, rb, rc = UJ_FLAT_RIDS
    out = []

    def take(d):
        out.append(d)
        return d

    for i in range(24):
        a.ins(ra, ("tags",), '"a%d.%d.%d"' % (k, rnd, i), take(UJSON()))
    b.converge(a)
    seen = sorted(t for p, t in a.entries.values() if p == ("tags",))
    for t in seen[:8]:
        b.rm(rb, ("tags",), t, take(UJSON()))
    for i in range(8):
        b.set_doc(rb, ("f",), str(rnd * 100 + i), take(UJSON()))
    mine = [str(k * 1000 + rnd * 100 + i) for i in range(16)]
    for v in mine:
        c.ins(rc, ("tags",), v, take(UJSON()))
    for v in mine[::2]:
        c.rm(rc, ("tags",), v, take(UJSON()))
    return out


def uj_random_planes(torch, rng, lead, l, c, r, shift, empty=(), wrap=False):
    """Random DocBatch planes on the card shaped lead + (width,): per row
    a random share of sorted, duplicate-free dots (random payload ids)
    and cloud entries, pads after; rows in ``empty`` hold nothing. Wide
    rows mix seqs near 2^32 and columns past 2^31 (bit 63 set: 2^31 and
    2^31 + 1, and with ``wrap`` 2^32 - 4 to 2^32 - 2, the columns the
    flat fold indexes from the end of vv as JAX does)."""
    from jylis_tpu_torch.ops import ujson_device as udev

    n = int(np.prod(lead))
    wide = shift == 32
    dt = np.uint64 if wide else np.int64
    pad = np.uint64(2**64 - 1) if wide else 0x7FFFFFFF

    def row_plane(width):
        col = rng.integers(0, r, (n, width)).astype(dt)
        seq = rng.integers(1, 40, (n, width)).astype(dt)
        if wide:
            seq = np.where(rng.random((n, width)) < 0.2, dt(2**32 - 3) + seq % 3, seq)
            col = np.where(rng.random((n, width)) < 0.05, dt(2**31) + col % 2, col)
            if wrap:
                col = np.where(rng.random((n, width)) < 0.05, dt(2**32 - 2) - col % 3, col)
        v = (col << dt(shift)) | seq
        keep = rng.random((n, width)) < rng.random((n, 1)) * 1.2
        keep[list(empty)] = False
        v = np.where(keep, v, pad)
        v.sort(1)
        v[:, 1:][v[:, 1:] == v[:, :-1]] = pad
        v.sort(1)
        return v.view(np.int64) if wide else v.astype(np.int32)

    dots, cloud = row_plane(l), row_plane(c)
    pay = np.where(dots != (-1 if wide else 0x7FFFFFFF),
                   rng.integers(0, 200, (n, l)), -1).astype(np.int32)
    vv = rng.integers(0, 30, (n, r)).astype(np.uint32)
    vv[rng.random((n, r)) < 0.03] = 0xFFFFFFFF
    planes_ = (dots, pay, vv.view(np.int32), cloud)
    return udev.DocBatch(*(torch.from_numpy(x.reshape(tuple(lead) + x.shape[1:])).to(DEVICE)
                           for x in planes_))


def uj_clone(batch):
    return type(batch)(*(p.clone() for p in batch))


def _lg(n: int) -> int:
    return max(int(n), 1).bit_length()


def uj_join_work(a, b, bcast: bool, lo: int, co: int):
    """(bytes, operations) of one ujson_join launch by its source note:
    ``a`` holds the a rows the slots read, ``b`` the b rows (one row read
    once when ``bcast``); each input read once, each output row of
    widths (lo, co) written once; per row (La + Lb)(log2 L + log2 C + 4)
    + (Ca + Cb)(log2 C + 6) operations, counted over the valid entries."""
    from jylis_tpu_torch.ops import ujson_device as udev

    ts = a.dots.element_size()
    n, la = a.dots.shape
    lb = b.dots.shape[-1]
    ca, cb = a.cloud.shape[-1], b.cloud.shape[-1]
    r = a.vv.shape[-1]
    nbytes = sum(p.numel() * p.element_size() for p in (*a, *b))
    nbytes += n * (lo * (ts + 4) + co * ts + r * 4)
    pad = udev.pad_of(a.dots)
    times = n if bcast else 1
    dots = int((a.dots != pad).sum()) + int((b.dots != pad).sum()) * times
    cloud = int((a.cloud != pad).sum()) + int((b.cloud != pad).sum()) * times
    lg_l, lg_c = _lg(max(la, lb)), _lg(max(ca, cb))
    return nbytes, dots * (lg_l + lg_c + 4) + cloud * (lg_c + 6)


def uj_tree_work(grid, shift: int):
    """(bytes, operations, classes) of a tree fold: the sum over its
    levels' join launches (the levels run in plain torch here, to read
    their rows), and the class each launch takes (ujson_device.join_plan)
    as "warp x7, cta x2"."""
    from jylis_tpu_torch.ops import ujson_device as udev

    work = [0, 0]
    kinds: list[str] = []

    def join(a, b, s):
        o = udev.join_rows_plain(a, b, s)
        nb, no = uj_join_work(a, b, False, o.dots.shape[-1], o.cloud.shape[-1])
        work[0] += nb
        work[1] += no
        kinds.append(uj_join_class(a, b))
        return o

    udev._fold_body(grid, shift, join)
    runs = []
    for k in kinds:
        if runs and runs[-1][0] == k:
            runs[-1][1] += 1
        else:
            runs.append([k, 1])
    return work[0], work[1], ", ".join(f"{k} x{n}" for k, n in runs)


def uj_warp_max_width(tsize: int, r: int, n: int = 1024) -> int:
    """The widest W (a multiple of 4) at which ujson_join's warp class
    takes ``n`` rows of W dots and W cloud entries joined with the same."""
    from jylis_tpu_torch.ops import ujson_device as udev

    width = 4
    while udev.plan_join(n, tsize, width + 4, width + 4, width + 4, width + 4,
                         r).kind == "warp":
        width += 4
    return width


def uj_join_class(a, b) -> str:
    """The class ujson_join takes for slots joining a's rows with b's
    ("cluster of 8": CTAs a row)."""
    from jylis_tpu_torch.ops import ujson_device as udev

    plan = udev.plan_join(a.dots.shape[0], a.dots.element_size(), a.dots.shape[-1],
                          b.dots.shape[-1], a.cloud.shape[-1], b.cloud.shape[-1],
                          a.vv.shape[-1])
    return f"cluster of {plan.cluster}" if plan.kind == "cluster" else plan.kind


def uj_flat_work(grid, out):
    """(bytes, operations) of one ujson_fold_flat launch, counted over the
    function's own work on this input, whatever implements it: each
    input read once and each output written once; per key D membership
    and cover checks per live entry (a search of log2 W + log2 C + 3
    steps each), one placement per kept dot and per kept cloud entry,
    and D * R for the vv max."""
    from jylis_tpu_torch.ops import ujson_device as udev

    k, d, w = grid.dots.shape
    c, r = grid.cloud.shape[-1], grid.vv.shape[-1]
    nbytes = sum(p.numel() * p.element_size() for p in (*grid, *out))
    pad = udev.pad_of(grid.dots)
    live = int((grid.dots != pad).sum())
    kept, ckept = int((out.dots != pad).sum()), int((out.cloud != pad).sum())
    return nbytes, d * live * (_lg(w) + _lg(c) + 3) + kept + ckept + k * d * r


def uj_flat_class(g) -> str:
    """The class ujson_fold_flat takes for grid ``g`` (ujson_resident.flat_plan):
    "warp, 2 keys a CTA", "cta" or "cluster of 8"."""
    from jylis_tpu_torch.ops import ujson_resident as ures

    k, d, w = g.dots.shape
    p = ures.flat_plan(k, g.dots.element_size(), d, w, g.cloud.shape[-1], g.vv.shape[-1])
    if p.kind == "warp":
        return f"warp, {p.rows_per_cta} keys a CTA"
    return f"cluster of {p.cluster}" if p.kind == "cluster" else p.kind


# (k, d, w, c, r) of random delta stacks at each class boundary of
# ops/ujson_resident.py flat_plan and one step past it, by dot size (4
# narrow, 8 wide; tests/test_torch_ujson.py checks they are its
# boundaries): the widest deltas the warp class takes and 4 wider (a
# CTA); in a launch of 16 keys, the widest key a CTA takes there
# (FLAT_SPREAD_BYTES) and 4 wider (a cluster); in a launch that fills the
# card (132 keys), the widest key a CTA's shared memory holds and 4 wider
# (a cluster). Widths are multiples of 4; past the warp class the clouds
# hold 16 entries.
UJ_FLAT_BOUNDARIES = {
    4: [(4096, 64, 8, 8, 8), (4096, 64, 12, 12, 8), (16, 64, 28, 16, 8), (16, 64, 32, 16, 8),
        (132, 64, 720, 16, 8), (132, 64, 724, 16, 8)],
    8: [(4096, 64, 8, 8, 8), (4096, 64, 12, 12, 8), (16, 64, 4, 16, 8), (16, 64, 8, 16, 8),
        (132, 64, 360, 16, 8), (132, 64, 364, 16, 8)],
}


def uj_case(torch, name, shape, card, run_k, run_p, work, reset_k=None, reset_p=None,
            launches_per=1, launch_class=None):
    """Run kernel and plain once on equal inputs, compare bit for bit,
    then time both (CUDA events; ``reset_*`` put back the inputs of a
    join that writes in place) and read the kernel's device time."""
    from jylis_tpu_torch.ops import ujson_device as udev, ujson_resident as ures

    counter = udev.join_rows if name == "ujson_join" else ures.fold_flat
    reset_k = reset_k or (lambda: None)
    reset_p = reset_p or (lambda: None)
    reset_k()
    reset_p()
    l0 = counter.launches
    out_k = run_k()
    out_p = run_p()
    torch.cuda.synchronize()
    launched = counter.launches - l0
    err = max_abs_err(torch, list(zip(out_k, out_p)))
    if err or launched != launches_per:
        raise AssertionError(f"{name} {shape}: err {err}, launches {launched}")
    ms = time_ms(torch, run_k, reset=reset_k)
    dev_ms = device_ms(torch, lambda: (reset_k(), run_k()), name, calls=3)
    if dev_ms is not None:
        dev_ms *= launches_per  # the profiler's mean is per launch
    plain_ms = time_ms(torch, run_p, reset=reset_p)
    nbytes, nops = work[:2]
    b_ms, b_by = bound(nbytes, nops, card)
    row = dict(shape=shape, max_abs_err=err, kernel_ms=ms, device_ms=dev_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
               operations=nops, launches=launched,
               **({"class": launch_class} if launch_class else {}))
    emit({"phase": name, **row, "card": card})
    return row


def uj_5b_setup(wide: bool):
    """BASELINE config 5b in a ResidentStore on the card: 64 documents
    resident after 7 rounds, and round 8's deltas as the (K = 64, D =
    512, W) grid the tree folds. Returns (store, keys, groups, grid)."""
    from jylis_tpu_torch.ops import ujson_resident as ures
    from jylis_tpu_torch.ops.ujson_host import UJSON

    docs = [UJSON() for _ in range(UJ5B_KEYS)]
    for rnd in range(UJ5B_ROUNDS - 1):
        uj_5b_round(docs, rnd, keep=False)
    store = ures.ResidentStore(n_rep=UJ5B_REPS, device=DEVICE)
    if wide:
        store._widen()
    keys = [b"doc%03d" % k for k in range(UJ5B_KEYS)]
    store.admit([(k, uj_copy(d)) for k, d in zip(keys, docs)])
    groups = uj_5b_round(docs, UJ5B_ROUNDS - 1)
    return store, keys, groups, store._grid_to_device(store._encode_grid(groups))


def uj_5_setup(wide: bool):
    """BASELINE config 5: 32 replica rows resident (empty), and the 8
    rounds' 10,240 deltas as one (1, D, W) grid, D padded to a power of
    two with identity rows. Returns (store, deltas, grid)."""
    from jylis_tpu_torch.ops import ujson_device as udev, ujson_resident as ures
    from jylis_tpu_torch.ops.ujson_host import UJSON
    from jylis_tpu_torch.utils.batching import bucket

    writers = [UJSON() for _ in range(UJ5_REPS)]
    deltas = [d for rnd in range(UJ5_ROUNDS) for d in uj_5_round(writers, rnd)]
    st5 = ures.ResidentStore(n_rep=UJ5_REPS, device=DEVICE)
    if wide:
        st5._widen()
    st5.admit([(b"rep%02d" % i, UJSON()) for i in range(UJ5_REPS)])
    d5 = bucket(len(deltas), 4)
    batch = udev.to_torch(st5._encode_rows(deltas + [UJSON()] * (d5 - len(deltas))), DEVICE)
    return st5, deltas, udev.DocBatch(*(p[None] for p in batch))


def uj_edge_case(torch, card: str, wide: bool) -> dict:
    """ujson_join's cluster class where its partition edges split twins:
    6 rows of 64 dots and 64 cloud entries forced into clusters of 8,
    b's rows holding 13 of a's dots and cloud entries among their own (so
    a dot and its twin, a cloud entry and its repeat, fall into
    neighbouring CTAs), joined with the epilogue in place at a permuted
    subset (out is a), bit for bit against the plain join, then timed."""
    from jylis_tpu_torch.ops import ujson_device as udev

    rng = np.random.default_rng(SEED + 32 + wide)
    r, n, width, twins = 8, 6, 64, 13
    shift = 32 if wide else udev.narrow_shift(r)
    a = uj_random_planes(torch, rng, (n,), width, width, r, shift, empty=[0])
    b = uj_random_planes(torch, rng, (n,), width, width, r, shift)
    pad = udev.pad_of(a.dots)
    bias = (1 << 63) if wide else 0  # wide rows sort unsigned

    def sort_rows(x):
        return torch.gather(x, 1, (x ^ bias).sort(1).indices)

    for x, y in ((a.dots, b.dots), (a.cloud, b.cloud)):
        both = sort_rows(torch.cat([x[:, :twins], y[:, : width - twins]], 1))
        both[:, 1:][both[:, 1:] == both[:, :-1]] = pad
        y.copy_(sort_rows(both))
    b.pay.copy_(torch.where(b.dots == pad, -1, b.pay.abs()))
    idx = torch.tensor([3, 1, 4, 2, 5, 0], dtype=torch.int32, device=DEVICE)
    a0 = uj_clone(a)
    ak, ap = uj_clone(a0), uj_clone(a0)
    with forced_cluster(udev):
        row = uj_case(
            torch, "ujson_join",
            f"partition edges: {n} x {width} dots + {width} ({twins} twins a row), "
            f"in place at a permuted subset, {'wide' if wide else 'narrow'}",
            card,
            lambda: udev.join_rows(ak, b, shift, a_idx=idx, finish=(width, width), out=ak),
            lambda: udev.join_rows_plain(ap, b, shift, a_idx=idx, finish=(width, width),
                                         out=ap),
            uj_join_work(a0, b, False, width, width), restorer(ak, a0), restorer(ap, a0),
            launch_class=uj_join_class(a0, b))
    if not row["class"].startswith("cluster"):
        raise AssertionError(f"ujson_join partition edges ran {row['class']}")
    return row


def ujson_phases(torch, card: str, flat_groups) -> dict:
    """ujson_join and ujson_fold_flat, each bit for bit against its plain
    version, narrow and wide, at the shapes their main paths give them:
    config 5b's tree levels (K = 64 keys, D = 512 one-entry INS deltas)
    and its subset join into resident rows of 4,096 dots (round 8: 3,584
    resident entries + 512); config 5's broadcast join (32 resident
    rows, one folded row of 10,240 deltas, 65,536 slots wide: past
    shared memory, a cluster of 8 CTAs a row) and its 14-level tree;
    ujson_join at the class boundaries of ujson_device.join_plan;
    ujson_fold_flat at the node phase's flat leg (K = 4,096 x D = 64, and
    its first 64 keys), random planes at K = 2 x D = 64 x W = 512 (a
    cluster of CTAs a key; the parent layout's device-scratch case), and
    random planes at the class boundaries of ujson_resident.flat_plan."""
    from jylis_tpu_torch.ops import ujson_device as udev, ujson_resident as ures

    rng = np.random.default_rng(SEED + 30)
    brng = np.random.default_rng(SEED + 31)
    join_rows, flat_rows = [], []
    for wide in (False, True):
        lay = "wide" if wide else "narrow"
        store, keys, groups, grid = uj_5b_setup(wide)
        shift = store._shift
        res0 = uj_clone(store._batch)
        idx = torch.tensor([store._rows[k] for k in keys], dtype=torch.int32, device=DEVICE)
        # the store's width bound as the node's round 8 sees it: a consumed
        # fold's live widths, not the admission buckets
        lw, lc = (int(x) for x in ures.live_widths(store._batch).tolist())
        store._base_w, store._base_c, store._floor_w, store._floor_c = lw, lc, 1, 1
        gw = max(sum(len(d.entries) for d in g) for g in groups)
        gc = max(sum(len(d.ctx.cloud) for d in g) for g in groups)
        out_w, out_c = store._budget_widths(gw, gc)
        l0 = udev.join_rows.launches
        tree = udev.fold_segments(grid, shift)
        k_levels = udev.join_rows.launches - l0
        work = uj_tree_work(grid, shift)
        tree_row = uj_case(
            torch, "ujson_join",
            f"config 5b tree: K=64 x D=512 x W={grid.dots.shape[-1]}, {k_levels} levels, {lay}",
            card, lambda: udev.fold_segments(grid, shift),
            lambda: udev.DocBatch(*(p[:, 0] for p in udev._fold_body(
                grid, shift, udev.join_rows_plain))),
            work, launches_per=k_levels, launch_class=work[2])
        # the subset join with the epilogue, in place at the resident rows
        rk, rp = uj_clone(res0), uj_clone(res0)
        sub_a = udev.DocBatch(*(p[idx.long()] for p in res0))
        sub_work = uj_join_work(sub_a, tree, False, out_w, out_c)
        sub_row = uj_case(
            torch, "ujson_join",
            f"config 5b subset join: {len(keys)} of {res0.dots.shape[0]} rows x "
            f"{res0.dots.shape[-1]} dots + {tree.dots.shape[-1]}, out {out_w}/{out_c}, {lay}",
            card,
            lambda: udev.join_rows(rk, tree, shift, a_idx=idx, finish=(out_w, out_c),
                                   out=ures.slice_widths(rk, out_w, out_c)),
            lambda: udev.join_rows_plain(rp, tree, shift, a_idx=idx, finish=(out_w, out_c),
                                         out=ures.slice_widths(rp, out_w, out_c)),
            sub_work, restorer(rk, res0), restorer(rp, res0),
            launch_class=uj_join_class(sub_a, tree))
        join_rows += [sub_row, tree_row]
        del store, grid, res0, rk, rp, tree, groups

        # config 5: the broadcast fold of 10,240 deltas into 32 replicas
        st5, deltas, g5 = uj_5_setup(wide)
        d5, batch = g5.dots.shape[1], udev.DocBatch(*(p[0] for p in g5))
        shift = st5._shift
        folded = udev.DocBatch(*(p[:, 0] for p in udev._fold_body(g5, shift)))
        gw = sum(len(x.entries) for x in deltas)
        gc = sum(len(x.ctx.cloud) for x in deltas)
        out_w, out_c = st5._budget_widths(gw, gc)
        occ = torch.zeros(st5._row_axis(), dtype=torch.bool, device=DEVICE)
        occ[list(st5._rows.values())] = True
        r0 = uj_clone(st5._batch)
        rk, rp = uj_clone(r0), uj_clone(r0)
        wb = udev.join_work_bytes(folded.dots.element_size(), r0.dots.shape[-1],
                                  folded.dots.shape[-1], r0.cloud.shape[-1],
                                  folded.cloud.shape[-1], r0.vv.shape[-1])
        bc_class = uj_join_class(r0, folded)
        if wb <= udev.SMEM_LIMIT or not bc_class.startswith("cluster"):
            raise AssertionError(f"config 5's broadcast row: {wb} B, {bc_class}, "
                                 "not a cluster past shared memory")
        bc_row = uj_case(
            torch, "ujson_join",
            f"config 5 broadcast: {r0.dots.shape[0]} rows ({UJ5_REPS} occupied) x "
            f"{r0.dots.shape[-1]} + 1 folded row x {folded.dots.shape[-1]} "
            f"(past shared memory: {wb} B a row, {bc_class}), out {out_w}/{out_c}, {lay}",
            card,
            lambda: udev.join_rows(rk, folded, shift, finish=(out_w, out_c), occupied=occ,
                                   out=ures.slice_widths(rk, out_w, out_c)),
            lambda: udev.join_rows_plain(rp, folded, shift, finish=(out_w, out_c),
                                         occupied=occ, out=ures.slice_widths(rp, out_w, out_c)),
            uj_join_work(r0, folded, True, out_w, out_c), restorer(rk, r0), restorer(rp, r0),
            launch_class=bc_class)
        l0 = udev.join_rows.launches
        udev._fold_body(g5, shift)
        levels5 = udev.join_rows.launches - l0
        work = uj_tree_work(g5, shift)
        t5_row = uj_case(
            torch, "ujson_join",
            f"config 5 tree: D={d5} x W={batch.dots.shape[-1]}, {levels5} levels, {lay}",
            card, lambda: udev.DocBatch(*(p[:, 0] for p in udev._fold_body(g5, shift))),
            lambda: udev.DocBatch(*(p[:, 0] for p in udev._fold_body(
                g5, shift, udev.join_rows_plain))),
            work, launches_per=levels5, launch_class=work[2])
        join_rows += [bc_row, t5_row, uj_edge_case(torch, card, wide)]
        del st5, batch, g5, folded, r0, rk, rp, deltas

        # the class boundaries (ujson_device.join_plan): random rows of the
        # widest width the warp class takes (dots and cloud alike, R = 8)
        # and of the next width, 1,024 slots; 64-wide rows in the fewest
        # slots the warp class takes and in half as many
        shift = 32 if wide else 28
        wx = uj_warp_max_width(8 if wide else 4, 8)
        for n, width in ((1024, wx), (1024, wx + 4), (udev.WARP_MIN_ROWS, 64),
                         (udev.WARP_MIN_ROWS // 2, 64)):
            a = uj_random_planes(torch, rng, (n,), width, width, 8, shift)
            b = uj_random_planes(torch, rng, (n,), width, width, 8, shift)
            join_rows.append(uj_case(
                torch, "ujson_join",
                f"random rows at the class boundary: {n} x {width} dots + {width}, "
                f"C={width}+{width} R=8, {lay}",
                card, lambda: udev.join_rows(a, b, shift),
                lambda: udev.join_rows_plain(a, b, shift),
                uj_join_work(a, b, False, 2 * width, 2 * width),
                launch_class=uj_join_class(a, b)))
        del a, b

        # ujson_fold_flat at the flat leg's shape and its first 64 keys
        stf = ures.ResidentStore(n_rep=32, device=DEVICE)
        stf._grow_reps_to(32)
        if wide:
            stf._widen()
        gridf = stf._grid_to_device(stf._encode_grid(flat_groups))
        shift = stf._shift
        for kk in (gridf.dots.shape[0], 64):
            g = udev.DocBatch(*(p[:kk].contiguous() for p in gridf))
            fo = ures.fold_flat_plain(g, shift)
            flat_rows.append(uj_case(
                torch, "ujson_fold_flat",
                f"flat leg: K={kk} x D={g.dots.shape[1]} x W={g.dots.shape[2]} "
                f"C={g.cloud.shape[2]} R={g.vv.shape[2]}, {lay}",
                card, lambda: ures.fold_flat(g, shift),
                lambda: ures.fold_flat_plain(g, shift), uj_flat_work(g, fo),
                launch_class=uj_flat_class(g)))
        # random planes: few wide keys (from the phase's generator, so a
        # tree of the earlier kernel draws the same planes), then the class
        # boundaries of ujson_resident.flat_plan (from their own generator)
        tsize = 8 if wide else 4
        for kk, d, w, c, r in [(2, 64, 512, 64, 8)] + UJ_FLAT_BOUNDARIES[tsize]:
            shift = 32 if wide else udev.narrow_shift(r)
            g = (uj_random_planes(torch, rng, (kk, d), w, c, r, shift) if kk == 2 else
                 uj_random_planes(torch, brng, (kk, d), w, c, r, shift,
                                  empty=range(0, kk * d, 5), wrap=True))
            flat_rows.append(uj_case(
                torch, "ujson_fold_flat",
                f"random planes: K={kk} x D={d} x W={w} C={c} R={r} "
                f"({ures.flat_work_bytes(tsize, d, w, c, r)} B a key), {lay}",
                card, lambda: ures.fold_flat(g, shift), lambda: ures.fold_flat_plain(g, shift),
                uj_flat_work(g, ures.fold_flat_plain(g, shift)), launch_class=uj_flat_class(g)))
            del g
        del stf, gridf
        torch.cuda.empty_cache()
    # the first row of each kernel is its main path's shape (narrow)
    return {"ujson_join": dict(join_rows[0], other_shapes=join_rows[1:]),
            "ujson_fold_flat": dict(flat_rows[0], other_shapes=flat_rows[1:])}


def ujson_store_phase(torch) -> dict:
    """BASELINE config 5 (bench.py:1107-1194, published shape): 32
    replica documents admitted to a ResidentStore(n_rep=32) on the card;
    each round's 1,280 deltas (32 writers x 40 set_doc edits over 8
    fields) go through fold_in_broadcast, which buffers the 8 rounds
    (10,240 deltas, under BCAST_FLUSH_DELTAS) into one fold at block();
    then dump(): all 32 renders must be equal, and equal to the host
    join of the 32 writers' final documents."""
    from jylis_tpu_torch.ops import ujson_device as udev, ujson_resident as ures
    from jylis_tpu_torch.ops.ujson_host import UJSON

    t0 = time.perf_counter()
    writers = [UJSON() for _ in range(UJ5_REPS)]
    streams = [uj_5_round(writers, rnd) for rnd in range(UJ5_ROUNDS)]
    gen_s = time.perf_counter() - t0
    ref = uj_join(writers)
    l0 = (udev.join_rows.launches, ures.fold_flat.launches)
    t0 = time.perf_counter()
    store = ures.ResidentStore(n_rep=UJ5_REPS, device=DEVICE)
    store.admit([(b"rep%02d" % i, UJSON()) for i in range(UJ5_REPS)])
    for deltas in streams:
        store.fold_in_broadcast(deltas)
    store.block()
    fold_s = time.perf_counter() - t0
    launches = udev.join_rows.launches - l0[0]
    t0 = time.perf_counter()
    dumped = store.dump()
    dump_s = time.perf_counter() - t0
    renders = {doc.render() for _, doc in dumped}
    if len(dumped) != UJ5_REPS or renders != {ref.render()}:
        raise AssertionError(f"config 5: {len(renders)} distinct renders of {len(dumped)}")
    for key, doc in dumped:
        if uj_canon(doc) != uj_canon(ref):
            raise AssertionError(f"config 5 {key!r}: state differs from the host join")
    if store._batch.dots.device.type != DEVICE or (DEVICE == "cuda" and launches < 1):
        raise AssertionError(f"config 5 store on {store._batch.dots.device}, {launches} joins")
    out = dict(replicas=UJ5_REPS, deltas=sum(len(s) for s in streams),
               join_launches=launches, fold_flat_launches=ures.fold_flat.launches - l0[1],
               generate_s=gen_s, admit_fold_block_s=fold_s, dump_s=dump_s,
               delta_merges=UJ5_REPS * sum(len(s) for s in streams),
               planes=[list(p.shape) for p in store._batch], shift=store._shift)
    emit({"phase": "ujson_store_config5", **out})
    return out


def ujson_node_phase(torch, n5b: int = UJ5B_KEYS, rounds5b: int = UJ5B_ROUNDS,
                     n_flat: int = UJ_FLAT_KEYS, n_grow: int = UJ_GROW_KEYS,
                     flat=None) -> dict:
    """UJSON on a real Server over the port's Database on DEVICE; deltas
    enter through Database.converge_async, references are each writer's
    own final documents joined once per writer and key.

    (a) config 5b: n5b keys, 8 replica ids, rounds of 512 INS deltas per
        key; round 1 promotes every key, every round folds by the tree
        (D = 512); (c) replica growth: n_grow more keys get config 5's
        set_doc edits from 32 replica ids over 2 rounds (D = 1,280 by the
        tree): the column budget passes 8 and the store repacks narrow,
        shift 28 to 26; (b) the flat leg: n_flat more keys x 64 deltas
        (INS, SET and RM from 3 replica ids, removals of observed values)
        in one batch past PENDING_TOTAL_MAX: one segmented drain admits
        them and folds by the flat rule (D = 64); (d) widening: a replica
        sends a seq >= 2^26 - 1 with a 5b round (the store widens to u64,
        and that round folds by the tree in it), then a flat round on
        UJ_WIDE_FLAT flat keys; (e) over the socket: UJSON GET of every
        key, whole and at a path; a trickle of 3 deltas on UJ_TRICKLE
        resident keys, read host-side (<= TRICKLE_MAX pending stays
        pending); local INS/SET/RM/CLR on UJ_LOCAL resident keys (they
        demote), applied to the references through the same host
        lattice; GETs again. Then dump_state() (every pending delta
        drains, every resident row decodes) against the references, key
        by key, canonicalised as sync_canon does. (The legs run in the
        order a, c, b, d, e: the flat leg's admission fills the store's
        BYTE_BUDGET, after which new keys stay on the host lattice.)"""
    from jylis_tpu_torch.models import repo_ujson
    from jylis_tpu_torch.ops import ujson_device as udev, ujson_resident as ures
    from jylis_tpu_torch.ops.ujson_host import UJSON

    t_gen = 0.0
    keys5 = [b"doc%03d" % k for k in range(n5b)]
    keys_g = [b"grow%03d" % k for k in range(n_grow)]
    if flat is None:
        t0 = time.perf_counter()
        flat = uj_flat_data(n_flat)
        t_gen += time.perf_counter() - t0
    flat_ws, flat_groups = flat
    keys_f = [b"flat%05d" % k for k in range(len(flat_ws))]
    writers5 = [UJSON() for _ in keys5]
    writers_g = [[UJSON() for _ in range(UJ5_REPS)] for _ in keys_g]
    refs_extra: dict[bytes, list] = {}  # more writer docs per key
    node = Node(identity=UJ_IDENTITY)
    repo = node.repo("UJSON")
    legs = []
    replies = 0
    try:
        reset_counts(udev.join_rows, ures.fold_flat)

        def deliver(leg, batch, note=None):
            l0 = (udev.join_rows.launches, ures.fold_flat.launches)
            c0 = dict(udev.join_rows.classes)
            t0 = time.perf_counter()
            node.converge("UJSON", batch)
            st = repo._res
            legs.append(dict(
                leg=leg, deltas=len(batch), converge_s=time.perf_counter() - t0,
                join=udev.join_rows.launches - l0[0], fold_flat=ures.fold_flat.launches - l0[1],
                join_classes={c: n - c0.get(c, 0) for c, n in udev.join_rows.classes.items()
                              if n != c0.get(c, 0)},
                shift=None if st is None else st._shift,
                resident=0 if st is None else len(st),
                planes=None if st is None else list(st._batch.dots.shape), **(note or {})))

        # (a) config 5b
        for rnd in range(rounds5b):
            t0 = time.perf_counter()
            groups = uj_5b_round(writers5, rnd)
            batch = [(k, d) for k, g in zip(keys5, groups) for d in g]
            t_gen += time.perf_counter() - t0
            deliver(f"a{rnd + 1}", batch)
        # (c) replica growth: 32 replica ids (100..131) on new keys
        for rnd in range(2):
            t0 = time.perf_counter()
            batch = [(k, d) for k, ws in zip(keys_g, writers_g)
                     for d in uj_5_round(ws, rnd, rid0=100)]
            t_gen += time.perf_counter() - t0
            deliver(f"c{rnd + 1}", batch)
        # (b) the flat leg, one batch
        deliver("b", [(k, d) for k, g in zip(keys_f, flat_groups) for d in g])
        # (d) a seq past the narrow layout, with a 5b round (the tree) ...
        t0 = time.perf_counter()
        big_w = UJSON()
        big = (1 << 26) + 2
        big_w.ctx.vv[999] = big
        d_big = UJSON()
        d_big.ctx.vv[999] = big
        big_w.ins(999, ("wide",), "1", d_big)
        refs_extra[keys5[0]] = [big_w]
        groups = uj_5b_round(writers5, rounds5b)
        batch = [(keys5[0], d_big)] + [(k, d) for k, g in zip(keys5, groups) for d in g]
        t_gen += time.perf_counter() - t0
        shift0 = repo._res._shift
        deliver("d tree", batch, {"shift_before": shift0})
        # ... and a flat round, in the wide layout
        t0 = time.perf_counter()
        wide_keys = list(range(min(UJ_WIDE_FLAT, len(keys_f))))
        batch = [(keys_f[i], d) for i in wide_keys
                 for d in uj_flat_deltas(flat_ws[i], i, 1)]
        t_gen += time.perf_counter() - t0
        deliver("d flat", batch)
        converge_launches = {"ujson_join": udev.join_rows.launches,
                             "ujson_fold_flat": ures.fold_flat.launches}
        store = repo._res
        if store._shift != 32:
            raise AssertionError(f"UJSON store did not widen: shift {store._shift}")
        if n_grow and n5b and not any(lg["shift"] == 26 for lg in legs[:rounds5b + 2]):
            raise AssertionError(f"UJSON store did not repack to shift 26: {legs}")

        # the references: each key's writers, joined once
        def writer_docs(key):
            if key.startswith(b"doc"):
                docs = [writers5[keys5.index(key)]]
            elif key.startswith(b"grow"):
                docs = writers_g[keys_g.index(key)]
            else:
                docs = flat_ws[keys_f.index(key)]
            return docs + refs_extra.get(key, [])

        all_keys = keys5 + keys_g + keys_f
        t0 = time.perf_counter()
        refs = {k: uj_join(writer_docs(k)) for k in all_keys}
        ref_s = time.perf_counter() - t0
        cmds, want = [], []

        def send(cmd, expect):
            cmds.append(cmd)
            want.append(expect)

        def run(what, chunk=256):
            nonlocal replies
            t0 = time.perf_counter()
            got = node.client.pipeline(cmds, chunk)
            check_replies(what, got, want)
            replies += len(got)
            cmds.clear()
            want.clear()
            return time.perf_counter() - t0

        def path_of(key):
            return ("tags",) if not key.startswith(b"grow") else ("field3",)

        for k in all_keys:
            send(("UJSON", "GET", k), bulk(refs[k].render().encode()))
            send(("UJSON", "GET", k, *path_of(k)),
                 bulk(refs[k].render(path_of(k)).encode()))
        get_s = run("UJSON GET every key")
        # a trickle on resident keys: served host-side, left pending
        trick = keys_f[-UJ_TRICKLE:]  # disjoint from the local writes' flat keys
        batch = []
        for k in trick:
            ws = flat_ws[keys_f.index(k)]
            for i in range(3):
                d = UJSON()
                ws[2].ins(UJ_FLAT_RIDS[2], ("tags",), str(900000 + i), d)
                batch.append((k, d))
        l0 = udev.join_rows.launches
        node.converge("UJSON", batch)
        for k in trick:
            refs[k] = uj_join(writer_docs(k))
            send(("UJSON", "GET", k, "tags"), bulk(refs[k].render(("tags",)).encode()))
        trickle_s = run("UJSON trickle GETs")
        pend = [len(repo._pend.get(k, ())) for k in trick]
        if set(pend) != {3} or (DEVICE == "cuda" and udev.join_rows.launches != l0):
            raise AssertionError(f"UJSON trickle reads folded on the device: {set(pend)}")
        # local writes on resident keys (each demotes its key)
        local = keys5[1:3] + keys_g[:3] + trick[:5] + keys_f[: UJ_LOCAL - 10]
        for k in local:
            if not store.__contains__(k):
                raise AssertionError(f"UJSON {k!r} is not resident before its local write")
            r = refs[k]
            vals = sorted(t for p, t in r.entries.values() if p == ("tags",))
            send(("UJSON", "INS", k, "tags", '"local"'), b"+OK\r\n")
            r.ins(UJ_IDENTITY, ("tags",), '"local"')
            send(("UJSON", "SET", k, "f", '{"z": [1, 2]}'), b"+OK\r\n")
            r.set_doc(UJ_IDENTITY, ("f",), '{"z": [1, 2]}')
            if vals:
                send(("UJSON", "RM", k, "tags", vals[0]), b"+OK\r\n")
                r.rm(UJ_IDENTITY, ("tags",), vals[0])
            send(("UJSON", "CLR", k, "field3"), b"+OK\r\n")
            r.clr(UJ_IDENTITY, ("field3",))
            send(("UJSON", "GET", k), bulk(r.render().encode()))
        local_s = run("UJSON local writes", chunk=64)
        demoted = sum(1 for k in local if k not in store)
        for k in all_keys[::7] + local:
            send(("UJSON", "GET", k), bulk(refs[k].render().encode()))
        send(("UJSON", "GET", b"missing"), bulk(b""))
        again_s = run("UJSON GETs after the writes")

        # the whole state: every pending delta drains, every row decodes
        t0 = time.perf_counter()
        for p in store._batch:
            if p.device.type != DEVICE:
                raise AssertionError(f"UJSON resident planes on {p.device}")
        resident = len(store)
        got = dict(repo.dump_state())
        if set(got) != set(all_keys):
            raise AssertionError(f"UJSON dump: {len(got)} keys, {len(all_keys)} in the references")
        bad = [k for k in all_keys if uj_canon(got[k]) != uj_canon(refs[k])]
        if bad:
            raise AssertionError(f"UJSON state of {bad[0]!r} != its reference; "
                                 f"{len(bad)} keys differ")
        check_s = time.perf_counter() - t0
        # the dump's drain folded the trickles: the phase's launches end here
        launches = {"ujson_join": udev.join_rows.launches,
                    "ujson_fold_flat": ures.fold_flat.launches}
        classes = {"ujson_join": dict(udev.join_rows.classes),
                   "ujson_fold_flat": dict(ures.fold_flat.classes)}
    finally:
        node.close()
    if DEVICE == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"UJSON kernels did not launch: {launches}")
    if demoted != len(local):
        raise AssertionError(f"UJSON local writes demoted {demoted} of {len(local)}")
    out = {"launches": launches, "classes": classes, "converge_launches": converge_launches,
           "keys": len(all_keys), "legs": legs, "generate_s": t_gen,
           "references_s": ref_s, "get_s": get_s, "trickle_s": trickle_s,
           "local_writes_s": local_s, "gets_again_s": again_s, "check_s": check_s,
           "replies_checked": replies, "keys_checked": len(all_keys),
           "resident_before_dump": resident, "store_full": store.full(),
           "final_planes": [list(p.shape) for p in store._batch],
           "thresholds": [repo_ujson.DEVICE_FANIN_MIN, repo_ujson.SEG_FANIN_MIN,
                          repo_ujson.PENDING_TOTAL_MAX, repo_ujson.TRICKLE_MAX]}
    out["serving"] = node.served
    emit({"phase": "ujson_node", **out})
    return out


def uj_flat_data(n_keys: int):
    """The flat leg's writers and deltas: per key, writers A, B, C and
    the 64 deltas of uj_flat_deltas (round 0)."""
    from jylis_tpu_torch.ops.ujson_host import UJSON

    ws, groups = [], []
    for k in range(n_keys):
        w = [UJSON(), UJSON(), UJSON()]
        groups.append(uj_flat_deltas(w, k, 0))
        ws.append(w)
    return ws, groups


# ---- several cards: what a node on every visible card must show --------------------

# the kernels a node keys-sharded over several cards launches per card on
# the cluster phase's data (any one of a group on every card): the
# staged counter and TREG drains, TLOG's routed drain, a UJSON fold
CARDS_PATH = (("counter_drain_sparse<1>",), ("counter_drain_sparse<2>",),
              ("treg_drain_sparse",), ("tlog_drain_sparse",), ("ujson_join", "ujson_fold_flat"))


def n_cards(torch) -> int:
    """The cards this run sees (0 in a CPU rehearsal)."""
    return torch.cuda.device_count() if DEVICE == "cuda" else 0


def not_run(torch, step: str) -> None:
    """The line of a step that needs two or more cards, on one."""
    emit({"phase": step, "ran": False,
          "why": f"needs 2 or more cards; {n_cards(torch)} visible"})


def sync_cards(torch) -> None:
    """Wait for every visible card (torch.cuda.synchronize() waits for
    the current one only)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def by_card(counters) -> dict:
    """Kernel name -> {card index (a string, as JSON keys are): launches}
    of the wrappers in ``counters``, those that launched."""
    return {n: {str(k): v for k, v in sorted(c.by_card.items())}
            for n, c in counters.items() if c.by_card}


def card_diff(now: dict, before: dict) -> dict:
    out = {}
    for n, cards in now.items():
        d = {k: v - before.get(n, {}).get(k, 0) for k, v in cards.items()}
        d = {k: v for k, v in d.items() if v}
        if d:
            out[n] = d
    return out


def card_sum(*tallies) -> dict:
    out: dict = {}
    for t in tallies:
        for n, cards in t.items():
            for k, v in cards.items():
                out.setdefault(n, {})[k] = out.get(n, {}).get(k, 0) + v
    return out


def off_cards(tally: dict, groups, cards: int) -> list:
    """The (kernel group, card) pairs of ``groups`` on which no kernel of
    the group launched."""
    return [(g, c) for g in groups for c in range(cards)
            if not any(tally.get(n, {}).get(str(c)) for n in g)]


def card_apps() -> dict:
    """Compute apps per card, by the card's UUID, every card listed (0
    where none): nvidia-smi --query-compute-apps=gpu_uuid,pid,used_memory.
    In a pid namespace of its own nvidia-smi shows other pids than the
    processes', so apps are counted per card, not matched by pid."""
    uuids = subprocess.run(["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60,
                           check=True).stdout.split()
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=gpu_uuid,pid,used_memory",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.splitlines()
    out = {u: 0 for u in uuids}
    for line in apps:
        uuid = line.split(",")[0].strip()
        if uuid:
            out[uuid] = out.get(uuid, 0) + 1
    return out


def check_card_apps(what: str, before: dict, more: int = 1) -> dict:
    """Every card lists at least ``more`` compute apps beyond ``before``
    (a ``card_apps`` read taken before the processes started); returns
    the new read."""
    now = card_apps()
    short = {u: (before.get(u, 0), n) for u, n in now.items() if n - before.get(u, 0) < more}
    if short:
        raise AssertionError(f"{what}: cards without {more} new compute app(s) "
                             f"(before, now): {short}")
    return now


def cards_phase(torch) -> dict:
    """The visible cards, the peer access of every ordered pair
    (torch.cuda.can_device_access_peer) and the compute apps per card
    before any node starts."""
    n = torch.cuda.device_count()
    out = {"count": n, "names": [torch.cuda.get_device_name(i) for i in range(n)],
           "peer_access": {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
                           for i in range(n) for j in range(n) if i != j},
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=index,name,uuid,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip().splitlines(),
           "compute_apps": card_apps()}
    emit({"phase": "cards", **out})
    return out


# ---- mesh phases: the keys-sharded serving mesh ----------------------------------

MESH_SHARDS = 4
# replica_join at the north star's 64 replicas (BASELINE.json) x 1,048,576
# keys: 512 MB in, the one joined row (8 MB) out
RJ_S, RJ_K, RJ_ODD = 64, 1 << 20, 7
# the aligned UJSON folds: the flat leg's shape (4,096 keys x 64 deltas,
# W = 4, R = 32) and a tree-shaped one (D > 64)
UJ_ALIGNED = ((4096, 64, 4, 32), (256, 130, 4, 8))
# the mesh node phase's script: config 2's counters (100,000 keys x 8
# replica ids), 100,000 TREG keys with prefix ties, TLOG with trims, UJSON
# with a flat round (512 keys x 64 deltas) and a tree round (16 keys x 512
# deltas). The cluster and persistence phases run it at MESH_KEYS; the
# mesh node and digest phases at MESH_NODE_KEYS (cut from 100,000 to
# keep the whole run near half its time limit: their checks are of
# sharding and of the digest, not of scale)
MESH_KEYS, MESH_MORE = 100_000, 400
MESH_NODE_KEYS = 50_000
MESH_TLOG_KEYS, MESH_TLOG_ROUNDS, MESH_TLOG_D = 2_000, 3, 16
MESH_UJ_FLAT, MESH_UJ_TREE = 512, 16


def mesh_devices(torch) -> list[str]:
    """The 4-shard mesh's devices: one card each when 4 or more are
    visible, an equal run of shards on each of 2 (two a card), else the
    one card 4 times (DEVICE in a CPU rehearsal)."""
    n = min(n_cards(torch), MESH_SHARDS)
    if n >= 2:
        return [f"cuda:{i * n // MESH_SHARDS}" for i in range(MESH_SHARDS)]
    return [f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE] * MESH_SHARDS


def u64_amax(torch, xt, want):
    """(ms, what) of the one PyTorch call that computes replica_join's
    function, an unsigned max over dim 0: torch.amax on the planes
    viewed as uint64, timed when this torch runs it on the card and it
    equals ``want``; else (None, why). torch.amax on the int64 planes is
    a signed max, another function (its time is "signed_amax_ms")."""
    what = "torch.amax(x.view(torch.uint64), dim=0)"
    try:
        got = torch.amax(xt.view(torch.uint64), dim=0)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        return None, f"none: {what} raises ({str(e).splitlines()[0][:120]})"
    if not torch.equal(got.view(torch.int64), want):
        return None, f"none: {what} differs from the unsigned max"
    return time_ms(torch, lambda: torch.amax(xt.view(torch.uint64), dim=0)), what


def replica_join_phase(torch, card: str) -> dict:
    """replica_join at S = 64 x K = 1,048,576 and at odd S = 7: values
    >= 2^63, a column of 0s and one of 2^64-1; bit for bit against the
    plain version and against numpy on the first 65,536 columns, then
    timed beside torch.amax over the same bytes: on the planes viewed as
    uint64 (the same function; u64_amax) and on the int64 planes (a
    signed max, the nearest one-call reduction when the first is
    missing)."""
    from jylis_tpu_torch.ops import planes
    from jylis_tpu_torch.parallel import replica_join, replica_join_plain

    rng = np.random.default_rng(SEED + 40)
    rows = []
    for s in (RJ_S, RJ_ODD):
        x = u64_np(rng, (s, RJ_K))
        x[:, 0] = 0
        x[-1, 1] = U64
        x[:, 2] = 1 << 63
        xt = planes.to_tensor(x, DEVICE)
        l0 = replica_join.launches
        got = replica_join(xt)
        want = replica_join_plain(xt)
        torch.cuda.synchronize()
        launched = replica_join.launches - l0
        err = max_abs_err(torch, [(got, want)])
        host = planes.to_u64_np(got[: 1 << 16])
        if err or launched != on_card(1) or not (host == x[:, : 1 << 16].max(axis=0)).all():
            raise AssertionError(f"replica_join S={s}: err {err}, "
                                 f"launches {launched}")
        ms = time_ms(torch, lambda: replica_join(xt))
        dev_ms = device_ms(torch, lambda: replica_join(xt), "replica_join")
        plain_ms = time_ms(torch, lambda: replica_join_plain(xt))
        signed_ms = time_ms(torch, lambda: torch.amax(xt, dim=0))
        lib_ms, library = u64_amax(torch, xt, want)
        nbytes = (s + 1) * RJ_K * 8
        b_ms, b_by = bound(nbytes, s * RJ_K, card)
        row = dict(shape=f"S={s} x K={RJ_K}", max_abs_err=err,
                   kernel_ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                   library=library, signed_amax_ms=signed_ms,
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, launches=launched)
        emit({"phase": "replica_join", **row, "card": card})
        rows.append(row)
        del x, xt, got, want
        torch.cuda.empty_cache()
    return {"replica_join": dict(rows[0], other_shapes=rows[1:])}


RJ_MESHES = ((4, 1), (2, 2))  # (rep, keys) meshes of the replica join across cards


def host_ms(torch, fn) -> float:
    """Median over TIMED_RUNS of the host clock around one call of
    ``fn`` and a wait for every card, after one warm-up: a step that
    spans cards, which one card's CUDA events cannot time."""
    fn()
    sync_cards(torch)
    runs = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        fn()
        sync_cards(torch)
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def replica_join_cards_phase(torch, card: str) -> dict:
    """The north-star replica join across cards: S = 64 x K = 1,048,576
    u64 states sharded P("rep", "keys") over a (rep 4, keys 1) and a
    (2, 2) mesh of the mesh_devices cards, through join_replica_axis.
    Every block of the result holds, bit for bit, the join that
    replica_join gives on one card, which numpy's max gives on the first
    65,536 columns. Timed apart (host_ms): the local folds (a
    replica_join per block, all launched before the wait), the copies of
    the folded rows to each keys column's rep-0 card (bytes, GB/s), the
    leader's fold, the copies of the joined rows back, and the whole
    call. Not run with fewer than 2 cards."""
    from jylis_tpu_torch import parallel as par
    from jylis_tpu_torch.ops import planes

    devs = mesh_devices(torch)
    if len(set(devs)) < 2:
        not_run(torch, "replica_join_cards")
        return {}
    gen = torch.Generator(device=devs[0])
    gen.manual_seed(SEED + 41)
    with torch.cuda.device(devs[0]):
        x = _rand64(torch, (RJ_S, RJ_K), gen)
    x[:, 0] = 0
    x[-1, 1] = -1  # 2^64 - 1
    x[:, 2] = -(1 << 63)  # 2^63
    want = par.replica_join(x)
    head = planes.to_u64_np(x[:, : 1 << 16]).max(axis=0)
    if not (planes.to_u64_np(want[: 1 << 16]) == head).all():
        raise AssertionError("replica_join on one card != numpy's max")
    rows = []
    for rep, nk in RJ_MESHES:
        mesh = par.make_mesh(MESH_SHARDS, rep=rep, devices=devs)
        blocks = par.shard_grid(mesh, x)
        sync_cards(torch)
        l0 = par.replica_join.launches
        got = par.join_replica_axis(mesh, blocks)
        sync_cards(torch)
        launched = par.replica_join.launches - l0
        kc = RJ_K // nk
        err = 0
        for r in range(rep):
            for c in range(nk):
                g, b = got[r][c], blocks[r][c]
                if g.device != b.device or tuple(g.shape) != tuple(b.shape):
                    raise AssertionError(f"join_replica_axis {rep}x{nk}: block ({r}, {c}) "
                                         f"{tuple(g.shape)} on {g.device}")
                err = max(err, max_abs_err(torch, [(g[0].to(want.device),
                                                    want[c * kc:(c + 1) * kc])]))
        if err or launched != on_card(rep * nk + (nk if rep > 1 else 0)):
            raise AssertionError(f"join_replica_axis {rep}x{nk}: err {err}, "
                                 f"launches {launched}")
        folded = [[par.replica_join(b) for b in row] for row in blocks]
        sync_cards(torch)
        cross = sum(folded[r][c].device != folded[0][c].device
                    for r in range(rep) for c in range(nk))
        copy_bytes = cross * kc * 8

        def to_lead():
            return [torch.stack([folded[r][c].to(folded[0][c].device) for r in range(rep)])
                    for c in range(nk)]

        stacked = to_lead()
        joined = [par.replica_join(st) for st in stacked]
        out = dict(
            mesh=f"rep {rep} x keys {nk}", devices=[[str(b.device) for b in row]
                                                     for row in blocks],
            max_abs_err=err, launches=launched,
            local_folds_ms=host_ms(torch, lambda: [[par.replica_join(b) for b in row]
                                                   for row in blocks]),
            copy_to_lead_ms=host_ms(torch, to_lead),
            lead_fold_ms=host_ms(torch, lambda: [par.replica_join(st) for st in stacked]),
            copy_back_ms=host_ms(torch, lambda: [joined[c].to(blocks[r][c].device)
                                                 for r in range(rep) for c in range(nk)]),
            call_ms=host_ms(torch, lambda: par.join_replica_axis(mesh, blocks)),
            one_card_ms=host_ms(torch, lambda: par.replica_join(x)),
            cross_card_copies=cross, copy_bytes=copy_bytes)
        out["copy_gb_per_s"] = copy_bytes / out["copy_to_lead_ms"] / 1e6 if cross else None
        emit({"phase": "replica_join_cards", **out, "card": card})
        rows.append(out)
        del blocks, got, folded, stacked, joined
    del x, want
    torch.cuda.empty_cache()
    return {"shape": f"S={RJ_S} x K={RJ_K}", "meshes": rows}


def on_card(n: int) -> int:
    """The launches a step makes: ``n`` on the card, none in a CPU
    rehearsal (CPU tensors take the plain versions)."""
    return n if DEVICE == "cuda" else 0


def _rand64(torch, shape, gen):
    """Uniform int64 bit patterns made on the card (half of them >= 2^63
    as u64)."""
    return torch.randint(-(1 << 63), (1 << 63) - 1, shape, generator=gen,
                         dtype=torch.int64, device=DEVICE)


def _split_slots(lr, cols, n: int):
    """Each routed host column cut into the shards' equal slot ranges."""
    w = len(lr) // n
    return [(lr[i * w:(i + 1) * w], [c[i * w:(i + 1) * w] for c in cols]) for i in range(n)]


def _states_equal(torch, a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x.to(y.device), y)
               for x, y in zip(a, b))


def _route_row(torch, name, shape, mesh_fn, counter, card, pad_share, work, **extra):
    """Time one routed mesh drain (CUDA events around the whole call:
    the routed batch's copies to the card, one launch per shard, the
    per-slot read-back) and its kernel's device time per launch, beside
    the bound of one launch: ``work`` is (bytes, operations) per launch,
    counted as the single-device kernel rows count them over the routed
    batch (pad slots included) and split evenly over the launches."""
    ms = time_ms(torch, mesh_fn)
    dev = device_ms(torch, mesh_fn, counter, calls=3)
    b_ms, b_by = bound(work[0], work[1], card)
    row = dict(shape=shape, mesh_call_ms=ms, device_ms_per_launch=dev,
               bound_ms_per_launch=b_ms, bound_by=b_by, bytes_per_launch=work[0],
               pad_share=pad_share, shards=MESH_SHARDS, **extra)
    emit({"phase": f"mesh_route {name}", **row, "card": card})
    return row


def mesh_route_phases(torch, card: str, devs) -> dict:
    """The mesh routes of the existing kernels at full width on a 4-shard
    mesh: each routed drain (one launch per shard) bit for bit against
    the plain versions on the same per-shard slices, and against the
    single-device drain of the unrouted batch on the same data (live
    slots; pad slots read 0)."""
    from jylis_tpu_torch import convert
    from jylis_tpu_torch import parallel as par
    from jylis_tpu_torch.ops import gcount, planes, pncount, tlog, treg
    from jylis_tpu_torch.ops import ujson_device as udev, ujson_resident as ures
    from jylis_tpu_torch.parallel.sharded import shard_device

    mesh = par.make_mesh(MESH_SHARDS, devices=devs)
    rng = np.random.default_rng(SEED + 50)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 50)
    out = {}

    # GCOUNT and PNCOUNT: K = 1,048,576 x R = 64 (0.54 / 1.07 GB of
    # state), B = 65,536
    k, r, b = K_COUNTER, R_COUNTER, B_LARGE
    for name, mod, npl in (("counter_drain_sparse<1>", gcount, 1),
                           ("counter_drain_sparse<2>", pncount, 2)):
        st = (gcount.GCountState(_rand64(torch, (k, r), gen)) if npl == 1 else
              pncount.PNCountState(_rand64(torch, (k, r), gen), _rand64(torch, (k, r), gen)))
        shards = par.shard_state(mesh, st)
        plain = [_clone(s) for s in shards]
        rows = rng.choice(k, b, replace=False).astype(np.int64)
        deltas = u64_np(rng, (b, npl * r))
        t0 = time.perf_counter()
        lr, pay, slots = par.route_drain(rows, deltas, MESH_SHARDS, k // MESH_SHARDS)
        route_s = time.perf_counter() - t0
        live = slots >= 0
        sharded = par.drain_sharded_g if npl == 1 else par.drain_sharded_pn
        l0 = mod.drain_sparse.launches
        sums = sharded(mesh, shards, lr, pay)
        launched = mod.drain_sparse.launches - l0
        psums = []
        for p, (ki, cols) in zip(plain, _split_slots(
                lr, [pay[:, i * r:(i + 1) * r] for i in range(npl)], MESH_SHARDS)):
            dev = shard_device(p)
            psums.append(mod.drain_sparse_plain(
                p, torch.from_numpy(ki).to(dev),
                *(planes.to_tensor(c, dev) for c in cols)).cpu().numpy())
        ki = torch.from_numpy(rows.astype(np.int32)).to(DEVICE)
        dcols = [planes.to_tensor(deltas[:, i * r:(i + 1) * r], DEVICE) for i in range(npl)]
        ssums = mod.drain_sparse(st, ki, *dcols).cpu().numpy()
        pos = np.empty(k, np.int64)
        pos[rows] = np.arange(b)
        torch.cuda.synchronize()
        if launched != on_card(MESH_SHARDS) or not np.array_equal(sums, np.concatenate(psums)) \
                or not np.array_equal(sums[live], ssums[pos[slots[live]]]) or sums[~live].any():
            raise AssertionError(f"{name} mesh route: launches {launched} or sums differ")
        whole = par.gather_state(shards)
        if not (_states_equal(torch, whole, st)
                and _states_equal(torch, par.gather_state(plain), st)):
            raise AssertionError(f"{name} mesh route: state != the single-device drain's")
        del whole, plain
        out[name] = _route_row(
            torch, name,
            f"K={k} x R={r} over {MESH_SHARDS} shards, B={b} routed to {len(slots)} slots",
            lambda: sharded(mesh, shards, lr, pay), "counter_drain_sparse", card,
            1 - b / len(slots), ((npl * b * r * 8 * 3 + len(slots) * 12) / max(launched, 1),
                                 npl * b * r * OPS_PER_COUNTER / max(launched, 1)),
            route_s=route_s, launches=launched,
            single_device_ms=time_ms(torch, lambda: mod.drain_sparse(st, ki, *dcols)))
        del st, shards, dcols, ki
        torch.cuda.empty_cache()

    # TREG: K = 1,048,576, B = 65,536, a third of the deltas tie their row
    k = K_TREG
    pl = treg_planes(rng, k)
    st = treg.TRegState(*treg_tensors(torch, pl, DEVICE))
    st0 = _clone(st)
    shards = par.shard_state(mesh, st)
    plain = [_clone(s) for s in shards]
    rows = rng.choice(k, b, replace=False).astype(np.int64)
    d_ts, d_rank, d_vid = treg_deltas(rng, pl, rows)
    payload = np.stack([d_ts, d_rank, d_vid.astype(np.int64).view(np.uint64)], 1)
    lr, pay, slots = par.route_drain(rows, payload, MESH_SHARDS, k // MESH_SHARDS)
    live = slots >= 0
    l0 = treg.drain_sparse.launches
    got = par.drain_sharded_treg(mesh, shards, lr, pay)
    launched = treg.drain_sparse.launches - l0
    bits = pay.view(np.int64)
    pouts = []
    for p, (kk, (a, c, v)) in zip(plain, _split_slots(
            lr, (bits[:, 0], bits[:, 1], pay[:, 2].astype(np.int32)), MESH_SHARDS)):
        dev = p.vid.device
        o = treg.drain_sparse_plain(p, torch.from_numpy(kk).to(dev),
                                    torch.from_numpy(a.copy()).to(dev),
                                    torch.from_numpy(c.copy()).to(dev),
                                    torch.from_numpy(v.copy()).to(dev))
        pouts.append([x.cpu().numpy() for x in o])
    sgl = treg.drain_sparse(st, torch.from_numpy(rows.astype(np.int32)).to(DEVICE),
                            *treg_tensors(torch, (d_ts, d_rank, d_vid), DEVICE))
    sgl = [x.cpu().numpy() for x in sgl]
    pos = np.empty(k, np.int64)
    pos[rows] = np.arange(b)
    ok = launched == on_card(MESH_SHARDS)
    for g, pp, s in zip(got, zip(*pouts), sgl):
        ok = ok and np.array_equal(g, np.concatenate(pp))
        ok = ok and np.array_equal(g[live], s[pos[slots[live]]])
    ties = int(got[0][live].sum())
    if not ok or not ties:
        raise AssertionError(
            f"TREG mesh route: launches {launched}, ties {ties}, or outputs differ")
    if not (_states_equal(torch, par.gather_state(shards), st)
            and _states_equal(torch, par.gather_state(plain), st)):
        raise AssertionError("TREG mesh route: state != the single-device drain's")
    del plain
    wins = changed(torch, st0, st)
    out["treg_drain_sparse"] = _route_row(
        torch, "treg_drain_sparse",
        f"K={k} over {MESH_SHARDS} shards, B={b} routed to {len(slots)} slots",
        lambda: par.drain_sharded_treg(mesh, shards, lr, pay), "treg_drain_sparse", card,
        1 - b / len(slots), ((len(slots) * 17 + b * 40 + wins * 20) / launched,
                             b * OPS_PER_REGISTER / launched),
        launches=launched, ties=ties, wins=wins)
    del st, st0, shards
    torch.cuda.empty_cache()

    # TLOG: config 4, wide (K = 16,384, L = 1,024, Ld = 128), every row
    # routed with its trim count; some rows near L flag overflow
    k, L, ld = K_TLOG, L_TLOG, LD_SPARSE
    lens = rng.integers(0, L // 2, k)
    near = rng.random(k) < 0.04
    lens[near] = rng.integers(L - 40, L + 1, int(near.sum()))
    tpl, lens32, cut, ts, vid = tlog_rows_np(rng, k, L, lens, True)
    st = convert.tlog_from_jax(*tpl, lens32, cut, device=DEVICE)
    shards = par.shard_state(mesh, st)
    plain = [_clone(s) for s in shards]
    rows = rng.permutation(k).astype(np.int64)
    d_ts, d_vid, d_cut = tlog_delta_np(rng, ts, vid, lens, rows, ld)
    counts = tlog_counts_np(rng, k)
    payload = np.concatenate([d_ts, d_vid.view(np.uint64), d_cut[:, None],
                              counts.view(np.uint64)[:, None]], 1)
    lr, pay, slots = par.route_drain(rows, payload, MESH_SHARDS, k // MESH_SHARDS)
    live = slots >= 0
    l0 = tlog.drain_sparse.launches
    got = par.drain_sharded_tlog(mesh, shards, lr, pay, ld)
    launched = tlog.drain_sparse.launches - l0
    bits = pay.view(np.int64)
    pouts = []
    for p, (kk, cols) in zip(plain, _split_slots(
            lr, (bits[:, :ld], bits[:, ld:2 * ld], bits[:, 2 * ld], bits[:, 2 * ld + 1]),
            MESH_SHARDS)):
        dev = p.ntl.device
        o = tlog.drain_sparse_plain(p, torch.from_numpy(kk).to(dev),
                                    *(torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                                      for c in cols))
        pouts.append([x.cpu().numpy() for x in o])
    sgl = tlog.drain_sparse(
        st, torch.from_numpy(rows.astype(np.int32)).to(DEVICE),
        *(torch.from_numpy(np.ascontiguousarray(c)).to(DEVICE) for c in (
            d_ts.view(np.int64), d_vid, d_cut.view(np.int64), counts)))
    sgl = [x.cpu().numpy() for x in sgl]
    pos = np.empty(k, np.int64)
    pos[rows] = np.arange(k)
    ok = launched == on_card(MESH_SHARDS)
    for g, pp, s in zip(got, zip(*pouts), sgl):
        ok = ok and np.array_equal(g, np.concatenate(pp))
        ok = ok and np.array_equal(g[live], s[pos[slots[live]]])
    flagged = int(got[0][live].sum())
    if not ok or not flagged:
        raise AssertionError(f"TLOG mesh route: launches {launched}, flagged {flagged}, "
                             "or outputs differ")
    if not (_states_equal(torch, par.gather_state(shards), st)
            and _states_equal(torch, par.gather_state(plain), st)):
        raise AssertionError("TLOG mesh route: state != the single-device drain's")
    del plain
    before = convert.tlog_from_jax(*tpl, lens32, cut, device=DEVICE)
    nbytes, nops, _, _ = tlog_work(torch, before, st, lens, cut, rows, d_ts, d_vid, d_cut,
                                   counts, sgl[0], len(slots), False)
    del before
    out["tlog_drain_sparse"] = _route_row(
        torch, "tlog_drain_sparse",
        f"K={k} x L={L} wide over {MESH_SHARDS} shards, B={k} x Ld={ld} with trims",
        lambda: par.drain_sharded_tlog(mesh, shards, lr, pay, ld), "tlog_drain",
        card, 1 - k / len(slots), (nbytes / launched, nops / launched), launches=launched,
        overflow_rows=flagged)
    del st, shards
    torch.cuda.empty_cache()

    # UJSON: the row-aligned fold per shard (flat, then tree-shaped)
    for kk, d, w, r in UJ_ALIGNED:
        shift = udev.narrow_shift(r)
        res = uj_random_planes(torch, rng, (kk,), 64, 32, r, shift)
        grid = uj_random_planes(torch, rng, (kk, d), w, w, r, shift, empty=range(0, kk, 7))
        out_w, out_c = 128, 64
        parts = par.shard_state(mesh, res)
        gparts = par.shard_state(mesh, grid)
        l0 = (udev.join_rows.launches, ures.fold_flat.launches)
        lives = [ures.fold_join_aligned(p, g, shift, out_w, out_c)
                 for p, g in zip(parts, gparts)]
        launched = (udev.join_rows.launches - l0[0], ures.fold_flat.launches - l0[1])
        mesh_out = par.gather_state([o for o, _ in lives])
        single, _ = ures.fold_join_aligned(uj_clone(res), grid, shift, out_w, out_c)
        if d <= ures.FLAT_MAX:
            folded = ures.fold_flat_plain(grid, shift)
        else:
            folded = udev.DocBatch(*(p[:, 0] for p in udev._fold_body(
                grid, shift, udev.join_rows_plain)))
        rp = uj_clone(res)
        want = udev.join_rows_plain(rp, folded, shift, finish=(out_w, out_c),
                                    out=ures.slice_widths(rp, out_w, out_c))
        torch.cuda.synchronize()
        if not (_states_equal(torch, mesh_out, want) and _states_equal(torch, single, want)):
            raise AssertionError(f"UJSON aligned fold K={kk} D={d}: mesh != plain")
        if launched[1 if d <= ures.FLAT_MAX else 0] < on_card(MESH_SHARDS):
            raise AssertionError(f"UJSON aligned fold K={kk} D={d}: launches {launched}")

        def run():  # the widths change: the resident parts are not written
            for p, g in zip(parts, gparts):
                ures.fold_join_aligned(p, g, shift, out_w, out_c)

        name = "ujson_fold_flat" if d <= ures.FLAT_MAX else "ujson_join"
        work = [0, 0]
        for p, g in zip(par.shard_state(mesh, res), gparts):  # the pristine parts
            if d <= ures.FLAT_MAX:
                w_ = uj_flat_work(g, ures.fold_flat_plain(g, shift))
            else:
                w_ = uj_tree_work(g, shift)
                f = udev.DocBatch(*(x[:, 0] for x in udev._fold_body(
                    g, shift, udev.join_rows_plain)))
                w2 = uj_join_work(p, f, False, out_w, out_c)
                w_ = (w_[0] + w2[0], w_[1] + w2[1])
            work[0] += w_[0]
            work[1] += w_[1]
        n_l = launched[1 if d <= ures.FLAT_MAX else 0]
        out.setdefault("ujson_aligned", []).append(_route_row(
            torch, f"fold_join_aligned {name}",
            f"K={kk} x D={d} x W={w} R={r} over {MESH_SHARDS} shards, out {out_w}/{out_c}",
            run, name, card, 0.0, (work[0] / n_l, work[1] / n_l),
            launches={"ujson_join": launched[0], "ujson_fold_flat": launched[1]}))
        del res, grid, parts, gparts, lives, mesh_out, single, folded, rp, want
        torch.cuda.empty_cache()
    return out


# ---- the staged calls: host batch to host results, the old path and the new ----

XFER_BYTES = 64 << 20  # the transfer line's copy


def transfer_phase(torch) -> dict:
    """The copy rates a staged call is bounded by: 64 MB host to device
    from pinned and from pageable memory, and device to pinned host
    memory, each on the CUDA-event clock."""
    dev_buf = torch.empty(XFER_BYTES, dtype=torch.uint8, device=DEVICE)
    pinned = torch.ones(XFER_BYTES, dtype=torch.uint8, pin_memory=True)
    pageable = torch.ones(XFER_BYTES, dtype=torch.uint8)
    out = {}
    for name, fn in (("h2d_pinned", lambda: dev_buf.copy_(pinned, non_blocking=True)),
                     ("h2d_pageable", lambda: dev_buf.copy_(pageable)),
                     ("d2h_pinned", lambda: pinned.copy_(dev_buf, non_blocking=True))):
        ms = time_ms(torch, fn)
        out[f"{name}_ms"] = ms
        out[f"{name}_bytes_per_s"] = XFER_BYTES / ms * 1e3
    emit({"phase": "transfer", "bytes": XFER_BYTES, **out})
    del dev_buf, pinned, pageable
    return out


def _turns(torch, old, new, reset_old=None, reset_new=None):
    """CUDA-event ms a call of the old and of the new path, timed in turns
    (old, new, new, old; each a median of TIMED_RUNS): (old, new, the
    four medians)."""
    t = [time_ms(torch, fn, reset=rs) for fn, rs in
         ((old, reset_old), (new, reset_new), (new, reset_new), (old, reset_old))]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def _fill_ms(ks, rows, fill, fields) -> float:
    """Host ms of writing the batch into one card's pinned staging (the
    part of a new call that the old path spends building its planes),
    in rounds of one Stage each when it overflows one."""
    from jylis_tpu_torch.ops import staging

    stage = ks.stages[0]
    fields = [(np.int32, ()), *fields]
    width = staging.max_slots(fields)
    runs = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        for lo in range(0, len(rows), width):
            sel = slice(lo, min(lo + width, len(rows)))
            views = stage.host_in(sel.stop - sel.start, fields)
            views[0][...] = rows[sel]
            fill(views[1:], sel)
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def _keyspaces(par, mesh, state, n):
    """``n`` keyspaces over ``mesh`` (None: one device), each holding its
    own copy of ``state``."""
    out = []
    for _ in range(n):
        ks = par.Keyspace(mesh, DEVICE)
        ks.place(_clone(state) if mesh is None else state)  # a mesh copies
        out.append(ks)
    return out


def _staging_bytes(ks) -> dict:
    """Pinned host and device bytes the keyspace's staging holds (its
    peak: the buffers only grow, up to staging.MAX_STAGE_BYTES each)."""
    held = {"host": 0, "dev": 0}
    for stage in ks.stages:
        for name, buf in stage._bufs.items():
            held[name.split("_")[0]] += buf.numel()
    return {"staging_pinned_bytes": held["host"], "staging_device_bytes": held["dev"]}


def _check_equal(torch, what, new, plain, old, sel, states) -> int:
    """max_abs_err of the new path's per-slot outputs against the plain
    version's and (at the old path's live slots, ``sel``) the old path's,
    and of the states (new, plain, old); raises unless all are 0."""
    t = torch.from_numpy
    err_out = max_abs_err(torch, [p for a, b, c in zip(new, plain, old)
                                  for p in ((t(a), t(b)), (t(a[sel]), t(c)))])
    err_state = max_abs_err(torch, [(x.to(y.device), y) for w in states[1:]
                                    for x, y in zip(states[0], w) if x is not None])
    if err_out or err_state:
        raise AssertionError(f"{what}: outputs differ by {err_out}, states by {err_state}")
    return max(err_out, err_state)


def _call_row(name, shape, card, xfer, times, launches, dev_ms, kwork, in_fields, out_fields,
              b, err, **extra):
    """One staged-call row: both paths' call times, the new path's device
    time a launch beside the kernel's bound, and the call's bound (the
    kernel's plus the staged bytes at the measured pinned copy rates)."""
    from jylis_tpu_torch.ops import staging

    k_ms, k_by = bound(kwork[0], kwork[1], card)
    in_b = staging.layout(b, [(np.int32, ()), *in_fields])[1]
    out_b = staging.layout(b, out_fields)[1]
    call_bound = (k_ms + in_b / xfer["h2d_pinned_bytes_per_s"] * 1e3
                  + out_b / xfer["d2h_pinned_bytes_per_s"] * 1e3)
    row = dict(shape=shape, old_call_ms=times[0], new_call_ms=times[1], call_runs_ms=times[2],
               old_launches=launches[0], new_launches=launches[1],
               device_ms_per_launch=dev_ms[1], old_device_ms_per_launch=dev_ms[0],
               bound_ms=k_ms, bound_by=k_by, bytes=kwork[0], staged_bytes=in_b + out_b,
               call_bound_ms=call_bound, max_abs_err=err, **extra)
    emit({"phase": f"staged_call {name}", **row, "card": card})
    return row


def counter_call_cases(torch, card: str, devs, xfer) -> dict:
    """counter_drain_sparse<1> and <2> through the staged call at
    K = 1,048,576 x R = 64: B = 1,024 and 65,536 on one device, and
    B = 65,536 over the 4-shard mesh on the card. The new path
    (drain_unrouted_g / _pn, the repos' drain) against its plain version
    (the same call with the plain step) and against the old path on the
    same data: on one device the repo's pageable sequence before the
    staged call (np.zeros planes padded to bucket(B), one pageable copy
    a plane and the rows, the drain into a torch.empty output as the
    parent's wrapper allocated it, one read-back; the card's table is
    built once, outside the call, as the parent's kernel took the
    state's pointers), on the mesh route_drain + drain_sharded_g / _pn.
    Bit for bit: per-slot sums (the old path's live slots) and the
    states. Then both timed."""
    from jylis_tpu_torch import parallel as par
    from jylis_tpu_torch.ops import gcount, planes, pncount
    from jylis_tpu_torch.ops.staging import ShardTable
    from jylis_tpu_torch.utils.batching import bucket, pad_rows

    mesh = par.make_mesh(MESH_SHARDS, devices=devs)
    rng = np.random.default_rng(SEED + 90)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 90)
    k, r = K_COUNTER, R_COUNTER
    out = {}
    for npl, mod in ((1, gcount), (2, pncount)):
        name = f"counter_drain_sparse<{npl}>"
        st = mod.GCountState(_rand64(torch, (k, r), gen)) if npl == 1 else \
            mod.PNCountState(_rand64(torch, (k, r), gen), _rand64(torch, (k, r), gen))
        unrouted = par.drain_unrouted_g if npl == 1 else par.drain_unrouted_pn
        sharded = par.drain_sharded_g if npl == 1 else par.drain_sharded_pn
        fields = [(np.uint64, (r,))] * npl
        rows_out = []
        for b, m in ((B_ENTRY, None), (B_LARGE, None), (B_LARGE, mesh)):
            rows = rng.choice(k, b, replace=False).astype(np.int64)
            deltas = [u64_np(rng, (b, r)) for _ in range(npl)]
            fill = par.fill_from(*deltas)
            ks, ks_plain = _keyspaces(par, m, st, 2)
            pos = np.empty(k, np.int64)
            pos[rows] = np.arange(b)
            if m is None:
                old_state = _clone(st)
                old_table = ShardTable.of(old_state)

                def old(old_table=old_table, rows=rows, deltas=deltas, b=b):
                    bb = bucket(b)
                    ki = pad_rows(bb)
                    ki[:b] = rows
                    dl = []
                    for d in deltas:
                        plane = np.zeros((bb, r), np.uint64)
                        plane[:b] = d
                        dl.append(planes.to_tensor(plane, DEVICE))
                    ki = torch.from_numpy(ki).to(DEVICE)
                    sums = torch.empty(bb, dtype=torch.int64, device=DEVICE)
                    return mod.drain_sparse(old_table, ki, *dl, sums).cpu().numpy()[:b], rows

                old_whole = lambda old_state=old_state: old_state  # noqa: E731
            else:
                old_shards = par.shard_state(m, st)
                stacked = np.concatenate(deltas, 1)

                def old(old_shards=old_shards, rows=rows, stacked=stacked):
                    lr, pay, slots = par.route_drain(rows, stacked, MESH_SHARDS,
                                                     k // MESH_SHARDS)
                    sums = sharded(m, old_shards, lr, pay)
                    live = slots >= 0
                    return sums[live], slots[live]

                old_whole = lambda old_shards=old_shards: par.gather_state(old_shards)  # noqa: E731
            new = lambda ks=ks, rows=rows, fill=fill: unrouted(ks, rows, fill)  # noqa: E731
            l0 = mod.drain_sparse.launches
            got = new()
            l1 = mod.drain_sparse.launches
            plain = unrouted(ks_plain, rows, fill, mod.drain_sparse_plain)
            l2 = mod.drain_sparse.launches
            osums, orows = old()
            l3 = mod.drain_sparse.launches
            torch.cuda.synchronize()
            shape = (f"K={k} x R={r}" + (f" over {MESH_SHARDS} shards on {len(ks.cards)} card(s)"
                                        if m is not None else "") + f", B={b}")
            if l1 - l0 != on_card(len(ks.cards)) or l2 != l1:
                raise AssertionError(f"{name} staged call {shape}: launches {l1 - l0}, "
                                     f"plain {l2 - l1}")
            err = _check_equal(torch, f"{name} staged call {shape}", [got], [plain], [osums],
                               pos[orows], [ks.whole(), ks_plain.whole(), old_whole()])
            del ks_plain
            times = _turns(torch, old, new)
            dev_ms = (device_ms(torch, old, "counter_drain_sparse", calls=3),
                      device_ms(torch, new, "counter_drain_sparse", calls=3))
            rows_out.append(_call_row(
                name, shape, card, xfer, times, (l3 - l2, l1 - l0), dev_ms,
                (npl * b * r * 8 * 3 + b * 12, npl * b * r * OPS_PER_COUNTER),
                fields, [(np.int64, ())], b, err, mesh=m is not None,
                fill_ms=_fill_ms(ks, rows, fill, fields), **_staging_bytes(ks)))
            del ks, old, new
            torch.cuda.empty_cache()
        out[name] = rows_out
        del st
        torch.cuda.empty_cache()
    return out


def treg_call_cases(torch, card: str, devs, xfer) -> dict:
    """treg_drain_sparse through the staged call at K = 1,048,576:
    B = 8,192 and 65,536 on one device, B = 65,536 over the 4-shard mesh
    on the card; a third of the deltas tie their row. New path against
    its plain version and the old path (on one device the repo's
    sequence before the staged call: planes padded to bucket(B), four
    pageable copies, torch.empty outputs as the parent's wrapper
    allocated them, the table built once outside the call, three
    read-backs; on the mesh route_drain + drain_sharded_treg), bit for
    bit: per-slot (tie, ts, vid) and the states; then both timed, each
    call on a fresh copy of its state."""
    from jylis_tpu_torch import parallel as par
    from jylis_tpu_torch.ops import planes, treg
    from jylis_tpu_torch.ops.staging import ShardTable
    from jylis_tpu_torch.utils.batching import bucket, pad_rows

    mesh = par.make_mesh(MESH_SHARDS, devices=devs)
    rng = np.random.default_rng(SEED + 95)
    k = K_TREG
    st_np = treg_planes(rng, k)
    st = treg.TRegState(*treg_tensors(torch, st_np, DEVICE))
    fields = [(np.uint64, ()), (np.uint64, ()), (np.int32, ())]
    outs = [(np.bool_, ()), (np.int64, ()), (np.int32, ())]
    rows_out = []
    for b, m in ((B_TREG_NODE, None), (B_LARGE, None), (B_LARGE, mesh)):
        rows = rng.choice(k, b, replace=False).astype(np.int64)
        d_ts, d_rank, d_vid = treg_deltas(rng, st_np, rows)
        fill = par.fill_from(d_ts, d_rank, d_vid)
        ks, ks_plain = _keyspaces(par, m, st, 2)
        pos = np.empty(k, np.int64)
        pos[rows] = np.arange(b)
        if m is None:
            old_parts = [_clone(st)]

            def old(table=ShardTable.of(old_parts[0]), rows=rows, b=b, d=(d_ts, d_rank, d_vid)):
                bb = bucket(b)
                ts = np.zeros(bb, np.uint64)
                rank = np.zeros(bb, np.uint64)
                vid = np.full(bb, -1, np.int32)
                ts[:b], rank[:b], vid[:b] = d
                ki = pad_rows(bb)
                ki[:b] = rows
                out = (torch.empty(bb, dtype=torch.bool, device=DEVICE),
                       torch.empty(bb, dtype=torch.int64, device=DEVICE),
                       torch.empty(bb, dtype=torch.int32, device=DEVICE))
                tie, o_ts, o_vid = treg.drain_sparse(
                    table, torch.from_numpy(ki).to(DEVICE), planes.to_tensor(ts, DEVICE),
                    planes.to_tensor(rank, DEVICE), torch.from_numpy(vid).to(DEVICE), out)
                return (tie.cpu().numpy()[:b], o_ts.cpu().numpy()[:b],
                        o_vid.cpu().numpy()[:b]), rows

            old_whole = lambda old_parts=old_parts: old_parts[0]  # noqa: E731
        else:
            old_parts = par.shard_state(m, st)
            payload = np.stack([d_ts, d_rank, d_vid.astype(np.int64).view(np.uint64)], 1)

            def old(old_parts=old_parts, rows=rows, payload=payload):
                lr, pay, slots = par.route_drain(rows, payload, MESH_SHARDS, k // MESH_SHARDS)
                res = par.drain_sharded_treg(m, old_parts, lr, pay)
                live = slots >= 0
                return tuple(x[live] for x in res), slots[live]

            old_whole = lambda old_parts=old_parts: par.gather_state(old_parts)  # noqa: E731
        new = lambda ks=ks, rows=rows, fill=fill: par.drain_unrouted_treg(ks, rows, fill)  # noqa: E731
        pristine = [_clone(p) for p in ks.parts]
        reset_new = lambda ks=ks, pristine=pristine: [  # noqa: E731
            restorer(p, q)() for p, q in zip(ks.parts, pristine)]
        reset_old = lambda parts=old_parts, pristine=pristine: [  # noqa: E731
            restorer(p, q)() for p, q in zip(parts, pristine)]
        l0 = treg.drain_sparse.launches
        got = new()
        l1 = treg.drain_sparse.launches
        plain = par.drain_unrouted_treg(ks_plain, rows, fill, treg.drain_sparse_plain)
        l2 = treg.drain_sparse.launches
        ores, orows = old()
        l3 = treg.drain_sparse.launches
        torch.cuda.synchronize()
        shape = (f"K={k}" + (f" over {MESH_SHARDS} shards on {len(ks.cards)} card(s)"
                             if m is not None else "") + f", B={b}")
        ties = int(got[0].sum())
        if l1 - l0 != on_card(len(ks.cards)) or l2 != l1 or not ties:
            raise AssertionError(f"treg staged call {shape}: launches {l1 - l0}, "
                                 f"plain {l2 - l1}, ties {ties}")
        whole = ks.whole()
        err = _check_equal(torch, f"treg staged call {shape}", got, plain, ores, pos[orows],
                           [whole, ks_plain.whole(), old_whole()])
        wins = changed(torch, st, whole)
        del ks_plain, whole
        times = _turns(torch, old, new, reset_old, reset_new)
        dev_ms = (device_ms(torch, lambda: (reset_old(), old()), "treg_drain_sparse", calls=3),
                  device_ms(torch, lambda: (reset_new(), new()), "treg_drain_sparse", calls=3))
        # the layout's floor: one random 32-byte sector a plane per slot
        # gathered and per winner scattered, beside the streamed batch
        sector_bytes = (b + wins) * 3 * 32 + b * (4 + 20 + 1 + 12)
        rows_out.append(_call_row(
            "treg_drain_sparse", shape, card, xfer, times, (l3 - l2, l1 - l0), dev_ms,
            (b * (4 + 1 + 12 + 20 + 20) + wins * 20, b * OPS_PER_REGISTER), fields, outs, b,
            err, mesh=m is not None, ties=ties, wins=wins,
            sector_bound_ms=bound(sector_bytes, 0, card)[0], sector_bytes=sector_bytes,
            fill_ms=_fill_ms(ks, rows, fill, fields), **_staging_bytes(ks)))
        del ks, old, new, old_parts, pristine
        torch.cuda.empty_cache()
    del st
    torch.cuda.empty_cache()
    return {"treg_drain_sparse": rows_out}


def dense_call_cases(torch, card: str, xfer) -> dict:
    """The dense drains through the repos' staged call on one device
    (parallel.drain_unrouted_* with dense=True: one pinned copy of the
    compact batch to the card, the kernel's two launches (the counters'
    scatter and walk, TREG's clear and slot pass), one copy of the slots'
    outputs back) from a host batch to host results: the counters
    at the node's K = 131,072 x R = 16 with B = K / 4 and K and at
    K = 1,048,576 x R = 64 with B = K / 4, TREG at K = 1,048,576 with
    B = K / 4 and K. Each bit for bit against the same call with the
    plain step on a second keyspace on the card (slot outputs and
    states), then timed on the CUDA-event clock (TREG on a fresh copy of
    its state a call), beside the kernel's bound and the call's bound
    (the kernel's plus the staged bytes at the measured pinned rates).
    The whole-plane path these replace is gone from this tree: its call
    times come from scripts/dense_drain_profile.py --root on the parent
    commit."""
    from jylis_tpu_torch import parallel as par
    from jylis_tpu_torch.ops import gcount, pncount, staging, treg

    rng = np.random.default_rng(SEED + 97)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 97)
    out = {}

    def rounds(b, fields):
        """The slots of each staged call a dense drain of ``b`` slots
        makes: a batch past one Stage is cut, each call one dense
        drain."""
        width = staging.max_slots([(np.int32, ()), *fields])
        return [min(width, b - lo) for lo in range(0, b, width)]

    def case(name, shape, call, ks, ks_plain, rows, fill, fields, outs, kbytes, wrapper,
             plain_step, reset=None):
        """``call(ks, step)``: the staged dense call on ``ks``, the
        wrapper's step when ``step`` is None; ``kbytes`` the kernel's
        bytes over every staged call."""
        calls = len(rounds(len(rows), fields))
        counts = (staging.Stage.uploads, wrapper.launches)
        got = call(ks, None)
        made = (staging.Stage.uploads - counts[0], wrapper.launches - counts[1])
        if made != (calls, calls if DEVICE == "cuda" else 0):
            raise AssertionError(f"{name} dense call: {made} staged copies and launches, "
                                 f"not {calls} each")
        plain = call(ks_plain, plain_step)
        torch.cuda.synchronize()
        t = torch.from_numpy
        err = max_abs_err(torch, [(t(a), t(b)) for a, b in zip(got, plain)]
                          + list(zip(ks.parts[0], ks_plain.parts[0])))
        if err or not (ks.slots is None or bool((ks.slots.map == -1).all().item())):
            raise AssertionError(f"{name} dense call: outputs or states differ ({err})")
        ms = time_ms(torch, lambda: call(ks, None), reset=reset)
        k_ms, k_by = bound(kbytes, 0, card)
        in_b = staging.layout(len(rows), [(np.int32, ()), *fields])[1]
        out_b = staging.layout(len(rows), outs)[1]
        row = dict(shape=shape, new_call_ms=ms, staged_calls=calls,
                   bound_ms=k_ms, bound_by=k_by,
                   bytes=kbytes, staged_bytes=in_b + out_b,
                   call_bound_ms=(k_ms + in_b / xfer["h2d_pinned_bytes_per_s"] * 1e3
                                  + out_b / xfer["d2h_pinned_bytes_per_s"] * 1e3),
                   max_abs_err=err, fill_ms=_fill_ms(ks, rows, fill, fields),
                   **_staging_bytes(ks))
        emit({"phase": f"dense_call {name}", **row, "card": card})
        out.setdefault(name, []).append(row)
        return got

    for npl, mod, unrouted in ((1, gcount, par.drain_unrouted_g),
                               (2, pncount, par.drain_unrouted_pn)):
        name = f"counter_drain_dense<{npl}>"
        for k, r, batches in ((K_NODE, R_NODE, (K_NODE // 4, K_NODE)),
                              (K_COUNTER, R_COUNTER, (K_COUNTER // 4,))):
            st = mod.GCountState(_rand64(torch, (k, r), gen)) if npl == 1 else \
                mod.PNCountState(_rand64(torch, (k, r), gen), _rand64(torch, (k, r), gen))
            for b in batches:
                ks, ks_plain = _keyspaces(par, None, st, 2)
                rows = dense_rows_np(rng, k, b).astype(np.int64)
                fill = par.fill_from(*(u64_np(rng, (b, r)) for _ in range(npl)))
                case(name, f"K={k} R={r} B={b}",
                     lambda ks, step, rows=rows, fill=fill, unrouted=unrouted:
                     (unrouted(ks, rows, fill, step, dense=True),),
                     ks, ks_plain, rows, fill, [(np.uint64, (r,))] * npl, [(np.int64, ())],
                     sum(dense_counter_bytes(npl, k, r, m)[0]
                         for m in rounds(b, [(np.uint64, (r,))] * npl)),
                     mod.drain_dense, mod.drain_dense_plain)
                del ks, ks_plain
            del st
            torch.cuda.empty_cache()
    st_np = treg_planes(rng, K_TREG)
    st = treg.TRegState(*treg_tensors(torch, st_np, DEVICE))
    for b in (K_TREG // 4, K_TREG):
        ks, ks_plain = _keyspaces(par, None, st, 2)
        rows = dense_rows_np(rng, K_TREG, b).astype(np.int64)
        fill = par.fill_from(*treg_deltas(rng, st_np, rows))
        # the wins this batch makes, for the bound: a plain call, undone
        par.drain_unrouted_treg(ks_plain, rows, fill, treg.drain_dense_plain, dense=True)
        wins = changed(torch, st, ks_plain.parts[0])
        restorer(ks_plain.parts[0], st)()
        got = case("treg_drain_dense", f"K={K_TREG} B={b}",
                   lambda ks, step, rows=rows, fill=fill:
                   par.drain_unrouted_treg(ks, rows, fill, step, dense=True),
                   ks, ks_plain, rows, fill, [(np.uint64, ()), (np.uint64, ()), (np.int32, ())],
                   [(np.bool_, ()), (np.int64, ()), (np.int32, ())],
                   treg_dense_bytes(K_TREG, b, wins)[0], treg.drain_dense,
                   treg.drain_dense_plain, reset=restorer(ks.parts[0], st))
        out["treg_drain_dense"][-1].update(wins=wins, ties=int(got[0].sum()))
        del ks, ks_plain
    del st
    torch.cuda.empty_cache()
    return out


def mesh_node_script(rng, writers=None, n_keys=None):
    """The mesh node phase's RESP script and delta stream, made afresh
    from ``rng`` for each node (UJSON deltas are objects): a list of
    ("cmds", [commands]) and ("conv", type, batch) steps. ``writers``, a
    list, gets the flat round's writer documents (A, B, C per key).
    ``n_keys`` counter and TREG keys (default MESH_KEYS)."""
    from jylis_tpu_torch.ops.ujson_host import UJSON

    n_keys = n_keys or MESH_KEYS
    steps = []
    rids = [int(x) for x in rng.integers(1 << 40, 1 << 62, NODE_REPLICAS)]
    keys = [b"m%06d" % i for i in range(n_keys)]
    sample = [keys[int(i)] for i in rng.choice(n_keys, 300, replace=False)]
    # counters, config 2: every key from 8 replicas, two rounds a type
    for name, pols in (("GCOUNT", 1), ("PNCOUNT", 2)):
        steps.append(("cmds", [(name, "INC", k, int(rng.integers(1, 1 << 62)))
                               for k in keys[:200]]))
        for _ in range(2):
            vals = rng.integers(0, 1 << 64, (pols, n_keys, NODE_REPLICAS), dtype=np.uint64)
            batch = []
            for j, key in enumerate(keys):
                ds = [{rid: int(v) for rid, v in zip(rids, vals[p, j]) if v}
                      for p in range(pols)]
                batch.append((key, ds[0] if pols == 1 else tuple(ds)))
            steps += [("conv", name, batch[i:i + 10_000]) for i in range(0, n_keys, 10_000)]
        steps.append(("cmds", [(name, "GET", k) for k in sample + keys[:50]]))
        more = keys[:150] + [b"x%04d" % i for i in range(MESH_MORE - 150)]
        batch = [(k, {rids[0]: int(rng.integers(1, 1 << 63))} if pols == 1 else
                  ({rids[1]: 7}, {rids[2]: int(rng.integers(1, 1 << 63))})) for k in more]
        steps += [("conv", name, batch), ("cmds", [(name, "GET", k) for k in more])]
    # TREG: 100,000 keys; values share an 8-byte prefix at equal ts on a
    # third of the keys, so the host settles prefix ties
    for rnd in range(2):
        batch = []
        for i, key in enumerate(keys):
            ts = int(rng.integers(0, 4)) if i % 3 == 0 else int(rng.integers(0, 1 << 63))
            batch.append((key, (b"prefix00" + b"%d" % rng.integers(0, 1000), ts)))
        steps += [("conv", "TREG", batch[i:i + 10_000]) for i in range(0, n_keys, 10_000)]
    steps.append(("cmds", [("TREG", "SET", k, "v%d" % i, int(rng.integers(0, 5)))
                           for i, k in enumerate(keys[:300])]))
    steps.append(("cmds", [("TREG", "GET", k) for k in sample + keys[:300]]))
    # TLOG: 2,000 keys in rounds of 16 entries, cutoffs raised, then
    # TRIM / TRIMAT / CLR / INS and reads over the socket
    tkeys = [b"t%05d" % i for i in range(MESH_TLOG_KEYS)]
    for rnd in range(MESH_TLOG_ROUNDS):
        batch = [(k, ([(b"e%d" % rng.integers(0, 300), int(rng.integers(0, 1 << 40)))
                       for _ in range(MESH_TLOG_D)],
                      int(rng.integers(0, 1 << 20)) if rng.random() < 0.1 else 0))
                 for k in tkeys]
        steps += [("conv", "TLOG", batch[i:i + 500]) for i in range(0, len(tkeys), 500)]
    cmds = [("TLOG", "TRIM", k, int(rng.integers(0, 20))) for k in tkeys[:40]]
    cmds += [("TLOG", "TRIMAT", k, int(rng.integers(0, 1 << 40))) for k in tkeys[40:50]]
    cmds += [("TLOG", "CLR", k) for k in tkeys[50:55]]
    cmds += [("TLOG", "INS", k, "new", 1 << 41) for k in tkeys[:60]]
    steps.append(("cmds", cmds))
    steps.append(("cmds", [(op, k) for k in tkeys[:100] for op in
                           (("TLOG", "GET"), ("TLOG", "SIZE"), ("TLOG", "CUTOFF"))]))
    # UJSON: a flat round (64 deltas a key) and a tree round (512)
    ws, groups = [], []
    for k in range(MESH_UJ_FLAT):
        w = [UJSON(), UJSON(), UJSON()]
        groups.append(uj_flat_deltas(w, k, 0))
        ws.append(w)
    if writers is not None:
        writers.extend(ws)
    ukeys = [b"u%04d" % k for k in range(MESH_UJ_FLAT)]
    steps.append(("conv", "UJSON", [(k, d) for k, g in zip(ukeys, groups) for d in g]))
    docs = [UJSON() for _ in range(MESH_UJ_TREE)]
    tree = uj_5b_round(docs, 0)
    vkeys = [b"doc%03d" % k for k in range(MESH_UJ_TREE)]
    steps.append(("conv", "UJSON", [(k, d) for k, g in zip(vkeys, tree) for d in g]))
    steps.append(("cmds", [("UJSON", "GET", k) for k in ukeys[:64] + vkeys]))
    return steps


def run_script(node, steps) -> list[bytes]:
    replies = []
    for step in steps:
        if step[0] == "cmds":
            replies += node.client.pipeline(step[1])
        else:
            node.converge(step[1], step[2])
    return replies


# the kernels the mesh node's serving path runs, the kernel only the
# dryrun runs, and the dense drains that must not launch on a mesh
MESH_PATH = ("counter_drain_sparse<1>", "counter_drain_sparse<2>", "treg_drain_sparse",
             "tlog_drain_sparse", "ujson_join", "ujson_fold_flat")
DRYRUN_PATH = ("replica_join",)
SINGLE_ONLY = ("counter_drain_dense<1>", "counter_drain_dense<2>", "treg_drain_dense",
               "tlog_drain_dense")


def launch_counters():
    """The kernel wrappers of the counter, TREG, TLOG, UJSON and mesh
    paths, by kernel name (utils/metrics.py kernel_wrappers, TENSOR's
    two aside)."""
    from jylis_tpu_torch.utils.metrics import kernel_wrappers

    return {n: fn for n, fn in kernel_wrappers().items() if not n.startswith("tensor_")}


def counted(counters, fn):
    """Run ``fn`` with every launch count set to 0 just before it; returns
    (its result, the counts just after it)."""
    reset_counts(*counters.values())
    result = fn()
    return result, {n: c.launches for n, c in counters.items()}


def mesh_node_phase(torch, devs) -> dict:
    """Two nodes on the card fed the same RESP script and delta stream:
    one Database on the 4-shard mesh, one single-device. Every reply and
    every repo's dump_state must be equal; the mesh node's drains must
    all be sparse (no dense kernel launches there: the counter and TREG
    drains staged and unrouted, TLOG's and UJSON's routed) and each
    kernel of the mesh path must launch. Then, counted on its own, dryrun_multichip on
    the mesh's devices, which must launch replica_join."""
    from jylis_tpu_torch import parallel as par
    from jylis_tpu_torch.parallel.dryrun import dryrun_multichip

    mesh = par.make_mesh(MESH_SHARDS, devices=devs)
    counters = launch_counters()
    out = {"devices": devs, "device_count": torch.cuda.device_count() if DEVICE == "cuda" else 0}
    node = Node(0x5EED, mesh=mesh)
    try:
        def serve():
            replies = run_script(node, mesh_node_script(
                np.random.default_rng(SEED + 60), n_keys=MESH_NODE_KEYS))
            return replies, {n: node.repo(n).dump_state()
                             for n in ("GCOUNT", "PNCOUNT", "TREG", "TLOG", "UJSON")}

        t0 = time.perf_counter()
        (mesh_replies, mesh_dumps), launches = counted(counters, serve)
        out["mesh_node_s"] = time.perf_counter() - t0
        out["launches_by_card"] = by_card(counters)
        out["classes"] = {n: dict(c.classes) for n, c in counters.items()
                          if getattr(c, "classes", None)}
        for n in ("GCOUNT", "PNCOUNT", "TREG", "TLOG"):
            if len(node.repo(n)._ks.parts) != MESH_SHARDS:
                raise AssertionError(f"{n} state is not sharded over the mesh")
        res = node.repo("UJSON")._res
        if res is None or len(res._ks.parts) != MESH_SHARDS:
            raise AssertionError("UJSON resident store is not sharded over the mesh")
    finally:
        node.close()
    t0 = time.perf_counter()
    out["dryrun"], dry = counted(counters, lambda: dryrun_multichip(devs))
    out["dryrun_s"] = time.perf_counter() - t0
    if DEVICE == "cuda":
        if min(launches[n] for n in MESH_PATH) < 1:
            raise AssertionError(f"a kernel of the mesh path never launched: {launches}")
        if max(launches[n] for n in SINGLE_ONLY + DRYRUN_PATH):
            raise AssertionError(f"a kernel off the mesh path launched there: {launches}")
        if min(dry[n] for n in DRYRUN_PATH) < 1:
            raise AssertionError(f"replica_join never launched in the dryrun: {dry}")
    single = Node(0x5EED)
    try:
        t0 = time.perf_counter()
        single_replies = run_script(single, mesh_node_script(
            np.random.default_rng(SEED + 60), n_keys=MESH_NODE_KEYS))
        single_dumps = {n: single.repo(n).dump_state() for n in mesh_dumps}
        out["single_node_s"] = time.perf_counter() - t0
    finally:
        single.close()
    check_replies("mesh node vs single-device node", mesh_replies, single_replies)
    for n, dump in mesh_dumps.items():
        if n == "UJSON":
            dump = [(k, uj_canon(d)) for k, d in dump]
            want = [(k, uj_canon(d)) for k, d in single_dumps[n]]
        else:
            want = single_dumps[n]
        if dump != want:
            raise AssertionError(f"{n} dump_state: mesh node != single-device node")
        out[f"{n.lower()}_keys"] = len(dump)
    out.update(replies=len(mesh_replies), launches={n: launches[n] for n in MESH_PATH},
               dryrun_launches={n: c for n, c in dry.items() if c})
    out["serving"] = {"mesh": node.served, "single": single.served}
    emit({"phase": "mesh_node", **out})
    return out


# ---- the digest phase: SYSTEM DIGEST on the card ---------------------------------

# MAP: (key, field) pairs over the four inner types; BCOUNT: keys; the
# UJSON round left pending for the first digest to fold (flat-leg keys x
# 64 deltas: under PENDING_TOTAL_MAX and DEVICE_FANIN_MIN, so no
# converge drains it, and each key over SEG_FANIN_MIN, so the digest's
# drain folds them on the device in one resident fold)
DIGEST_MAP_PAIRS, DIGEST_BCOUNT_KEYS, DIGEST_UJ_PENDING = 10_000, 10_000, 60
DIGEST_FOREIGN = (0x1111, 0x2222, 0x3333)
DIGEST_INCREMENTAL = 100  # GCOUNT keys written before the second digest
MAP_INNER = ("TREG", "TLOG", "GCOUNT", "PNCOUNT")


def more_types_script(rng):
    """The types the mesh node script leaves out, as its steps: MAP over
    DIGEST_MAP_PAIRS (key, field) pairs of the four inner types (SETs,
    foreign field units, DELs of a tenth, GETs and KEYS), BCOUNT over
    DIGEST_BCOUNT_KEYS keys (GRANT, INC, DEC, TRANSFER to and from
    foreign replicas, foreign escrow views, GETs; many spends refused
    OUTOFBOUND), and TENSOR SETs of 64 dims in its three modes."""
    from jylis_tpu_torch.ops.compose import pack_field

    steps, u = [], (1 << 64) - 1
    n_keys = DIGEST_MAP_PAIRS // 4
    pairs = [(b"mk%05d" % k, b"%s.%d" % (t.encode(), k % 3), t)
             for k in range(n_keys) for t in MAP_INNER]
    cmds = []
    for i, (key, field, t) in enumerate(pairs):
        if t in ("TREG", "TLOG"):
            args = [b"v%d" % (i % 7), int(rng.integers(0, 1 << 63)) if i % 5 else u]
        elif t == "GCOUNT":
            args = [int(rng.integers(1, 1 << 62)) if i % 7 else u]
        else:
            args = [b"-%d" % rng.integers(1, 1000) if i % 2 else b"%d" % rng.integers(1, 1000)]
        cmds.append(("MAP", t, "SET", key, field, *args))
    steps.append(("cmds", cmds))
    units = []
    for i in range(0, len(pairs), 3):
        key, field, t = pairs[i]
        rid = DIGEST_FOREIGN[i % 3]
        val = {"TREG": (b"w%d" % (i % 5), int(rng.integers(0, 1 << 63))),
               "TLOG": (((b"e%d" % (i % 4), int(rng.integers(0, 1 << 40))),), 0),
               "GCOUNT": {rid: int(rng.integers(1, 1 << 63))},
               "PNCOUNT": ({rid: 5}, {rid: int(rng.integers(1, 1 << 63))})}[t]
        units.append((pack_field(key, field), (t, {rid: 1 + i % 3}, {}, val)))
    steps += [("conv", "MAP", units[i:i + 2000]) for i in range(0, len(units), 2000)]
    steps.append(("cmds", [("MAP", t, "DEL", key, field) for key, field, t in pairs[::10]]))
    steps.append(("cmds", [("MAP", t, "GET", key, field) for key, field, t in pairs[:2000]]
                  + [("MAP", t, "KEYS", b"mk%05d" % k) for k in range(0, n_keys, 5)
                     for t in MAP_INNER]))
    bkeys = [b"bk%05d" % k for k in range(DIGEST_BCOUNT_KEYS)]
    steps.append(("cmds", [("BCOUNT", "GRANT", k, int(rng.integers(1, 100))) for k in bkeys]))
    steps.append(("cmds", [("BCOUNT", "INC", k, int(rng.integers(1, 150))) for k in bkeys]
                  + [("BCOUNT", "DEC", k, int(rng.integers(1, 60))) for k in bkeys[::2]]))
    views = []
    for i, k in enumerate(bkeys[::3]):
        rid = DIGEST_FOREIGN[i % 3]
        views.append((k, ({rid: 1000}, {rid: 40}, {rid: 10}, {(rid, 0x5EED): 30},
                          {(rid, 0x5EED): 20} if i % 2 else {})))
    steps += [("conv", "BCOUNT", views[i:i + 2000]) for i in range(0, len(views), 2000)]
    steps.append(("cmds", [("BCOUNT", "TRANSFER", k, DIGEST_FOREIGN[i % 3],
                            int(rng.integers(1, 40)), ("INC", "DEC")[i % 2])
                           for i, k in enumerate(bkeys[:2000])]
                  + [("BCOUNT", "GET", k) for k in bkeys[::4]]))
    vals = rng.standard_normal((300, 64)).astype("<f4")
    steps.append(("cmds", [("TENSOR", "SET", b"tk%03d" % (i % 100), ("LWW", "MAX", "AVG")[i % 3],
                            i, vals[i].tobytes()) for i in range(300)]))
    return steps


def digest_node_run(node, rng, counters) -> tuple:
    """Drive one node through the digest phase: the mesh node phase's
    script, MAP and BCOUNT, then a UJSON round left pending; the first
    SYSTEM DIGEST (which must fold it, on the card through the UJSON
    kernels), SYSTEM DIGEST TYPES, the blocking digest, then writes to
    DIGEST_INCREMENTAL GCOUNT keys and a second SYSTEM DIGEST that must
    hash those keys and nothing else. Returns (host seconds and counts,
    the replies, the three digest replies)."""
    out = {}
    ws = []
    steps = mesh_node_script(rng, writers=ws, n_keys=MESH_NODE_KEYS) + more_types_script(rng)
    t0 = time.perf_counter()
    replies = run_script(node, steps)
    out["script_s"] = time.perf_counter() - t0
    pend = [(b"u%04d" % k, d) for k in range(DIGEST_UJ_PENDING) for d in uj_flat_deltas(ws[k], k, 1)]
    node.converge("UJSON", pend)
    uj = node.repo("UJSON")
    held = sum(len(v) for v in uj._pend.values())
    if held != len(pend) or not all(uj._is_resident(k) for k, _ in pend[:1]):
        raise AssertionError(f"the pending UJSON round was drained early: {held} of {len(pend)}")
    before = {n: c.launches for n, c in counters.items()}
    t0 = time.perf_counter()
    digest = node.client.pipeline([("SYSTEM", "DIGEST")])[0]
    out["first_digest_s"] = time.perf_counter() - t0
    out["first_digest_launches"] = {n: c.launches - before[n] for n, c in counters.items()
                                    if c.launches - before[n]}
    if uj._pend:
        raise AssertionError("SYSTEM DIGEST left UJSON deltas pending")
    types = node.client.pipeline([("SYSTEM", "DIGEST", "TYPES")])[0]
    t0 = time.perf_counter()
    blocking = node.db._sync_digest_blocking().hex().encode()
    out["blocking_digest_s"] = time.perf_counter() - t0
    if digest != bulk(blocking):
        raise AssertionError("SYSTEM DIGEST over the socket != the blocking digest")
    replies += node.client.pipeline([("GCOUNT", "INC", b"m%06d" % i, 1)
                                     for i in range(DIGEST_INCREMENTAL)])
    hashed = {}
    for name in node.db.DATA_TYPES:
        repo = node.repo(name)
        orig = repo.sync_canon
        repo.sync_canon = lambda key, orig=orig, name=name: (
            hashed.__setitem__(name, hashed.get(name, 0) + 1) or orig(key))
    t0 = time.perf_counter()
    digest2 = node.client.pipeline([("SYSTEM", "DIGEST")])[0]
    out["incremental_digest_s"] = time.perf_counter() - t0
    for name in node.db.DATA_TYPES:
        del node.repo(name).sync_canon
    if hashed != {"GCOUNT": DIGEST_INCREMENTAL}:
        raise AssertionError(f"the second digest hashed {hashed}, not only the written keys")
    out["hashed_keys"] = {n: len(h) for n, h in node.db._sync_hash.items()}
    return out, replies, (digest, types, digest2)


def digest_phase(torch, devs) -> dict:
    """SYSTEM DIGEST on the card: one script (the mesh node phase's, with
    MAP and BCOUNT, then a pending UJSON round) into a single-device node
    on DEVICE, a node on the 4-shard mesh and a node on the CPU. Every
    reply, SYSTEM DIGEST and each line of SYSTEM DIGEST TYPES must be
    equal across the three; on the card the first digest must launch a
    UJSON kernel (it folds the pending round before it hashes)."""
    from jylis_tpu_torch import parallel as par

    counters = launch_counters()
    out, results = {}, {}
    for label, kw in (("single", {}), ("mesh", {"mesh": par.make_mesh(MESH_SHARDS, devices=devs)}),
                      ("cpu", {"device": "cpu"})):
        node = Node(0x5EED, **kw)
        try:
            t0 = time.perf_counter()
            (info, replies, digests), launches = counted(
                counters, lambda: digest_node_run(node, np.random.default_rng(SEED + 80), counters))
            info["node_s"] = time.perf_counter() - t0
        finally:
            node.close()
        if DEVICE == "cuda" and label != "cpu":
            first = info["first_digest_launches"]
            if not (first.get("ujson_fold_flat") or first.get("ujson_join")):
                raise AssertionError(f"{label}: the first SYSTEM DIGEST launched no UJSON "
                                     f"kernel: {first}")
            info["launches"] = {n: c for n, c in launches.items() if c}
        info["serving"] = node.served
        results[label] = (replies, digests)
        out[label] = info
    want_replies, want = results["cpu"]
    for label in ("single", "mesh"):
        replies, got = results[label]
        check_replies(f"digest phase: {label} node vs cpu node", replies, want_replies)
        for what, g, w in zip(("SYSTEM DIGEST", "SYSTEM DIGEST TYPES", "second SYSTEM DIGEST"),
                              got, want):
            if g != w:
                raise AssertionError(f"{what}: {label} node {g[:200]!r} != cpu node {w[:200]!r}")
    out["replies"] = len(want_replies)
    out["digest"] = want[0].split(b"\r\n")[1].decode()
    out["types"] = [ln.decode() for ln in want[1].split(b"\r\n") if ln[:1] not in (b"*", b"$", b"")]
    out["launches"] = {n: out["single"].get("launches", {}).get(n, 0)
                       + out["mesh"].get("launches", {}).get(n, 0) for n in counters}
    emit({"phase": "digest", **out})
    return out


# ---- the cluster phase ---------------------------------------------------------

# the two nodes' heartbeat (--heartbeat-time): a peer is evicted after 10
# ticks without a frame read from it, and a read loop waits while a
# frame's repo lock is held; at config 2's size a digest fold or a
# whole-repo range dump holds a lock for seconds, so 0.1 s ticks (a 1 s
# window) evicted peers until the bootstrap could not finish
CLUSTER_TICK = 1.0
# digest-tree buckets pulled per range round (--range-budget): all 256,
# so a bootstrap walks each type's keyspace once a direction, not four
# times (every round's range dump walks the responder's whole repo)
CLUSTER_RANGE_BUDGET = 256
CLUSTER_POLL_S = 0.5  # SYSTEM DIGEST polls: each folds dirty keys under the repo locks
CLUSTER_DEADLINE_S = 240.0  # each wait polls to this deadline
CLUSTER_TENSOR_KEYS = 4096  # TENSOR SETs at H: past C's 1,024-row drain threshold
CLUSTER_SAMPLE = 300  # keys per type whose GET replies must be equal


class ClusterNode:
    """A node wired by the entry point's own code (main.build_node:
    System, warmup, Database, Server, Cluster; main.serve starts the
    RESP Server, then the Cluster) in one event loop in a thread, on
    loopback ephemeral ports, and stopped through its Dispose (the final
    flush to peers, then the listeners). ``built`` runs after the build
    (its warmup included) and before anything listens. A cluster port
    taken between its pick and its bind is picked again. Received
    cluster messages are counted by kind, and the keys they carry."""

    def __init__(self, name: str, device, seeds=(), built=None, cport=None, **cfg_kw):
        import errno

        from jylis_tpu_torch.main import build_node, serve
        from jylis_tpu_torch.utils.address import Address
        from jylis_tpu_torch.utils.config import Config
        from jylis_tpu_torch.utils.net import free_port

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        for attempt in range(8):
            # a node restarted on its data dir keeps its address (its
            # replica identity): a fixed cluster port is bound again
            cfg = Config(port="0", addr=Address("127.0.0.1", str(cport or free_port()), name),
                         seed_addrs=[Address(*s) for s in seeds], heartbeat_time=CLUSTER_TICK,
                         range_budget=CLUSTER_RANGE_BUDGET, device=str(device), **cfg_kw)
            t0 = time.perf_counter()
            node = build_node(cfg)
            if built is not None:
                built(node)
            try:
                self.dispose = self.run(serve(node))
                self.boot_s = time.perf_counter() - t0  # build, warmup, recovery, listen
                break
            except OSError as e:
                self.run(self._abort(node))
                if e.errno != errno.EADDRINUSE or attempt == 7:
                    raise
                time.sleep(1.0)
        self.db, self.server, self.cluster = node.database, node.server, node.cluster
        self.addr = (cfg.addr.host, cfg.addr.port, cfg.addr.name)
        self.frames: dict[str, int] = {}
        self.keys_in = 0
        for attr in ("_active_msg", "_passive_msg"):
            orig = getattr(self.cluster, attr)

            async def counted_msg(conn, msg, *a, orig=orig, **kw):
                kind = type(msg).__name__
                self.frames[kind] = self.frames.get(kind, 0) + 1
                self.keys_in += len(getattr(msg, "batch", ()))
                return await orig(conn, msg, *a, **kw)

            setattr(self.cluster, attr, counted_msg)
        self.client = Client(self.server.port)

    def run(self, coro, timeout: float = 600):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def converge(self, name: str, batch) -> None:
        self.run(self.db.converge_async(name, batch))

    @staticmethod
    async def _abort(node) -> None:
        node.cluster.dispose()
        await node.server.dispose()
        if node.journal is not None:
            node.journal.close()

    async def _dispose(self) -> None:
        self.dispose.dispose()
        await self.dispose.done.wait()
        # the flushes the heartbeat started while the shutdown held the
        # repo locks: cancelled, as asyncio.run cancels a node's at exit
        rest = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        for t in rest:
            t.cancel()
        await asyncio.gather(*rest, return_exceptions=True)

    async def _drain(self) -> None:
        """Drain every repo's pending deltas, each under its lock in a
        worker thread on the node's device."""
        def drain(repo):
            with self.db._device_scope():
                repo.drain()

        for mgr in list(self.db.managers()):
            async with mgr.locked("sync"):
                await asyncio.to_thread(drain, mgr.repo)

    async def _established(self) -> int:
        return sum(1 for c in list(self.cluster._actives.values()) if c.established)

    def established(self) -> int:
        return self.run(self._established())

    async def _totals(self) -> dict:
        return self.cluster.metrics_totals()

    def stats(self) -> dict:
        from jylis_tpu_torch.cluster import codec

        totals = self.run(self._totals())
        return {"frames_recv": dict(sorted(self.frames.items())), "keys_recv": self.keys_in,
                # messages this process coded, per kind and path
                "codec": {f"{op}_{path}": dict(sorted(getattr(fn, path).items()))
                          for op, fn in (("encode", codec.encode), ("decode", codec.decode))
                          for path in ("native", "oracle")},
                "serving": {"engine": "native" if self.db.native_engine is not None
                            else "python", **self.db.serving_totals()},
                **{k: totals[k] for k in ("sync_bytes_sent", "sync_bytes_recv",
                                          "sync_trees_sent", "ranges_requested",
                                          "ranges_served", "sync_served", "sync_deferred",
                                          "sync_full_dumps", "held_drops", "evictions",
                                          "dials")}}

    def close(self) -> None:
        self.client.close()
        self.run(self._dispose())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()


def cluster_config2(rng, keys, rids):
    """BASELINE config 2 as anti-entropy batches: every key of each
    counter type from every replica id, values >= 2^63 among them."""
    out = []
    for name, pols in (("GCOUNT", 1), ("PNCOUNT", 2)):
        vals = rng.integers(0, 1 << 64, (pols, len(keys), len(rids)), dtype=np.uint64)
        batch = []
        for j, key in enumerate(keys):
            ds = [{rid: int(v) for rid, v in zip(rids, vals[p, j]) if v} for p in range(pols)]
            batch.append((key, ds[0] if pols == 1 else tuple(ds)))
        out += [(name, batch[i:i + 10_000]) for i in range(0, len(keys), 10_000)]
    return out


def cluster_script():
    """The digest phase's all-type script, made from fixed seeds, and a
    second round of the flat UJSON keys' deltas from the same writers
    (as the digest phase's pending round): each node (each process)
    makes its own copy, so no delta object is shared."""
    ws = []
    steps = (mesh_node_script(np.random.default_rng(SEED + 92), writers=ws)
             + more_types_script(np.random.default_rng(SEED + 93)))
    second = [(b"u%04d" % k, d) for k in range(MESH_UJ_FLAT) for d in uj_flat_deltas(ws[k], k, 1)]
    return steps, second


def cluster_deep_tlog():
    """A fourth TLOG round for every fourth key of the script's, 2 x
    MESH_TLOG_D entries each: those logs outgrow 64 entries, so the rows
    a range sync brings drain sparse (repo_tlog's dense path takes rows
    of 64 entries at most)."""
    rng = np.random.default_rng(SEED + 96)
    return [(b"t%05d" % i, ([(b"d%d" % rng.integers(0, 300), int(rng.integers(0, 1 << 40)))
                             for _ in range(2 * MESH_TLOG_D)], 0))
            for i in range(0, MESH_TLOG_KEYS, 4)]


def cluster_tensor_sets():
    """CLUSTER_TENSOR_KEYS TENSOR SETs of 64 dims in the three modes."""
    vals = np.random.default_rng(SEED + 94).standard_normal(
        (CLUSTER_TENSOR_KEYS, 64)).astype("<f4")
    return [("TENSOR", "SET", b"ct%05d" % i, ("LWW", "MAX", "AVG")[i % 3], i + 1,
             vals[i].tobytes()) for i in range(CLUSTER_TENSOR_KEYS)]


def cluster_h_only(name: str, batch) -> bool:
    """Whether a foreign batch of the cluster script reaches H alone (C
    then gets it only through the range sync): every TREG and TLOG
    batch and the UJSON tree round. The counter, MAP and BCOUNT batches
    and the UJSON flat round reach both nodes, as a full mesh delivers
    them."""
    return name in ("TREG", "TLOG") or (name == "UJSON" and batch[0][0].startswith(b"doc"))


def config2_batches():
    """A node's copy of BASELINE config 2 as its cluster_peer converges
    it: NODE_KEYS keys from NODE_REPLICAS replica ids, from SEED + 90."""
    rng = np.random.default_rng(SEED + 90)
    keys = [b"k%06d" % i for i in range(NODE_KEYS)]
    rids = [int(x) for x in rng.integers(1 << 40, 1 << 62, NODE_REPLICAS)]
    return cluster_config2(rng, keys, rids)


def config2_writes():
    """The RESP writes a node takes after config 2: 100 of its keys."""
    keys = [b"k%06d" % i for i in range(100)]
    return [("GCOUNT", "INC", k, 7) for k in keys] + [("PNCOUNT", "DEC", k, 3) for k in keys]


# the sizes a node's process takes from the parent's module, so both
# nodes make the same data at whatever sizes the parent runs
PEER_SIZES = ("NODE_KEYS", "NODE_REPLICAS", "MESH_KEYS", "MESH_MORE", "MESH_TLOG_KEYS",
              "MESH_TLOG_ROUNDS", "MESH_TLOG_D", "MESH_UJ_FLAT", "MESH_UJ_TREE",
              "DIGEST_MAP_PAIRS", "DIGEST_BCOUNT_KEYS", "CLUSTER_TICK", "CLUSTER_RANGE_BUDGET",
              "CLUSTER_TENSOR_KEYS")


def instrument_recovery(counters, sync) -> dict:
    """Time the persistence seams of this process's node and read its
    kernels' launch counts around them, by wrapping the functions the
    entry point calls (main.recover calls persist.load_snapshot and
    journal.recover_all; Dispose calls persist.save_snapshot): each
    snapshot restore's seconds and the share of them in
    Database.drain_all (the rest is the file's read, decode and the
    converge into the repos' buffers), its launches and bytes; the
    journal replay's seconds, drain_all seconds, launches and batches;
    the shutdown snapshot's seconds and bytes. ``sync`` waits for the
    card before a clock is read."""
    from jylis_tpu_torch import journal, persist
    from jylis_tpu_torch.models.database import Database

    rec = {"restore": [], "replay": None, "save": []}
    inside = []

    def counts():
        return {n: c.launches for n, c in counters.items()}

    def measured(fn, *args):
        before, cards0, t0 = counts(), by_card(counters), time.perf_counter()
        inside.append({"drain_all_s": 0.0})
        try:
            n = fn(*args)
            sync()
        finally:
            drain = inside.pop()["drain_all_s"]
        secs, after = time.perf_counter() - t0, counts()
        return n, {"s": secs, "drain_all_s": drain, "decode_converge_s": secs - drain,
                   "launches": {k: after[k] - before[k] for k in after if after[k] - before[k]},
                   "by_card": card_diff(by_card(counters), cards0)}

    load, recover_all = persist.load_snapshot, journal.recover_all
    drain_all, save = Database.drain_all, persist.save_snapshot

    def load_snapshot(db, path):
        n, r = measured(load, db, path)
        rec["restore"].append(dict(r, file=os.path.basename(path), bytes=os.path.getsize(path),
                                   type_batches=n))
        return n

    def replay_all(db, data_dir, own_path, log=None):
        n, r = measured(recover_all, db, data_dir, own_path, log)
        rec["replay"] = dict(r, replayed_batches=n)
        return n

    def timed_drain_all(self):
        t0 = time.perf_counter()
        try:
            return drain_all(self)
        finally:
            if inside:
                sync()
                inside[-1]["drain_all_s"] += time.perf_counter() - t0

    def save_snapshot(db, path):
        t0 = time.perf_counter()
        save(db, path)
        rec["save"].append({"s": time.perf_counter() - t0, "bytes": os.path.getsize(path)})

    persist.load_snapshot, journal.recover_all = load_snapshot, replay_all
    Database.drain_all, persist.save_snapshot = timed_drain_all, save_snapshot
    return rec


def cluster_peer(spec: dict) -> None:
    """One node of the cluster phase in a process of its own, as a
    deployment runs it (its own interpreter lock and collector: the
    parent's earlier phases hold millions of objects whose full
    collections would stall this node's heartbeat). A ClusterNode named
    spec["name"] on spec["device"], seeded with spec["seeds"], its
    launch counts set to 0 after its build and warmup, before it
    listens. It answers one JSON line on stdout per line on stdin:
    "config2" (converge BASELINE config 2, then write to 100 keys over
    RESP), "both" (converge its copy of the script's foreign batches that
    reach both nodes), "h-only" (those that reach H alone, the flat UJSON
    keys' second round and the deep TLOG round), "mark" (drain every
    repo, then report the launches since the start or the last mark and
    set the counts to 0), "stats" (received frames, sync counters),
    "established", "exit". For the persistence phase: spec["data_dir"]
    and spec["cport"] make a node that recovers from its data dir at
    boot and keeps its address; "all" (converge the whole script's
    foreign batches, its second rounds and CLUSTER_TENSOR_KEYS TENSOR
    SETs, and take all its bursts over RESP), "close" (a clean shutdown:
    the shutdown snapshot, the journal retired; then the persistence
    seams' record, and the process exits).
    Its first line is its address and ports, and the record of its boot
    recovery (instrument_recovery) when it has a data dir."""
    import torch

    from jylis_tpu_torch.ops import tensor

    globals().update({k: spec[k] for k in PEER_SIZES})
    counters = dict(launch_counters(), tensor_converge_batch=tensor.converge_batch)
    del counters["replica_join"]

    def zero(node=None):
        reset_counts(*counters.values())
        if node is not None and spec.get("preload_config2"):
            # config 2 in the node before it listens or dials (the lanes
            # phase's E): the first sync with a peer pulls all of it
            for name, batch in config2_batches():
                node.database.converge(name, batch)

    persist_kw, rec = {}, None
    if spec.get("data_dir"):
        rec = instrument_recovery(counters, (lambda: sync_cards(torch))
                                  if spec["device"] != "cpu" else (lambda: None))
        persist_kw = {"data_dir": spec["data_dir"], "cport": spec["cport"]}
    node = ClusterNode(spec["name"], spec["device"], seeds=spec["seeds"], built=zero,
                       **persist_kw)

    def say(obj) -> None:
        print(json.dumps(obj), flush=True)

    mesh = node.db.mesh
    say({"addr": node.addr, "resp_port": node.server.port, "boot_s": node.boot_s,
         "device": str(node.db.device), "mesh": None if mesh is None else str(mesh),
         "mesh_cards": [] if mesh is None else sorted({str(d) for d in mesh.keys_devices}),
         **({"recovery": rec} if rec is not None else {})})
    closed = False
    try:
        for line in sys.stdin:
            cmd, t0 = line.strip(), time.perf_counter()
            if cmd == "config2":
                for name, batch in config2_batches():
                    node.converge(name, batch)
                node.client.pipeline(config2_writes())
                say({"done": cmd, "s": time.perf_counter() - t0})
            elif cmd == "all":
                steps, second = cluster_script()
                for step in steps:
                    if step[0] == "conv":
                        node.converge(step[1], step[2])
                    else:
                        node.client.pipeline(step[1])
                for name, batch in (("UJSON", second), ("TLOG", cluster_deep_tlog())):
                    node.converge(name, batch)
                node.client.pipeline(cluster_tensor_sets())
                say({"done": cmd, "s": time.perf_counter() - t0})
            elif cmd == "close":
                node.close()
                closed = True
                say({"done": cmd, "s": time.perf_counter() - t0, "recovery": rec})
                return
            elif cmd in ("both", "h-only"):
                steps, second = cluster_script()
                n = 0
                for step in steps:
                    if step[0] == "conv" and cluster_h_only(step[1], step[2]) == (cmd == "h-only"):
                        node.converge(step[1], step[2])
                        n += len(step[2])
                if cmd == "h-only":
                    for name, batch in (("UJSON", second), ("TLOG", cluster_deep_tlog())):
                        node.converge(name, batch)
                        n += len(batch)
                say({"done": cmd, "s": time.perf_counter() - t0, "deltas": n})
            elif cmd == "mark":
                node.run(node._drain())
                say({"launches": {n: c.launches for n, c in counters.items() if c.launches},
                     "by_card": by_card(counters)})
                zero()
            elif cmd == "stats":
                say(node.stats())
            elif cmd == "established":
                say({"established": node.established()})
            else:
                break
    finally:
        if not closed:
            node.close()


class PeerProcess:
    """One cluster-phase node as a child process running cluster_peer(),
    and a RESP client to it."""

    def __init__(self, name: str, device: str, seeds=(), data_dir=None, cport=None,
                 preload_config2=False):
        from pathlib import Path

        here = str(Path(__file__).resolve().parent)
        spec = dict({k: globals()[k] for k in PEER_SIZES}, name=name, device=device,
                    seeds=[list(s) for s in seeds], data_dir=data_dir, cport=cport,
                    preload_config2=preload_config2)
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             "import json, sys, chip_smoke; chip_smoke.cluster_peer(json.loads(sys.argv[1]))",
             json.dumps(spec)],
            cwd=here, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        )
        try:
            hello = self._read()
            self.addr = tuple(hello["addr"])
            self.client = Client(hello["resp_port"])
            self.hello = dict(hello, process_to_listening_s=time.perf_counter() - t0)
        except BaseException:
            self.proc.kill()
            self.proc.wait(timeout=30)
            raise

    def _read(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise AssertionError(f"cluster phase: a node's process exited ({self.proc.poll()})")
        return json.loads(line)

    def start(self, cmd: str) -> None:
        """Send a command whose answer finish() reads."""
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()

    def finish(self) -> dict:
        return self._read()

    def ask(self, cmd: str) -> dict:
        self.start(cmd)
        return self.finish()

    def established(self) -> int:
        return self.ask("established")["established"]

    def close_clean(self) -> dict:
        """A clean shutdown through the node's Dispose (the persistence
        phase's "close"); its answer."""
        self.client.close()
        out = self.ask("close")
        self.proc.wait(timeout=120)
        return out

    def kill(self) -> None:
        """SIGKILL: no shutdown snapshot, no final flush."""
        self.client.close()
        self.proc.kill()
        self.proc.wait(timeout=60)

    def close(self) -> None:
        if self.proc.poll() is not None:
            return
        try:
            self.client.close()
            self.proc.stdin.write("exit\n")
            self.proc.stdin.close()
            self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=30)


def digests_of(node) -> tuple[bytes, bytes]:
    d, t = node.client.pipeline([("SYSTEM", "DIGEST"), ("SYSTEM", "DIGEST", "TYPES")])
    return d, t


def wait_until(what: str, check) -> float:
    """Poll ``check`` every CLUSTER_POLL_S to CLUSTER_DEADLINE_S; the
    seconds it took."""
    t0 = time.perf_counter()
    while not check():
        if time.perf_counter() - t0 > CLUSTER_DEADLINE_S:
            raise AssertionError(f"cluster phase: timed out waiting for {what}")
        time.sleep(CLUSTER_POLL_S)
    return time.perf_counter() - t0


def wait_converged(what: str, a, b) -> tuple[float, list]:
    """Poll until SYSTEM DIGEST and SYSTEM DIGEST TYPES are equal on both
    nodes: the seconds it took, and each time the set of types that
    differ changed, its seconds and the types (the deadline's error
    names them, and both nodes' sync counters)."""
    seen, t0 = [], time.perf_counter()

    def equal():
        da, db = digests_of(a), digests_of(b)
        la, lb = (set(d[1].split(b"\r\n")) for d in (da, db))
        differ = sorted({ln.split(b" ")[0].decode() for ln in la ^ lb if b" " in ln})
        if not seen or seen[-1][1] != differ:
            seen.append((round(time.perf_counter() - t0, 2), differ))
        return da == db

    try:
        return wait_until(what, equal), seen
    except AssertionError:
        raise AssertionError(f"cluster phase: {what}: types differing over time {seen}; "
                             f"stats {a.ask('stats')} / {b.ask('stats')}")


def cluster_reads(rng, keys):
    """GETs of every type over keys the phase wrote."""
    def pick(ks, n=CLUSTER_SAMPLE):
        return [ks[int(i)] for i in rng.choice(len(ks), min(n, len(ks)), replace=False)]

    mkeys = [b"m%06d" % i for i in range(MESH_KEYS)] + [b"x%04d" % i for i in range(250)]
    cmds = [(t, "GET", k) for t in ("GCOUNT", "PNCOUNT") for k in pick(keys) + pick(mkeys)]
    cmds += [("TREG", "GET", k) for k in pick(mkeys)]
    cmds += [(op, k) for k in pick([b"t%05d" % i for i in range(MESH_TLOG_KEYS)], 100)
             for op in (("TLOG", "GET"), ("TLOG", "CUTOFF"))]
    cmds += [("UJSON", "GET", k) for k in [b"u%04d" % k for k in range(MESH_UJ_FLAT)]
             + [b"doc%03d" % k for k in range(MESH_UJ_TREE)]]
    cmds += [("TENSOR", "GET", k) for k in pick([b"ct%05d" % i for i in range(CLUSTER_TENSOR_KEYS)])
             + [b"tk%03d" % i for i in range(100)]]
    cmds += [("MAP", t, "KEYS", b"mk%05d" % k) for k in range(0, DIGEST_MAP_PAIRS // 4, 25)
             for t in MAP_INNER]
    cmds += [("BCOUNT", "GET", k) for k in pick([b"bk%05d" % k for k in range(DIGEST_BCOUNT_KEYS)])]
    return cmds


# the message kinds that carry a PushDeltas body (cluster/codec.py)
PUSH_KINDS = ("PushDeltas", "SeqPush", "RelayPush")
# config 2's PNCOUNT state goes through the codec phase in frames of this
# many keys (the cluster's sync chunk, scripts/cluster_heal.py --costs)
CODEC_FRAME_KEYS = 2048


def codec_phase() -> dict:
    """The wire codec on the card machine's host at config 2's PNCOUNT
    size: NODE_KEYS keys x NODE_REPLICAS replica ids (the cluster
    phase's data, cluster_config2) as CODEC_FRAME_KEYS-key PushDeltas
    frames, encoded and decoded on the native path and on the oracle
    (``native=False``), each timed. The bytes must be equal, both
    decodes must give the batches encoded, and the native path must
    have coded every frame."""
    from jylis_tpu_torch.cluster import codec
    from jylis_tpu_torch.cluster.msg import MsgPushDeltas

    rng = np.random.default_rng(SEED + 90)
    keys = [b"k%06d" % i for i in range(NODE_KEYS)]
    rids = [int(x) for x in rng.integers(1 << 40, 1 << 62, NODE_REPLICAS)]
    state = [kd for name, batch in cluster_config2(rng, keys, rids) if name == "PNCOUNT"
             for kd in batch]
    msgs = [MsgPushDeltas("PNCOUNT", tuple(state[i:i + CODEC_FRAME_KEYS]))
            for i in range(0, len(state), CODEC_FRAME_KEYS)]
    out = {"type": "PNCOUNT", "keys": len(state), "replica_ids": NODE_REPLICAS,
           "frames": len(msgs)}
    coded = {}
    for path, native in (("native", True), ("oracle", False)):
        enc0, dec0 = codec.encode.native.get("PushDeltas", 0), codec.decode.native.get(
            "PushDeltas", 0)
        t0 = time.perf_counter()
        frames = [codec.encode(m, native=native) for m in msgs]
        out[f"{path}_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = [codec.decode(f, native=native) for f in frames]
        out[f"{path}_decode_s"] = time.perf_counter() - t0
        natively = (codec.encode.native.get("PushDeltas", 0) - enc0,
                    codec.decode.native.get("PushDeltas", 0) - dec0)
        if natively != ((len(msgs), len(msgs)) if native else (0, 0)):
            raise AssertionError(f"codec phase: {path} path coded {natively} frames natively")
        coded[path] = (frames, back)
    if coded["native"][0] != coded["oracle"][0]:
        raise AssertionError("codec phase: native and oracle bytes differ")
    for m, a, b in zip(msgs, coded["native"][1], coded["oracle"][1]):
        if not (a == m and b == m):
            raise AssertionError("codec phase: a decoded batch differs from the one encoded")
    out["bytes"] = sum(map(len, coded["native"][0]))
    out["bytes_equal"] = True
    emit({"phase": "codec", **out})
    return out


# the kernels a card node must launch on deltas that reached it over the
# wire (any one of a group): the bootstrap's and the second stage's
CLUSTER_PATH = (("counter_drain_dense<1>", "counter_drain_dense<2>"),
                ("counter_drain_sparse<1>", "counter_drain_sparse<2>"),
                ("treg_drain_sparse",), ("tlog_drain_sparse",),
                ("ujson_fold_flat", "ujson_join"), ("tensor_converge_batch",))


def cluster_phase(torch, c_device=None) -> dict:
    """Two port nodes in one cluster on loopback, heartbeat 1 s, each
    in a process of its own: C holds its state on the card, H on the
    CPU (the plain versions: the reference).

    1. H is loaded with BASELINE config 2 through converge_async; C
       starts empty, seeded with H's address, and the digest-checked
       bootstrap sync (digest trees, then range pulls) brings the state
       over the wire.
    2. C's stage of the digest phase's all-type script: both nodes
       converge the foreign batches that reach both (counters, MAP,
       BCOUNT, the flat UJSON round), and the script's even RESP bursts
       go to C; its broadcasts carry them to H. C then drains.
    3. H's stage, in which C takes no input but the wire: H converges
       the foreign batches that reach it alone (TREG, TLOG, the UJSON
       tree round, the flat keys' second round and a deep TLOG round),
       which C can get only through the range sync, takes the odd RESP
       bursts, and SETs
       CLUSTER_TENSOR_KEYS TENSOR keys, which its broadcasts carry.

    The two must end with equal SYSTEM DIGEST and SYSTEM DIGEST TYPES,
    and equal GET replies for keys of every type. C's launch counts are
    set to 0 after its warmup, read after the bootstrap and after each
    stage: the bootstrap's and stage 3's are the launches the wire fed,
    and every kernel group of CLUSTER_PATH must be among them (on a
    mesh, the sparse counter drains only: a mesh never drains dense)."""
    c_device = c_device or DEVICE
    cards = n_cards(torch) if str(c_device) == "cuda" else 0
    keys = [b"k%06d" % i for i in range(NODE_KEYS)]
    out = {"tick_s": CLUSTER_TICK, "range_budget": CLUSTER_RANGE_BUDGET,
           "c_device": str(c_device)}
    h = PeerProcess("h", "cpu")
    c = None
    try:
        out["load_h_s"] = h.ask("config2")["s"]
        apps0 = card_apps() if cards > 1 else None
        t_phase = time.perf_counter()
        c = PeerProcess("c", str(c_device), seeds=[h.addr])
        t0 = time.perf_counter()
        out["c_process_start_s"] = t0 - t_phase
        out["c_mesh"], out["c_cards"] = c.hello["mesh"], c.hello["mesh_cards"]
        if cards > 1:
            # a bare --device cuda on several cards: C's every repo is
            # keys-sharded over all of them, each card holding a context
            if len(out["c_cards"]) != cards:
                raise AssertionError(f"cluster phase: C's mesh {out['c_mesh']} is not on "
                                     f"the {cards} cards")
            out["card_apps"] = check_card_apps("cluster phase, C up", apps0)
        out["boot_to_mesh_s"] = wait_until(
            "the mesh", lambda: c.established() == 1 and h.established() == 1)
        s, out["bootstrap_differ"] = wait_converged("bootstrap sync", c, h)
        out["bootstrap_s"] = s + out["boot_to_mesh_s"]
        sample = cluster_reads(np.random.default_rng(SEED + 91), keys)[:2 * CLUSTER_SAMPLE]
        check_replies("config 2 GETs: card node vs cpu node",
                      c.client.pipeline(sample), h.client.pipeline(sample))
        mark = c.ask("mark")
        boot, boot_cards = mark["launches"], mark["by_card"]
        emit({"phase": "cluster_step", "step": "bootstrap", **out, "launches": boot})
        steps = cluster_script()[0]
        bursts = [step[1] for step in steps if step[0] == "cmds"]
        out["bursts"] = [len(bursts[0::2]), len(bursts[1::2]) + 1]
        t0 = time.perf_counter()
        for node in (c, h):
            node.start("both")
        for cmds in bursts[0::2]:
            c.client.pipeline(cmds)
        c_both, h_both = c.finish(), h.finish()
        mark = c.ask("mark")
        local, local_cards = mark["launches"], mark["by_card"]
        out["c_stage_s"] = time.perf_counter() - t0
        out["both_deltas"], out["c_both_s"], out["h_both_s"] = (
            c_both["deltas"], c_both["s"], h_both["s"])
        emit({"phase": "cluster_step", "step": "c_stage", "s": out["c_stage_s"],
              "launches": local})
        t0 = time.perf_counter()
        h.start("h-only")
        for cmds in bursts[1::2]:
            h.client.pipeline(cmds)
        h.client.pipeline(cluster_tensor_sets())
        h_only = h.finish()
        out["h_stage_s"] = time.perf_counter() - t0
        out["h_only_deltas"], out["h_only_s"] = h_only["deltas"], h_only["s"]
        emit({"phase": "cluster_step", "step": "h_stage", "s": out["h_stage_s"]})
        out["last_write_to_equal_s"], out["script_differ"] = wait_converged(
            "the all-type script", c, h)
        mark = c.ask("mark")
        wire, wire_cards = mark["launches"], mark["by_card"]
        out["c"], out["h"] = c.ask("stats"), h.ask("stats")
        # C coded its push frames (plain, seq- and relay-prefixed) on the
        # native codec path, and settled RESP bursts in its engine
        cc = out["c"]["codec"]
        out["c_push_frames"] = {
            f"{op}_{path}": sum(cc[f"{op}_{path}"].get(k, 0) for k in PUSH_KINDS)
            for op in ("encode", "decode") for path in ("native", "oracle")}
        if not (out["c_push_frames"]["encode_native"] and out["c_push_frames"]["decode_native"]):
            raise AssertionError(f"cluster phase: C coded no push frame natively: {cc}")
        if out["c"]["serving"]["native_cmds"] < 1:
            raise AssertionError(f"cluster phase: C served nothing natively: {out['c']['serving']}")
        reads = cluster_reads(np.random.default_rng(SEED + 95), keys)
        check_replies("all-type GETs: card node vs cpu node",
                      c.client.pipeline(reads), h.client.pipeline(reads))
        out["gets_checked"] = len(reads) + len(sample)
        digest, types = digests_of(c)
        out["phase_s"] = time.perf_counter() - t_phase
        out["digest"] = digest.split(b"\r\n")[1].decode()
        lines = [ln for ln in types.split(b"\r\n") if ln and ln[:1] not in b"*$"]
        if any(ln.endswith(b"0" * 64) for ln in lines):
            raise AssertionError(f"cluster phase: a type holds no data: {lines}")
    finally:
        for node in (c, h):
            if node is not None:
                node.close()
    names = sorted(set(boot) | set(local) | set(wire))
    out["launches"] = {n: boot.get(n, 0) + local.get(n, 0) + wire.get(n, 0) for n in names}
    out["wire_launches"] = {n: boot.get(n, 0) + wire.get(n, 0) for n in names
                            if boot.get(n, 0) + wire.get(n, 0)}
    out["launches_by_stage"] = {"bootstrap": boot, "c_stage": local, "h_stage": wire}
    out["launches_by_card"] = card_sum(boot_cards, local_cards, wire_cards)
    emit({"phase": "cluster", **out})
    if c_device != "cpu":
        # on a mesh the drains are sparse only, as in the JAX package
        path = CLUSTER_PATH if cards < 2 else [g for g in CLUSTER_PATH
                                               if not all("dense" in n for n in g)]
        missing = [g for g in path if not any(out["wire_launches"].get(n) for n in g)]
        if missing:
            raise AssertionError(f"cluster phase: the card node launched no kernel of {missing} "
                                 f"on deltas from the wire: {out['launches_by_stage']}")
    if cards > 1:
        off = off_cards(out["launches_by_card"], CARDS_PATH, cards)
        if off:
            raise AssertionError(f"cluster phase: kernels that never launched on a card of C's "
                                 f"mesh: {off}; by card {out['launches_by_card']}")
    elif str(c_device) == "cuda":
        not_run(torch, "cluster_cards")
    return out


# ---- the persistence phase ----------------------------------------------------

# the drain kernels a restore on the card must launch (any one of a
# group): counters, TREG, TLOG, UJSON, TENSOR
PERSIST_PATH = (("counter_drain_dense<1>", "counter_drain_dense<2>", "counter_drain_sparse<1>",
                 "counter_drain_sparse<2>"), ("treg_drain_dense", "treg_drain_sparse"),
                ("tlog_drain_dense", "tlog_drain_sparse"), ("ujson_join", "ujson_fold_flat"),
                ("tensor_converge_batch",))
PERSIST_STAGE2 = 2000  # keys a type that the second stage writes over RESP
PERSIST_QUIET_POLLS = 3  # JOURNAL appends unchanged over this many heartbeats


def persist_stage2():
    """The second stage's writes, over keys the first stage holds: GCOUNT
    INC and PNCOUNT DEC on config 2's keys, TREG SETs at ts >= 2^63, TLOG
    INSs, UJSON SETs on the flat keys and INSs on the tree documents
    (resident after a restore: the writes demote them), TENSOR SETs in
    each key's mode, MAP fields and BCOUNT grants."""
    rng = np.random.default_rng(SEED + 97)
    n = PERSIST_STAGE2
    step = max(1, NODE_KEYS // n)
    cmds = [("GCOUNT", "INC", b"k%06d" % i, int(rng.integers(1, 1 << 62)))
            for i in range(0, NODE_KEYS, step)][:n]
    cmds += [("PNCOUNT", "DEC", b"k%06d" % i, int(rng.integers(1, 1000)))
             for i in range(0, NODE_KEYS, step)][:n]
    cmds += [("TREG", "SET", b"m%06d" % i, b"stage2-%d" % i, (1 << 63) + i)
             for i in range(min(n, MESH_KEYS))]
    cmds += [("TLOG", "INS", b"t%05d" % i, b"stage2", (1 << 42) + i)
             for i in range(min(n, MESH_TLOG_KEYS))]
    cmds += [("UJSON", "SET", b"u%04d" % k, "stage2", str(k)) for k in range(MESH_UJ_FLAT)]
    cmds += [("UJSON", "INS", b"doc%03d" % k, "stage2", k) for k in range(MESH_UJ_TREE)]
    vals = rng.standard_normal((min(n, CLUSTER_TENSOR_KEYS), 64)).astype("<f4")
    cmds += [("TENSOR", "SET", b"ct%05d" % i, ("LWW", "MAX", "AVG")[i % 3], (1 << 40) + i,
              vals[i].tobytes()) for i in range(len(vals))]
    cmds += [("MAP", "GCOUNT", "SET", b"mk%05d" % k, b"stage2", k + 1)
             for k in range(min(n, DIGEST_MAP_PAIRS // 4))]
    cmds += [("BCOUNT", "GRANT", b"bk%05d" % k, 5) for k in range(min(n, DIGEST_BCOUNT_KEYS))]
    return cmds


def journal_appends(node) -> int:
    reply = node.client.pipeline([("SYSTEM", "METRICS")])[0]
    m = re.search(rb"JOURNAL appends (\d+)", reply)
    if m is None:
        raise AssertionError("persistence phase: SYSTEM METRICS has no JOURNAL section")
    return int(m.group(1))


def persist_layouts(data: str, copy: str, boot, on_cards, want, cards: int,
                    one: str = "cuda:1", every: str = "cuda") -> dict:
    """A snapshot across device layouts: P3's shutdown snapshot, written
    keys-sharded over every card, restored by P4 on ``one``
    (``--device cuda:1``) alone; P4's shutdown snapshot, written on that
    one card, restored by P5 on ``every`` (``--device cuda``: every
    card). Both must give ``want``, the CPU node's digests. P4 launches
    on its card alone; P5's restore drains both counter types on every
    card."""
    shutil.copytree(data, copy)
    out = {}
    p4 = boot(one, copy)
    if p4.hello["mesh"] is not None or p4.hello["device"] != one:
        raise AssertionError(f"persistence phase: P4 on {p4.hello['device']}, mesh "
                             f"{p4.hello['mesh']}")
    if digests_of(p4) != want:
        raise AssertionError(f"persistence phase: P4 ({one}) on the several-card snapshot "
                             "!= the CPU node's digests")
    rec4 = p4.hello["recovery"]["restore"][0]
    strays = {n: c for n, c in rec4["by_card"].items()
              if set(c) != {one.partition(":")[2] or "0"}}
    if strays:
        raise AssertionError(f"persistence phase: P4 ({one}) launched on other cards: {strays}")
    closed = p4.close_clean()
    out["p4"] = {"process_to_listening_s": p4.hello["process_to_listening_s"],
                 "restore_s": rec4["s"], "drain_all_s": rec4["drain_all_s"],
                 "launches_by_card": rec4["by_card"], "close_s": closed["s"],
                 "snapshot_bytes": closed["recovery"]["save"][-1]["bytes"]}
    emit({"phase": "persist_step", "step": "p4_one_card", **out["p4"]})
    p5 = boot(every, copy)
    on_cards(p5, "P5")
    if digests_of(p5) != want:
        raise AssertionError("persistence phase: P5 (every card) on the one-card snapshot "
                             "!= the CPU node's digests")
    rec5 = p5.hello["recovery"]["restore"][0]
    off = off_cards(rec5["by_card"], CARDS_PATH[:2], cards)
    if off:
        raise AssertionError(f"persistence phase: P5's restore drained no counter on {off}: "
                             f"{rec5['by_card']}")
    out["p5"] = {"process_to_listening_s": p5.hello["process_to_listening_s"],
                 "restore_s": rec5["s"], "drain_all_s": rec5["drain_all_s"],
                 "launches_by_card": rec5["by_card"], "mesh": p5.hello["mesh"]}
    p5.close()
    emit({"phase": "persist_step", "step": "p5_every_card", **out["p5"]})
    return out


def persist_phase(torch, p_device=None) -> dict:
    """Persistence on the card: nodes in processes of their own, wired by
    main.build_node with --data-dir set to a fresh directory and one
    address (so one replica identity), heartbeat 1 s, the journal on.

    1. P1 (card) boots on the empty directory and takes the cluster
       phase's data: config 2 (cluster_config2) and the whole all-type
       script (cluster_script, its second rounds, the TENSOR SETs). Its
       SYSTEM DIGEST and SYSTEM DIGEST TYPES are recorded; a clean
       Dispose writes the shutdown snapshot and retires the journal.
    2. P2 (card) boots on the directory: its digests must equal P1's.
       Recorded: the snapshot's bytes, its write seconds, P2's boot to
       listening, the restore's seconds split into decode + converge and
       drain_all, and each kernel's launches in the restore, which must
       cover every group of PERSIST_PATH.
    3. P2 takes the second stage (persist_stage2) over RESP; once its
       JOURNAL appends counter has stopped moving for
       PERSIST_QUIET_POLLS heartbeats, P2 is killed with SIGKILL. P3
       (card) boots on the directory: P1's snapshot and P2's journal.
       Its digests must equal P2's before the kill.
    4. R, a CPU port node (--device cpu) on a copy of P1's snapshot
       alone, must give P1's digests; fed the second stage, it must give
       P2's replies and P3's digests.
    Recorded besides: the journal's replayed batches, the replay's
    seconds, drain_all seconds and launches."""
    import tempfile

    from jylis_tpu_torch.utils.net import free_port

    p_device = str(p_device or DEVICE)
    cards = n_cards(torch) if p_device == "cuda" else 0
    root = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    data, ref = os.path.join(root, "data"), os.path.join(root, "ref")
    os.makedirs(ref)
    cport = free_port()
    out = {"device": p_device, "tick_s": CLUSTER_TICK}
    nodes = []

    def boot(device, data_dir):
        node = PeerProcess("p", device, data_dir=data_dir, cport=cport)
        nodes.append(node)
        return node

    def on_cards(node, what):
        """A node on ``p_device`` with several cards takes all of them."""
        if cards > 1 and len(node.hello["mesh_cards"]) != cards:
            raise AssertionError(f"persistence phase: {what}'s mesh {node.hello['mesh']} is "
                                 f"not on the {cards} cards")

    try:
        apps0 = card_apps() if cards > 1 else None
        t_phase = time.perf_counter()
        p1 = boot(p_device, data)
        on_cards(p1, "P1")
        out["p1_mesh"] = p1.hello["mesh"]
        if cards > 1:
            out["card_apps"] = check_card_apps("persistence phase, P1 up", apps0)
        out["p1_load_s"] = p1.ask("config2")["s"] + p1.ask("all")["s"]
        want1 = digests_of(p1)
        closed = p1.close_clean()
        out["p1_close_s"] = closed["s"]
        snap = os.path.join(data, "snapshot.jylis")
        shutil.copy(snap, os.path.join(ref, "snapshot.jylis"))
        save = closed["recovery"]["save"]
        if not save or os.path.getsize(os.path.join(data, "journal.jylis")) != 40:
            raise AssertionError(f"persistence phase: P1's shutdown wrote {save}, journal not "
                                 "retired")
        out["snapshot_bytes"], out["snapshot_write_s"] = save[-1]["bytes"], save[-1]["s"]
        emit({"phase": "persist_step", "step": "p1", **out})

        p2 = boot(p_device, data)
        on_cards(p2, "P2")
        rec = p2.hello["recovery"]
        if len(rec["restore"]) != 1 or rec["replay"]["replayed_batches"]:
            raise AssertionError(f"persistence phase: P2 recovered {rec}")
        restore = rec["restore"][0]
        out["p2"] = {"boot_s": p2.hello["boot_s"],
                     "process_to_listening_s": p2.hello["process_to_listening_s"],
                     "restore": restore}
        if digests_of(p2) != want1:
            raise AssertionError("persistence phase: P2's digests after the restore != P1's")
        emit({"phase": "persist_step", "step": "p2_restore", **out["p2"]})
        stage2 = persist_stage2()
        appends0 = journal_appends(p2)
        t0 = time.perf_counter()
        replies2 = p2.client.pipeline(stage2)
        last, quiet = journal_appends(p2), 0
        while quiet < PERSIST_QUIET_POLLS:
            time.sleep(CLUSTER_TICK)
            now = journal_appends(p2)
            quiet = quiet + 1 if now == last and now > appends0 else 0
            last = now
            if time.perf_counter() - t0 > CLUSTER_DEADLINE_S:
                raise AssertionError("persistence phase: P2's journal never settled")
        out["stage2"] = {"commands": len(stage2), "s": time.perf_counter() - t0,
                         "journal_appends": last - appends0}
        want2 = digests_of(p2)
        p2.kill()
        p3 = boot(p_device, data)
        on_cards(p3, "P3")
        rec3 = p3.hello["recovery"]
        out["p3"] = {"boot_s": p3.hello["boot_s"],
                     "process_to_listening_s": p3.hello["process_to_listening_s"],
                     "restore": rec3["restore"], "replay": rec3["replay"]}
        if not rec3["replay"] or rec3["replay"]["replayed_batches"] < 1:
            raise AssertionError(f"persistence phase: P3 replayed no journal: {rec3}")
        got3 = digests_of(p3)
        if got3 != want2:
            raise AssertionError("persistence phase: P3's digests after the SIGKILL != P2's")
        p3.close()
        emit({"phase": "persist_step", "step": "p3_replay", **out["p3"]})

        r = boot("cpu", ref)
        out["r_restore"] = r.hello["recovery"]["restore"]
        if digests_of(r) != want1:
            raise AssertionError("persistence phase: the CPU node's digests on P1's file != P1's")
        check_replies("second stage: CPU node vs P2", r.client.pipeline(stage2), replies2)
        want_r = digests_of(r)
        if want_r != got3:
            raise AssertionError("persistence phase: the CPU node's digests != P3's")
        r.close()
        if cards > 1:
            out["layouts"] = persist_layouts(data, os.path.join(root, "layouts"), boot,
                                             on_cards, want_r, cards)
        elif p_device == "cuda":
            not_run(torch, "persist_layouts")
        out["phase_s"] = time.perf_counter() - t_phase
        out["digest"] = got3[0].split(b"\r\n")[1].decode()
        lines = [ln for ln in got3[1].split(b"\r\n") if ln and ln[:1] not in b"*$"]
        if any(ln.endswith(b"0" * 64) for ln in lines):
            raise AssertionError(f"persistence phase: a type holds no data: {lines}")
    finally:
        for node in nodes:
            node.close()
        shutil.rmtree(root, ignore_errors=True)
    out["restore_launches"] = restore["launches"]
    out["replay_launches"] = out["p3"]["replay"]["launches"]
    emit({"phase": "persist", **{k: v for k, v in out.items() if k not in ("p2", "p3")}})
    if p_device != "cpu":
        missing = [g for g in PERSIST_PATH if not any(out["restore_launches"].get(n) for n in g)]
        if missing:
            raise AssertionError(f"persistence phase: the restore on the card launched no "
                                 f"kernel of {missing}: {out['restore_launches']}")
    return out


# ---- the lanes phase -----------------------------------------------------------

LANES = 2
LANES_TICK = 1.0  # --heartbeat-time of the lanes node (its bus keeps 0.25 s)
LANES_KEYS = NODE_KEYS  # keys per counter type written over RESP, half at each lane
LANES_DEADLINE_S = 150.0  # each wait of the phase polls to this deadline
LANES_POLL_S = 1.0  # SYSTEM DIGEST polls: each folds the keys dirtied since under the locks
LANES_SHED = 4  # admission.shed's budget in lane 1: its first SYSTEM METRICS, the drill's 3
# the drain kernels each lane must launch: a counter drain of each type
LANES_PATH = (("counter_drain_dense<1>", "counter_drain_sparse<1>"),
              ("counter_drain_dense<2>", "counter_drain_sparse<2>"))
_LANE_DIED = re.compile(r"lane (\d+) died \(rc (-?\d+|None)\)")
_LANE_UP = re.compile(r"serving lane (\d+)/\d+ \(pid (\d+)\) .* device ([^,\s]+)(?:, (Mesh.*))?")
_LANE_LAUNCHES = re.compile(
    r"kernel launches since warmup \(pid (\d+)\): (\{[^{}]*\})(?:; by card: (\{.*\}))?")


def lane_of_reply(reply: bytes) -> int:
    m = re.search(rb"LANE id (\d+)", reply)
    if m is None:
        raise AssertionError("lanes phase: SYSTEM METRICS has no LANE section")
    return int(m.group(1))


def metric(reply: bytes, name: bytes) -> int:
    m = re.search(rb"\r\n" + re.escape(name) + rb" (\d+)\r\n", reply)
    return int(m.group(1)) if m else 0


def bulk_of(reply: bytes, pos: int = 0) -> tuple[bytes, int]:
    """The bulk string at ``pos`` of a raw reply, and the offset after it."""
    eol = reply.index(b"\r\n", pos)
    n = int(reply[pos + 1:eol])
    return reply[eol + 2:eol + 2 + n], eol + 4 + n


class LanesNode:
    """``python -m jylis_tpu_torch --lanes 2`` as a user starts it: the
    supervisor process, which spawns the two lane workers; its output
    goes to a file the phase reads the lanes' log lines from."""

    def __init__(self, root: str, device=None):
        from pathlib import Path

        from jylis_tpu_torch.utils.net import free_port

        self.data = os.path.join(root, "data")
        self.port, cport, self.mport = free_port(), free_port(), free_port()
        self.addr = ("127.0.0.1", str(cport), "lanes")
        self.log_path = os.path.join(root, "lanes.log")
        self._log = open(self.log_path, "w")
        self.dropped = []  # connections a lane accepted and closed in connect
        argv = [sys.executable, "-m", "jylis_tpu_torch", "--port", str(self.port),
                "--addr", ":".join(self.addr), "--lanes", str(LANES), "--data-dir", self.data,
                "--metrics-port", str(self.mport), "--heartbeat-time", str(LANES_TICK)]
        if device is not None:
            argv += ["--device", str(device)]
        # lane 1 sheds every class but control for its first LANES_SHED
        # Python-path commands (the admission drill)
        env = dict(os.environ, JYLIS_LANE_FAILPOINTS=f"1:admission.shed=error:{LANES_SHED}")
        self.proc = subprocess.Popen(argv, cwd=str(Path(__file__).resolve().parent), env=env,
                                     stdout=self._log, stderr=subprocess.STDOUT)

    def manifest(self) -> dict:
        try:
            with open(os.path.join(self.data, "lanes.json"), encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def pids(self) -> list:
        return [lane["pid"] for lane in self.manifest().get("lanes", [])]

    def text(self) -> str:
        with open(self.log_path, encoding="utf-8", errors="replace") as f:
            return f.read()

    def alive(self) -> None:
        if self.proc.poll() is not None:
            raise AssertionError(f"lanes phase: the supervisor exited ({self.proc.returncode}): "
                                 f"{self.text()[-3000:]}")

    def connect(self, want: int, drill=None) -> Client:
        """A connection the kernel gave to lane ``want``; ``drill`` runs on
        the first connection that lands on lane 1, right after its first
        command."""
        t0, extra = time.perf_counter(), []
        try:
            while True:
                self.alive()
                if time.perf_counter() - t0 > LANES_DEADLINE_S:
                    raise AssertionError(f"lanes phase: no connection reached lane {want}")
                try:
                    c = Client(self.port)
                except ConnectionRefusedError:  # no lane listening yet
                    time.sleep(0.2)
                    continue
                try:
                    lane = lane_of_reply(c.pipeline([("SYSTEM", "METRICS")])[0])
                except OSError as e:
                    # a lane accepted the connection and closed it: counted
                    # here, and the phase fails on it (and on any lane death
                    # it did not cause) once the lanes line is out
                    c.close()
                    self.dropped.append(f"{type(e).__name__}: {e}")
                    time.sleep(0.2)
                    continue
                if lane == 1 and drill is not None and not drill:
                    drill.update(admission_drill(c))
                if lane == want:
                    return c
                extra.append(c)
        finally:
            for c in extra:
                c.close()

    def stop(self) -> int:
        """SIGTERM: the supervisor stops the lanes (each a clean Dispose)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        for pid in self.pids():  # lanes the supervisor could not stop
            if pid:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
        self._log.close()
        return self.proc.returncode


def admission_drill(c: Client) -> dict:
    """On lane 1's first connection, with admission.shed armed there: a
    read, a write and a bulk command get the typed BUSY reply (class and
    retry-after hint), and lane 1's OVERLOAD section counts the three."""
    cmds = [("TENSOR", "GET", "lanes:shed"), ("BCOUNT", "GRANT", "lanes:shed", 1),
            ("TENSOR", "SET", "lanes:shed", "MAX", 1, np.float32(1).tobytes())]
    replies = c.pipeline(cmds)
    for reply, cls in zip(replies, ("read", "write", "bulk")):
        if not reply.startswith(b"-BUSY (overload shed class=" + cls.encode()) \
                or b"retry-after-ms=" not in reply:
            raise AssertionError(f"lanes phase: lane 1 did not shed a {cls}: {reply[:120]!r}")
    metrics = c.pipeline([("SYSTEM", "METRICS")])[0]
    shed = {cls: metric(metrics, b"OVERLOAD shed_" + cls.encode())
            for cls in ("control", "read", "write", "bulk")}
    if shed != {"control": 0, "read": 1, "write": 1, "bulk": 1} or lane_of_reply(metrics) != 1:
        raise AssertionError(f"lanes phase: lane 1's OVERLOAD section counted {shed}")
    return {"busy": [r.decode(errors="replace").strip() for r in replies], "shed": shed}


def lanes_reference(keys_cmds: dict, ext_identity: int, addr):
    """The CPU reference: a port Database per lane identity (lane_identity
    of the node's address) fed that lane's commands, one with E's identity
    fed E's RESP writes, and config 2 converged as E converged it, all
    joined into the first."""
    from jylis_tpu_torch.lanes import lane_identity
    from jylis_tpu_torch.models.database import Database
    from jylis_tpu_torch.server.resp import Respond
    from jylis_tpu_torch.utils.address import Address
    from jylis_tpu_torch.utils.config import Config

    cfg = Config(addr=Address(*addr))
    dbs = [Database(lane_identity(cfg, k), device="cpu") for k in range(LANES)]
    dbs.append(Database(ext_identity, device="cpu"))
    sink = Respond(lambda b: None)
    for name, batch in config2_batches():
        dbs[0].converge(name, batch)
    for db, cmds in zip(dbs, [keys_cmds[k] for k in range(LANES)] + [config2_writes()]):
        for cmd in cmds:
            db.apply(sink, [a if isinstance(a, bytes) else str(a).encode() for a in cmd])
    for db in dbs[1:]:
        db.flush_deltas(lambda d: dbs[0].converge(d[0], d[1]))
    return dbs[0]


def ref_digest(db) -> bytes:
    return b"$64\r\n" + db._sync_digest_blocking().hex().encode() + b"\r\n"


def lanes_phase(torch, l_device=None) -> dict:
    """A two-lane node (``--lanes 2``): the supervisor and its two lane
    workers, each a full replica on the node's default device (the card),
    their bus on loopback, lane 0 the node's one cluster member.

    1. Start the node as a user does; E, a CPU port node in a process of
       its own seeded with the node's address (lane 0's external
       identity), converges BASELINE config 2 (100,000 GCOUNT and PNCOUNT
       keys from 8 replica ids) before it listens or dials, so its first
       sync with lane 0 carries all of it, then takes 100 writes over
       RESP. Lane 1 has
       admission.shed armed (JYLIS_LANE_FAILPOINTS): on its first
       connection a read, a write and a bulk command get BUSY with their
       class and retry-after hint, and its OVERLOAD section counts them.
    2. One connection per lane (each learns its lane from SYSTEM METRICS'
       LANE section): GCOUNT INC and PNCOUNT INC/DEC of every key of
       config 2's key set, key i at lane i % 2. Lane 0 bootstraps config 2
       from E over the wire and relays it onto the bus; lane 1 and E get
       the other lanes' writes over the bus and the bridge.
    3. Both lanes, E and the CPU reference (lanes_reference) reach one
       SYSTEM DIGEST; every key's GET of both types at the lane that did
       not take its write equals the reference's.
    4. Per lane: drains of both counter types in SYSTEM METRICS, no idle
       eviction in its CLUSTER section, its log line naming its device
       (cuda:N), and its pid among nvidia-smi's compute apps when that
       lists any. A SESSION WRAP at lane 0 is served by SESSION READ at
       lane 1; a mangled token gets BADTOKEN. The supervisor's aggregated
       Prometheus endpoint has both lanes' samples, each lane up, and the
       summed drain counters.
    5. SIGKILL lane 1 (its pid from lanes.json, the first restart of the
       run): the supervisor writes a new pid, the lane replays its own
       journal segment and rejoins the bus, and the digests are equal
       again. Then SIGTERM: each lane logs its kernel launches since its
       warmup at its clean shutdown (lane 1's of its second life).
    The "lanes" line holds each step's host seconds."""
    import tempfile
    import urllib.request

    from jylis_tpu_torch.utils.address import Address

    root = tempfile.mkdtemp(prefix="chip_smoke_lanes_")
    cards = n_cards(torch) if l_device is None else 0
    out = {"device": str(l_device or "default (cuda)"), "lanes": LANES, "keys": LANES_KEYS,
           "tick_s": LANES_TICK}
    node = ext = None
    conns = {}
    t_phase = time.perf_counter()
    try:
        apps0 = card_apps() if cards > 1 else None
        node = LanesNode(root, l_device)
        # E converges config 2 before it listens or dials, so the first
        # sync between it and lane 0 carries all of it
        t0 = time.perf_counter()
        ext = PeerProcess("ext", "cpu", seeds=[node.addr], preload_config2=True)
        out["ext_boot_s"] = time.perf_counter() - t0
        drill = {}
        t0 = time.perf_counter()
        conns[1] = node.connect(1, drill)
        conns[0] = node.connect(0)
        out["boot_s"] = time.perf_counter() - t_phase
        out["drill"] = drill
        pids0 = node.pids()
        if len(pids0) != LANES or not all(pids0):
            raise AssertionError(f"lanes phase: lanes.json lists {pids0}")
        if set(ext.client.pipeline(config2_writes())) != {b"+OK\r\n"}:
            raise AssertionError("lanes phase: E's writes were not acknowledged")

        rng = np.random.default_rng(SEED + 97)
        keys = [b"k%06d" % i for i in range(LANES_KEYS)]
        gv, pv = (rng.integers(1, 1 << 40, LANES_KEYS) for _ in range(2))
        pol = rng.integers(0, 2, LANES_KEYS)
        cmds = {k: [] for k in range(LANES)}
        for i, key in enumerate(keys):
            cmds[i % LANES] += [("GCOUNT", "INC", key, int(gv[i])),
                                ("PNCOUNT", "DEC" if pol[i] else "INC", key, int(pv[i]))]
        # the CPU reference builds in a thread while the writes go out and
        # the lanes converge
        built = {}

        def reference():
            t0 = time.perf_counter()
            built["ref"] = lanes_reference(cmds, Address(*ext.addr).hash64(), node.addr)
            built["want"] = ref_digest(built["ref"])
            built["s"] = time.perf_counter() - t0

        ref_thread = threading.Thread(target=reference)
        ref_thread.start()
        t0 = time.perf_counter()
        try:
            for k in range(LANES):
                replies = conns[k].pipeline(cmds[k], chunk=2048)
                if set(replies) != {b"+OK\r\n"}:
                    raise AssertionError(f"lanes phase: lane {k}'s writes: {set(replies)}")
            out["writes_s"] = time.perf_counter() - t0
        finally:
            ref_thread.join()
        if "want" not in built:
            raise AssertionError("lanes phase: the CPU reference failed")
        ref, want = built["ref"], built["want"]
        out["reference_s"] = built["s"]
        t_written = time.perf_counter()

        def digests() -> list:
            return [conns[k].pipeline([("SYSTEM", "DIGEST")])[0] for k in range(LANES)] \
                + [ext.client.pipeline([("SYSTEM", "DIGEST")])[0]]

        def converged(what: str) -> float:
            t0, seen = time.perf_counter(), None
            while True:
                node.alive()
                seen = digests()
                if all(d == want for d in seen):
                    return time.perf_counter() - t0
                if time.perf_counter() - t0 > LANES_DEADLINE_S:
                    raise AssertionError(f"lanes phase: {what}: digests {seen} != {want}")
                time.sleep(LANES_POLL_S)

        converged("lanes, E and the reference")
        out["converge_s"] = time.perf_counter() - t_written  # last write to one digest
        emit({"phase": "lanes_step", "step": "converged", **out})
        # every key read back at the lane that did not take its write
        t0 = time.perf_counter()
        sink_out = bytearray()
        from jylis_tpu_torch.server.resp import Respond

        for name in ("GCOUNT", "PNCOUNT"):
            for k in range(LANES):
                mine = keys[1 - k::LANES] if LANES == 2 else []
                got = conns[k].pipeline([(name, "GET", key) for key in mine], chunk=2048)
                exp = []
                for key in mine:
                    sink_out.clear()
                    ref.apply(Respond(sink_out.extend), [name.encode(), b"GET", key])
                    exp.append(bytes(sink_out))
                check_replies(f"lanes phase: {name} GET at lane {k}", got, exp)
        out["cross_reads"] = 2 * LANES_KEYS
        out["cross_reads_s"] = time.perf_counter() - t0
        emit({"phase": "lanes_step", "step": "cross_reads", "s": out["cross_reads_s"]})

        # per lane: drains, no idle eviction, its device, its pid
        per_lane = {}
        for k in range(LANES):
            m = conns[k].pipeline([("SYSTEM", "METRICS")])[0]
            per_lane[k] = {"drains": {n: metric(m, n.encode() + b" drains")
                                      for n in ("GCOUNT", "PNCOUNT")},
                           "drop_idle": metric(m, b"CLUSTER drop_idle"),
                           "evictions": metric(m, b"CLUSTER evictions")}
            if min(per_lane[k]["drains"].values()) < 1 or per_lane[k]["drop_idle"]:
                raise AssertionError(f"lanes phase: lane {k}: {per_lane[k]}")
        up = _LANE_UP.findall(node.text())
        devices = {int(pid): (dev, mesh) for _, pid, dev, mesh in up}
        for k, pid in enumerate(pids0):
            dev, mesh = devices.get(pid, (None, ""))
            per_lane[k]["pid"], per_lane[k]["device"], per_lane[k]["mesh"] = pid, dev, mesh
            if dev is None or (l_device is None and not dev.startswith("cuda:")):
                raise AssertionError(f"lanes phase: lane {k} (pid {pid}) logged device {dev}")
            if cards > 1 and not all(f"cuda:{i}" in mesh for i in range(cards)):
                raise AssertionError(f"lanes phase: lane {k}'s mesh {mesh!r} is not on the "
                                     f"{cards} cards")
        apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.split() \
            if l_device is None else []
        out["nvidia_smi_pids"] = apps
        if cards > 1:  # each lane holds a context on every card
            out["card_apps"] = check_card_apps("lanes phase, both lanes up", apps0, LANES)
        # nvidia-smi names the host's pids; in a pid namespace of its own
        # (a container) it shows others, and then only its count is read
        if any(str(pid) in apps for pid in pids0):
            if not all(str(pid) in apps for pid in pids0):
                raise AssertionError(f"lanes phase: lane pids {pids0} not among {apps}")
        elif apps and len(apps) < LANES:
            raise AssertionError(f"lanes phase: {len(apps)} compute apps on the card: {apps}")
        out["per_lane"] = per_lane

        # sessions across lanes
        t0 = time.perf_counter()
        wrap = conns[0].pipeline([("SESSION", "WRAP", "GCOUNT", "INC", "lanes:session", 1)])[0]
        if not wrap.startswith(b"*2\r\n+OK\r\n$"):
            raise AssertionError(f"lanes phase: SESSION WRAP at lane 0: {wrap[:80]!r}")
        token, _ = bulk_of(wrap, len(b"*2\r\n+OK\r\n"))
        ref.apply(Respond(lambda b: None), [b"GCOUNT", b"INC", b"lanes:session", b"1"])
        stale = 0
        while True:
            read = conns[1].pipeline([("SESSION", "READ", token, "GCOUNT", "GET",
                                       "lanes:session")])[0]
            if not read.startswith(b"-STALE"):
                break
            stale += 1
            if time.perf_counter() - t0 > LANES_DEADLINE_S:
                raise AssertionError("lanes phase: lane 1 never covered lane 0's token")
        if not (read.startswith(b"*2\r\n$") and read.endswith(b":1\r\n")):
            raise AssertionError(f"lanes phase: SESSION READ at lane 1: {read[:80]!r}")
        bad = bytearray(token)
        bad[len(bad) // 2] ^= 0x5A
        badtoken = conns[1].pipeline([("SESSION", "READ", bytes(bad), "GCOUNT", "GET",
                                       "lanes:session")])[0]
        if not badtoken.startswith(b"-BADTOKEN"):
            raise AssertionError(f"lanes phase: a mangled token got {badtoken[:80]!r}")
        out["session"] = {"token_bytes": len(token), "stale_before_served": stale,
                          "s": time.perf_counter() - t0}
        want = ref_digest(ref)

        # the supervisor's aggregated Prometheus endpoint
        body = urllib.request.urlopen(f"http://127.0.0.1:{node.mport}/metrics",
                                      timeout=60).read().decode()
        prom = {"bytes": len(body)}
        for k in range(LANES):
            if f'jylis_lane_up{{lane="{k}"}} 1' not in body or f'lane="{k}",' not in body:
                raise AssertionError(f"lanes phase: the aggregated scrape lacks lane {k}")
        for name in ("GCOUNT", "PNCOUNT"):
            per = [float(v) for v in re.findall(
                rf'jylis_drain_total{{lane="\d+",type="{name}",kind="batches"}} (\S+)', body)]
            total = re.search(rf'^jylis_drain_total{{type="{name}",kind="batches"}} (\S+)$',
                              body, re.M)
            if len(per) != LANES or total is None or float(total.group(1)) != sum(per) \
                    or sum(per) < LANES:
                raise AssertionError(f"lanes phase: {name}'s summed drains {total} vs {per}")
            prom[f"{name}_drain_batches"] = sum(per)
        out["prometheus"] = prom
        emit({"phase": "lanes_step", "step": "served", **out})

        # SIGKILL lane 1: no restart may have happened before
        pids = node.pids()
        if pids != pids0 or re.search(r"lane \d+ died", node.text()):
            raise AssertionError(f"lanes phase: a lane restarted before the drill: {pids0} -> "
                                 f"{pids}")
        t0 = time.perf_counter()
        os.kill(pids0[1], signal.SIGKILL)
        conns.pop(1).close()
        while node.pids()[1] in (pids0[1], None):
            node.alive()
            if time.perf_counter() - t0 > LANES_DEADLINE_S:
                raise AssertionError("lanes phase: lane 1 was never respawned")
            time.sleep(0.1)
        respawned = node.pids()[1]
        conns[1] = node.connect(1)
        out["respawn_to_serving_s"] = time.perf_counter() - t0
        out["reconverge_s"] = converged("after lane 1's respawn")
        m = conns[1].pipeline([("SYSTEM", "METRICS")])[0]
        out["respawned"] = {"pid": respawned,
                            "replayed_batches": metric(m, b"JOURNAL replayed_batches"),
                            "drains": {n: metric(m, n.encode() + b" drains")
                                       for n in ("GCOUNT", "PNCOUNT")},
                            "drop_idle": metric(m, b"CLUSTER drop_idle")}
        if out["respawned"]["replayed_batches"] < 1:
            raise AssertionError(f"lanes phase: the respawned lane replayed nothing: "
                                 f"{out['respawned']}")
        if node.pids()[0] != pids0[0]:
            raise AssertionError("lanes phase: lane 0 restarted")
    except BaseException:
        if node is not None:
            print(f"lanes phase: the node's log ends\n{node.text()[-4000:]}", file=sys.stderr)
        raise
    finally:
        for c in conns.values():
            c.close()
        if ext is not None:
            ext.close()
        rc = node.stop() if node is not None else None
        text = node.text() if node is not None else ""
        shutil.rmtree(root, ignore_errors=True)
    out["supervisor_rc"] = rc
    found = _LANE_LAUNCHES.findall(text)
    launched = {int(pid): json.loads(js) for pid, js, _ in found}
    cards_of = {int(pid): json.loads(cs) if cs else {} for pid, _, cs in found}
    by_lane = {0: launched.get(pids0[0], {}), 1: launched.get(respawned, {})}
    out["launches_by_card"] = {0: cards_of.get(pids0[0], {}), 1: cards_of.get(respawned, {})}
    out["launches_by_lane"] = by_lane
    out["launches"] = {n: by_lane[0].get(n, 0) + by_lane[1].get(n, 0)
                       for n in set(by_lane[0]) | set(by_lane[1])}
    out["respawned_device"] = {int(pid): dev for _, pid, dev, _ in _LANE_UP.findall(text)}.get(
        respawned)
    # the supervisor logs each lane death; the phase caused one, lane 1's
    # SIGKILL (rc -9)
    out["lane_deaths"] = _LANE_DIED.findall(text)
    out["connect_drops"] = node.dropped if node is not None else []
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "lanes", **out})
    if rc != 0:
        raise AssertionError(f"lanes phase: the supervisor exited {rc}")
    if out["lane_deaths"] != [("1", "-9")] or out["connect_drops"]:
        raise AssertionError(f"lanes phase: lane deaths {out['lane_deaths']} (the phase "
                             f"killed lane 1 once), connections a lane dropped "
                             f"{out['connect_drops']}")
    if len(launched) < LANES:
        raise AssertionError(f"lanes phase: the lanes logged launches {launched}")
    if l_device is None:
        missing = [g for g in LANES_PATH if not any(by_lane[0].get(n) for n in g)]
        if missing or not any(by_lane[1].get(n) for g in LANES_PATH for n in g):
            raise AssertionError(f"lanes phase: a lane launched no counter drain kernel: {by_lane}")
        if not str(out["respawned_device"]).startswith("cuda:"):
            raise AssertionError(f"lanes phase: the respawned lane on {out['respawned_device']}")
        if cards > 1:
            off = off_cards(out["launches_by_card"][0], CARDS_PATH[:2], cards)
            if off:
                raise AssertionError(f"lanes phase: lane 0 drained no counter on {off}: "
                                     f"{out['launches_by_card']}")
        else:
            not_run(torch, "lanes_cards")
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
    "treg_drain_dense": (
        "jylis_tpu_torch/csrc/treg_drain.cu",
        "jylis_tpu/models/repo_treg.py:63 (_drain_dense -> ops/treg.py:111 "
        "converge_dense, XLA)",
    ),
    "treg_drain_sparse": (
        "jylis_tpu_torch/csrc/treg_drain.cu",
        "jylis_tpu/models/repo_treg.py:57 (_drain -> ops/treg.py:82 "
        "converge_batch, XLA)",
    ),
    "tensor_converge_batch": (
        "jylis_tpu_torch/csrc/tensor_converge_batch.cu",
        "jylis_tpu/models/repo_tensor.py:72 (_drain -> ops/tensor.py:121 "
        "converge_batch, XLA)",
    ),
    "tlog_drain_sparse": (
        "jylis_tpu_torch/csrc/tlog_drain.cu",
        "jylis_tpu/models/repo_tlog.py:70 (_drain -> ops/tlog.py:361 "
        "converge_then_trim, XLA)",
    ),
    "tlog_drain_dense": (
        "jylis_tpu_torch/csrc/tlog_drain.cu",
        "jylis_tpu/models/repo_tlog.py:79 (_drain_dense -> ops/tlog.py:361 "
        "converge_then_trim, XLA)",
    ),
    "ujson_join": (
        "jylis_tpu_torch/csrc/ujson_join.cu",
        "jylis_tpu/ops/ujson_device.py:109 (_join_row, XLA, under join_batch :143 "
        "and _fold_body :183) with ops/ujson_resident.py:203 (_finish) in "
        "fold_join_subset :218, fold_join_aligned :244 and fold_broadcast_rows :256",
    ),
    "ujson_fold_flat": (
        "jylis_tpu_torch/csrc/ujson_fold_flat.cu",
        "jylis_tpu/ops/ujson_resident.py:88 (_fold_flat_one, XLA, under "
        "_fold_grid :136)",
    ),
    "replica_join": (
        "jylis_tpu_torch/csrc/replica_join.cu",
        "jylis_tpu/parallel/sharded.py:396-442 (join_replica_axis: _tree_join + "
        "_local_then_pmax, shard_map + lax.pmax over the rep axis)",
    ),
}


# why no one PyTorch call computes each kernel's function (library_ms
# null); replica_join's is timed when torch runs it (u64_amax)
LIBRARY_NONE = {
    "counter_drain_dense<1>": "none: an unsigned max of two planes, then a wrapping row sum "
                              "(two calls at least; torch.maximum is signed on int64)",
    "counter_drain_dense<2>": "none: as <1> on both polarities, then the net of two row sums",
    "counter_drain_sparse<1>": "none: a scatter of an unsigned max at rows, then their row sums "
                               "(index_reduce_ amax is signed, and a second call sums)",
    "counter_drain_sparse<2>": "none: as <1> on both polarities, then the net",
    "tensor_join_dense": "none: a per-cell LWW select over (ts_hi, ts_lo, rid) with the NaN "
                         "order, four planes written",
    "treg_drain_dense": "none: a lexicographic unsigned (ts, rank) select with a tie mask",
    "treg_drain_sparse": "none: the same select gathered and scattered at rows",
    "tensor_converge_batch": "none: the LWW cell select gathered and scattered at rows",
    "tlog_drain_sparse": "none: a per-row merge of sorted entries with dedup, cutoff and trim",
    "tlog_drain_dense": "none: the same merge over every row",
    "ujson_join": "none: an ORSWOT row join (dot membership, context cover, compaction)",
    "ujson_fold_flat": "none: an n-way ORSWOT fold per key",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    from jylis_tpu_torch import native
    from jylis_tpu_torch.ops import _build

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)  # build from source
    # the native library (g++) builds beside the kernels (nvcc); its line
    # comes first
    lib_err = []

    def build_lib():
        try:
            native.lib()
        except Exception as e:  # re-raised below, on the main thread
            lib_err.append(e)

    lib_thread = threading.Thread(target=build_lib)
    lib_thread.start()
    t0 = time.perf_counter()
    try:
        per_source = _build.build()
    finally:
        lib_thread.join()
    build_s = time.perf_counter() - t0
    if lib_err:
        raise lib_err[0]
    emit({"phase": "native", "path": native.info["path"], "build_s": native.info["build_s"],
          "compiler": native.info["compiler"]})
    card = smi_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": card, "name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          **hbm_check()})
    emit({"phase": "build", "seconds": build_s,
          "per_source_s": per_source, "dir": str(_build.BUILD_DIR)})
    cards_phase(torch)

    # host work first, while the process holds few Python objects (each
    # collection of a large heap would weigh on the decode's allocations)
    codec_phase()
    launch_floor(torch)
    rows = counter_phases(torch, card)
    rows.update(tensor_phase(torch, card))
    sweep = tensor_sweep(torch)
    rows.update(treg_phases(torch, card))
    rows.update(tensor_batch_phases(torch, card))
    rows.update(tlog_phases(torch, card))
    t0 = time.perf_counter()
    flat = uj_flat_data(UJ_FLAT_KEYS)  # the flat leg, for 7. and 10.
    emit({"phase": "ujson_flat_leg_generate", "keys": UJ_FLAT_KEYS,
          "deltas": UJ_FLAT_KEYS * UJ_FLAT_D, "seconds": time.perf_counter() - t0})
    rows.update(ujson_phases(torch, card, flat[1]))
    devs = mesh_devices(torch)
    emit({"phase": "mesh", "devices": devs, "device_count": torch.cuda.device_count(),
          "cards": "one card, 4 shards on it" if len(set(devs)) == 1
          else f"{len(set(devs))} cards, {MESH_SHARDS // len(set(devs))} shard(s) a card"})
    rows.update(replica_join_phase(torch, card))
    rows["replica_join"]["cards"] = replica_join_cards_phase(torch, card)
    routes = mesh_route_phases(torch, card, devs)
    xfer = transfer_phase(torch)
    calls = counter_call_cases(torch, card, devs, xfer)
    calls.update(treg_call_cases(torch, card, devs, xfer))
    calls.update(dense_call_cases(torch, card, xfer))
    # the main paths, each with its launch counts set to 0 just before it
    node = node_phase(torch)
    treg_node = treg_node_phase(torch)
    tensor_node = tensor_node_phase(torch)
    tlog_node = tlog_node_phase(torch)
    ujson_store_phase(torch)
    ujson_node = ujson_node_phase(torch, flat=flat)
    mesh_node = mesh_node_phase(torch, devs)
    digest = digest_phase(torch, devs)
    cluster = cluster_phase(torch)
    persisted = persist_phase(torch)
    laned = lanes_phase(torch)

    launches = dict(node["launches"], tensor_join_dense=sweep["launches"],
                    **treg_node["launches"], **tensor_node["launches"],
                    **tlog_node["launches"], **ujson_node["launches"])
    # the row kernels' main-path launches by class (ops/row_plan.py)
    classes = dict(tlog_node["classes"], **ujson_node["classes"])
    mesh_launches = mesh_node["launches"]
    dryrun_launches = mesh_node["dryrun_launches"]
    # replica_join's main path is the dryrun (no serving repo runs it)
    launches.update({n: dryrun_launches.get(n, 0) for n in DRYRUN_PATH})
    routes["ujson_join"] = routes["ujson_fold_flat"] = routes.pop("ujson_aligned")
    timing = ("shape", "class", "kernel_ms", "device_ms", "plain_ms", "bound_ms",
              "old_bound_ms", "launch_host_ms")
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        r = rows[kname]
        ns = r.get("north_star")
        others = r.get("other_shapes", [])
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches.get(kname, 0),
            "mesh_launches": mesh_launches.get(kname, 0),
            "dryrun_launches": dryrun_launches.get(kname, 0),
            "digest_launches": digest["launches"].get(kname, 0),
            "cluster_launches": cluster["launches"].get(kname, 0),
            "cluster_wire_launches": cluster["wire_launches"].get(kname, 0),
            "restore_launches": persisted["restore_launches"].get(kname, 0),
            "replay_launches": persisted["replay_launches"].get(kname, 0),
            "lanes_launches": laned["launches"].get(kname, 0),
            "cluster_launches_by_card": cluster["launches_by_card"].get(kname, {}),
            "max_abs_err": max([r["max_abs_err"]] + [
                x["max_abs_err"] for x in ([ns] if ns else []) + others]),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": r["shape"],
            "device_ms": r["device_ms"],
            **({"class": r["class"]} if "class" in r else {}),
            **({"launch_classes": classes[kname]} if kname in classes else {}),
            "library": r.get("library") or LIBRARY_NONE.get(kname),
            **({"north_star": {k: ns[k] for k in timing if k in ns}} if ns else {}),
            **({"other_shapes": [{k: x[k] for k in timing if k in x} for x in others]}
               if others else {}),
            **({"mesh_routes": routes[kname]} if kname in routes else {}),
            **({"staged_calls": calls[kname]} if kname in calls else {}),
            **({"cards": r["cards"]} if r.get("cards") else {}),
        })
    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
