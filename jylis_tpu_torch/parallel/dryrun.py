"""The mesh dryrun: five checks of the sharded paths on a list of devices.

The port of the JAX package's ``dryrun_multichip`` (__graft_entry__.py,
run there on N virtual CPU devices). Here the caller names the devices;
one may repeat (``["cpu"] * 4``, ``["cuda:0"] * 4``), which gives a
4-shard mesh on one CPU or one card:

1. a keys-sharded anti-entropy merge (``converge_sharded``, one
   ``counter_drain_sparse<1>`` launch per shard) and every row's sum;
2. the replica-axis lattice join (``join_replica_axis``, the
   ``replica_join`` kernel) on a (rep x keys) mesh, rep = 2 for an even
   device count;
3. two PNCOUNT repos in mesh mode converge through the staged,
   unrouted drain (one launch per card);
4. TREG (a timestamp tie the host settles; the unrouted drain) and TLOG
   (a routed merge, then a TRIM) repos in mesh mode;
5. UJSON in mesh mode: three keys with a deep fan-in go resident and
   fold through the row-aligned fold on every shard.

Each check raises AssertionError when its result is wrong.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import planes
from .mesh import make_mesh
from .sharded import (
    converge_sharded,
    gather_grid,
    join_replica_axis,
    read_all_sharded,
    route_batch,
    shard_grid,
    shard_plane,
)


class _Sink:
    """Collects whatever a repo replies, in order."""

    def __init__(self):
        self.vals = []

    def __getattr__(self, name):
        return lambda *a: self.vals.extend(a)


def _expect(got, want, what: str) -> None:
    if got != want:
        raise AssertionError(f"dryrun {what}: got {got!r}, want {want!r}")


def _exchange(a, b) -> None:
    for src, dst in ((a, b), (b, a)):
        for key, delta in src.flush_deltas():
            dst.converge(key, delta)


def dryrun_multichip(devices) -> dict:
    """Run the five checks on a mesh over ``devices``; returns the mesh
    shapes the checks ran on."""
    from ..models.repo_counters import RepoPNCOUNT
    from ..models.repo_tlog import RepoTLOG
    from ..models.repo_treg import RepoTREG
    from ..models.repo_ujson import SEG_FANIN_MIN, RepoUJSON

    devices = [torch.device(d) for d in devices]
    n = len(devices)
    # factor the device count into (rep, keys): rep exercises the join,
    # keys the sharded serving path
    rep = 2 if n % 2 == 0 else 1
    keys_shards = n // rep
    mesh = make_mesh(n, rep=rep, devices=devices)
    keys_mesh = make_mesh(n, rep=1, devices=devices)
    k, r, b = 16 * n, 8, 4 * n
    rng = np.random.default_rng(0)

    # 1) keys-sharded anti-entropy merge on the keys-only mesh
    blocks = shard_plane(keys_mesh, np.zeros((k, r), np.uint64))
    rows = rng.integers(0, k, b).astype(np.int32)
    deltas = rng.integers(0, 1 << 48, (b, r)).astype(np.uint64)
    lr, d = route_batch(rows, deltas, n, k // n)
    converge_sharded(keys_mesh, blocks, lr, d)
    sums = read_all_sharded(keys_mesh, blocks).view(np.uint64)
    ref = np.zeros((k, r), np.uint64)
    np.maximum.at(ref, rows, deltas)
    got = np.concatenate([planes.to_u64_np(x) for x in blocks])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(sums, ref.sum(axis=1, dtype=np.uint64))

    # 2) rep-axis lattice join on the 2-D mesh
    s = rep * 2
    states = rng.integers(0, 1 << 62, (s, keys_shards * 8)).astype(np.uint64)
    joined = planes.to_u64_np(gather_grid(join_replica_axis(mesh, shard_grid(mesh, states))))
    np.testing.assert_array_equal(joined, np.broadcast_to(states.max(axis=0), states.shape))

    kw = dict(device=devices[0], mesh=keys_mesh)

    # 3) the serving path in mesh mode: two PNCOUNT repos converge
    # through the unrouted drain
    a, b2 = RepoPNCOUNT(identity=1, **kw), RepoPNCOUNT(identity=2, **kw)
    a.apply(_Sink(), [b"INC", b"dryrun", b"40"])
    b2.apply(_Sink(), [b"DEC", b"dryrun", b"15"])
    _exchange(a, b2)
    for repo in (a, b2):
        out = _Sink()
        repo.apply(out, [b"GET", b"dryrun"])
        _expect(out.vals, [25], "PNCOUNT GET")

    # 4) TREG + TLOG in mesh mode: the unrouted LWW drain (with a
    # timestamp tie) and the routed segment merge + trim
    ra, rb = RepoTREG(identity=1, **kw), RepoTREG(identity=2, **kw)
    ra.apply(_Sink(), [b"SET", b"k", b"apple", b"7"])
    rb.apply(_Sink(), [b"SET", b"k", b"zebra", b"7"])  # ts tie: zebra wins
    _exchange(ra, rb)
    for repo in (ra, rb):
        repo.drain()
        out = _Sink()
        repo.apply(out, [b"GET", b"k"])
        _expect(out.vals[-2:], [b"zebra", 7], "TREG GET")
    la, lb = RepoTLOG(identity=1, **kw), RepoTLOG(identity=2, **kw)
    la.apply(_Sink(), [b"INS", b"log", b"x", b"1"])
    lb.apply(_Sink(), [b"INS", b"log", b"y", b"2"])
    _exchange(la, lb)
    for repo in (la, lb):
        out = _Sink()
        repo.apply(out, [b"SIZE", b"log"])
        _expect(out.vals, [2], "TLOG SIZE")
    la.apply(_Sink(), [b"TRIM", b"log", b"1"])
    out = _Sink()
    la.apply(out, [b"SIZE", b"log"])
    _expect(out.vals, [1], "TLOG SIZE after TRIM")

    # 5) UJSON in mesh mode: a deep fan-in on three keys drains through
    # the row-aligned fold on every shard
    dst = RepoUJSON(identity=1, **kw)
    src = RepoUJSON(identity=9, **kw)
    n_keys = 3
    for i in range(SEG_FANIN_MIN):
        for key in range(n_keys):
            src.apply(_Sink(), [b"SET", b"doc%d" % key, b"n%d" % i, b"%d" % i])
            for kk, delta in src.flush_deltas():
                dst.converge(kk, delta)
    dst.drain()
    _expect(len(dst._pend), 0, "UJSON pending after the drain")
    _expect(len(dst._res or ()), n_keys, "UJSON resident keys")
    for key in range(n_keys):
        out = _Sink()
        dst.apply(out, [b"GET", b"doc%d" % key, b"n%d" % (SEG_FANIN_MIN - 1)])
        _expect(out.vals, ["%d" % (SEG_FANIN_MIN - 1)], "UJSON GET")
    return {"devices": [str(x) for x in devices], "mesh": mesh.shape,
            "keys_mesh": keys_mesh.shape}
