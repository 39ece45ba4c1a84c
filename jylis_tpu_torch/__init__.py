"""jylis-tpu on PyTorch and CUDA: the port of ``jylis_tpu`` to an NVIDIA GPU.

The same RESP surface and CRDT lattices as the JAX package, with the
device work in PyTorch and in CUDA kernels written by hand for Hopper
(``csrc/``, built by ``ops/_build.py`` at first use). This package
imports no JAX and nothing of ``jylis_tpu``: it keeps its own copy of
every module it needs.

It serves all eight data types of the JAX node -- TREG, TLOG, GCOUNT,
PNCOUNT, UJSON, TENSOR, MAP and BCOUNT -- and SYSTEM, on one device, or
keys-sharded over the cards of one host (mesh mode), computes the JAX
node's ``SYSTEM DIGEST`` bytes, and joins a cluster of port and JAX
nodes over the JAX package's wire schema:

  utils/     batching, config, logging, drain metrics, node address and
             random names, networking helpers, wire primitives
  obs/       the per-Database metrics registry: histograms, trace ring,
             provenance spans
  ops/       register, log, counter and tensor lattices, the string interner,
             the UJSON host lattice, document batch (ujson_device) and
             device-resident store (ujson_resident), the MAP and BCOUNT
             host lattices (compose, bcount), the membership set (p2set),
             the UJSON wire reader, the CUDA kernel launches
  models/    per-type repos and host tables, repo manager, SYSTEM, the
             database router and its sync digest
  parallel/  the mesh: routing, per-shard drains, the replica-axis join,
             the multi-device dryrun
  cluster/   gossip membership, delta broadcast, digest-checked sync;
             the message and delta codec, framing, heartbeat
  system.py, faults.py, sessions.py
             the log's sink into SYSTEM, failpoints, session rids
  server/    RESP codec and TCP server

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu``); asking for ``cuda`` without a GPU raises.
"""

__version__ = "0.5.0"
