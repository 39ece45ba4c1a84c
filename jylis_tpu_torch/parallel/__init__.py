"""Device-mesh parallelism for the CRDT keyspaces.

The port of jylis_tpu/parallel. Each keyspace splits over a ``keys``
mesh axis: anti-entropy merge is embarrassingly parallel over keys, so
a drain needs no communication. The counter and TREG repos drain
unrouted (one staged call per card, the kernel finding each row's
shard); the JAX package's routed drains (one launch per shard) stay,
and TLOG's repo uses them. The lattice join across a ``rep`` axis
(full per-replica states spread over devices) is a per-column unsigned
max: the hand-written ``replica_join`` kernel folds each device's rows,
and the folded rows meet on one device per keys column.

Inter-node communication stays with the cluster layer; the mesh handles
the device math inside one node.
"""

from .mesh import Mesh, make_mesh, resolve_mesh, serving_mesh
from .sharded import (
    Keyspace,
    converge_sharded,
    drain_sharded_g,
    drain_sharded_pn,
    drain_sharded_tlog,
    drain_sharded_treg,
    drain_unrouted_g,
    drain_unrouted_pn,
    drain_unrouted_treg,
    fill_from,
    gather_grid,
    gather_state,
    join_replica_axis,
    patch_sharded_treg,
    read_all_sharded,
    replica_join,
    replica_join_plain,
    route_batch,
    route_drain,
    shard_device,
    shard_grid,
    shard_plane,
    shard_state,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "resolve_mesh",
    "serving_mesh",
    "Keyspace",
    "shard_plane",
    "shard_state",
    "gather_state",
    "shard_device",
    "shard_grid",
    "gather_grid",
    "route_batch",
    "route_drain",
    "converge_sharded",
    "read_all_sharded",
    "drain_sharded_g",
    "drain_sharded_pn",
    "drain_sharded_treg",
    "patch_sharded_treg",
    "drain_sharded_tlog",
    "drain_unrouted_g",
    "drain_unrouted_pn",
    "drain_unrouted_treg",
    "fill_from",
    "replica_join",
    "replica_join_plain",
    "join_replica_axis",
]
