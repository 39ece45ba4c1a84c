"""Cluster layer: gossip membership + anti-entropy replication.

The port's copy of jylis_tpu/cluster/ (reference analog: cluster.pony +
heart.pony + msg.pony + framing.pony + framed_notify.pony +
cluster_notify.pony + _serialise.pony): the same wire schema, so a port
node and a JAX node interoperate byte for byte.
"""

from .cluster import Cluster
from .heart import Heart
from .msg import MsgAnnounceAddrs, MsgExchangeAddrs, MsgPong, MsgPushDeltas

__all__ = [
    "Cluster",
    "Heart",
    "MsgPong",
    "MsgExchangeAddrs",
    "MsgAnnounceAddrs",
    "MsgPushDeltas",
]
