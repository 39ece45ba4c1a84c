"""UJSON deltas on the wire: the one Python reader of the wire shape.

The port's copy of ``read_ujson`` from jylis_tpu/ops/ujson_wire.py
(:41-51), the part the cluster codec needs (``delta/UJSON``: entries,
vv, cloud). It builds the port's host ``UJSON`` (ops/ujson_host.py). The
lazy wire objects and the resident store's grid encoder that read the
same bytes natively come with the native engine.
"""

from __future__ import annotations

from ..utils.wire import Reader
from .ujson_host import UJSON


def read_ujson(r: Reader) -> UJSON:
    """Parse one UJSON delta payload at the reader's position (the
    oracle wire shape: entries, vv, cloud)."""
    u = UJSON()
    for _ in range(r.varint()):
        rid, seq = r.varint(), r.varint()
        path = tuple(r.str_() for _ in range(r.varint()))
        u.entries[(rid, seq)] = (path, r.str_())
    u.ctx.vv = {r.varint(): r.varint() for _ in range(r.varint())}
    u.ctx.cloud = {(r.varint(), r.varint()) for _ in range(r.varint())}
    return u
