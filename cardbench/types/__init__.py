"""One module per data type: ``<type, lower case>.py``, found by the
configuration's ``type`` (``load``). Everything the harness does that
depends on the type is there; every other harness file is the same for
any type. A module defines:

* ``Stream``: a ``traffic.gen.Stream`` subclass, one peer's deltas
  (``deltas(j, keys)``) and their ``MsgPushDeltas`` body (``encode``);
* ``NARROW``, the lower-precision control's type, and
  ``reference(cfg, narrow)``: a fresh plain reference (``reference/``),
  in the type the configuration states or in ``NARROW``;
* ``join(ref, stream, keys, deltas)``: one frame's deltas joined into it;
* ``readback(node, resp, cfg, keys, seed)``: the node's state after the
  window, from RESP GETs (``resp.pipeline``) and, where the check needs
  it, the card's state read under every repo lock (``node.locked``);
* ``control_state(cfg, ref)``: the state the node would give back if it
  were the reference ``ref`` (the control puts the narrow one there);
* ``compare(cfg, ref, state)``: the numbers compared, by name, each a
  count of keys or replies that differ or never came (limit 0);
* ``DRAIN_AT_CLOSE``: whether a phase ends with drain-forcing GETs;
* ``DRAIN_KERNELS`` and ``drain_bytes_per_key(cfg)``: the names of the
  kernels that implement the type's drains, and the bytes a drained key
  needs (metrics/drain_roofline_pct.py).

A module is loaded from its file, so it imports the harness by absolute
names (``cardbench.traffic.gen``).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

DIR = Path(__file__).resolve().parent


def load(type_name: str, directory: str | Path | None = None) -> ModuleType:
    """The module of data type ``type_name`` in ``directory`` (this
    package's own by default)."""
    path = Path(directory or DIR) / f"{type_name.lower()}.py"
    if not path.is_file():
        raise ValueError(f"no module for data type {type_name!r}: {path} is not there")
    spec = importlib.util.spec_from_file_location(f"cardbench_type_{type_name.lower()}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
