"""Mesh construction: one place decides how devices become a mesh.

The port of jylis_tpu/parallel/mesh.py. A ``Mesh`` is a (rep x keys)
grid of ``torch.device``s. ``rep=1`` is the serving layout: every
keyspace splits into contiguous key blocks, one per device of the keys
axis, and a drain needs no communication. ``rep>1`` carves a replica
fan-in axis for ``join_replica_axis``.

PyTorch has no virtual-device platform like the JAX package's 8 virtual
CPU devices, so ``make_mesh`` also takes an explicit device list in
which a device may repeat (``[cpu] * 4``, ``[cuda:0] * 4``): that is how
the tests and chip_smoke.py get a 4-shard mesh on one CPU or one card.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A (rep x keys) grid of torch devices (``devices``: an object
    ndarray of that shape, as ``jax.sharding.Mesh.devices`` is)."""

    def __init__(self, grid, axis_names=("rep", "keys")):
        self.devices = np.empty((len(grid), len(grid[0])), dtype=object)
        for r, row in enumerate(grid):
            for k, d in enumerate(row):
                self.devices[r, k] = torch.device(d)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def keys_devices(self) -> list[torch.device]:
        """The devices of one rep row: key block i lives on device i."""
        return list(self.devices[0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int | None = None, rep: int = 1, devices=None,
              axis_names=("rep", "keys")) -> Mesh:
    """A (rep x keys) mesh over the first ``n_devices`` of ``devices``
    (default: every visible CUDA device). Raises ValueError for more
    devices than there are, or a count that ``rep`` does not divide."""
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devs = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs) or n_devices < 1:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    if n_devices % rep != 0:
        raise ValueError(f"n_devices {n_devices} not divisible by rep {rep}")
    keys = n_devices // rep
    grid = [devs[r * keys:(r + 1) * keys] for r in range(rep)]
    return Mesh(grid, axis_names)


_SERVING_MESH: list = []  # memo cell: [Mesh | None] once resolved


def serving_mesh() -> Mesh | None:
    """The process-wide keys-sharded serving mesh over every visible CUDA
    device, or None with fewer than two. Memoised, so every repo of a
    node shares one Mesh. As in the JAX package, a node is one process on
    one host and its mesh is that host's cards; scale across hosts is the
    cluster layer's job."""
    if not _SERVING_MESH:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _SERVING_MESH.append(make_mesh(n) if n > 1 else None)
    return _SERVING_MESH[0]


def resolve_mesh(mesh, device) -> Mesh | None:
    """A repo's ``mesh`` argument: "auto" takes ``serving_mesh()`` for a
    bare CUDA ``device`` ("cuda": every visible card; one card: None),
    and no mesh for a CUDA device with an index ("cuda:1" names that
    card alone) or a CPU one; None or a Mesh pass through."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', None or a Mesh, got {mesh!r}")
        dev = torch.device(device)
        return serving_mesh() if dev.type == "cuda" and dev.index is None else None
    return mesh
