"""Database: keyspace router over the per-type repos.

The port of jylis_tpu/models/database.py for this slice (reference
analog: database.pony:5-65): routes cmd[0] to the matching repo manager
(case sensitive) and renders the data-type help for any other first
word, exactly as the JAX node does for an unknown one. The repos here
are TREG, TLOG, GCOUNT, PNCOUNT, UJSON and TENSOR (the JAX registry's
order). Their device state lives on one torch device, or, in mesh mode,
split over the keys shards of a mesh (parallel/mesh.py):
``mesh="auto"`` shards every plane-backed type over all visible cards
when a host has more than one, as a JAX node does on more than one
device. TENSOR has no mesh mode in either package: it stays on the
mesh's first device.

``converge`` / ``converge_async`` take one type's anti-entropy delta
batch — the entry the cluster calls.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import resolve_mesh
from .help import DATATYPE_HELP, respond_help
from .manager import RepoManager
from .repo_counters import RepoGCOUNT, RepoPNCOUNT
from .repo_tensor import RepoTENSOR
from .repo_tlog import RepoTLOG
from .repo_treg import RepoTREG
from .repo_ujson import RepoUJSON

# the served types TREG, TLOG, GCOUNT, PNCOUNT, UJSON and TENSOR, in the
# JAX package's registry order (jylis_tpu/models/database.py:55-64; it is
# wire-positional there); MAP and BCOUNT follow with their slice
DATA_REPO_CLASSES = (
    RepoTREG, RepoTLOG, RepoGCOUNT, RepoPNCOUNT, RepoUJSON, RepoTENSOR,
)
SERVED_TYPES = tuple(cls.name for cls in DATA_REPO_CLASSES)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and
    there is none, rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


class Database:
    def __init__(self, identity: int, device="cuda", mesh="auto"):
        self.device = resolve_device(device)
        # JAX's Database takes no mesh: JAX picks its devices process-wide;
        # the explicit argument is the torch counterpart of that hook
        self.mesh = resolve_mesh(mesh, self.device)
        self._map: dict[bytes, RepoManager] = {}
        for cls in DATA_REPO_CLASSES:
            if cls is RepoTENSOR:
                dev = self.device if self.mesh is None else self.mesh.keys_devices[0]
                repo = cls(identity, device=dev)
            else:
                repo = cls(identity, device=self.device, mesh=self.mesh)
            self._map[repo.name.encode()] = RepoManager(repo.name, repo, repo.help)

    def manager(self, name: str) -> RepoManager:
        return self._map[name.encode()]

    def apply(self, resp, cmd: list[bytes]) -> None:
        mgr = self._map.get(cmd[0]) if cmd else None
        if mgr is None:
            respond_help(resp, DATATYPE_HELP)
            return
        mgr.apply(resp, cmd)

    async def apply_async(self, resp, cmd: list[bytes]) -> None:
        """Serving path: per-repo locking + threaded drains (manager.py)."""
        mgr = self._map.get(cmd[0]) if cmd else None
        if mgr is None:
            respond_help(resp, DATATYPE_HELP)
            return
        await mgr.apply_async(resp, cmd)

    def converge(self, name: str, batch) -> None:
        """Join one type's delta batch [(key: bytes, delta), ...]
        (single-threaded callers)."""
        mgr = self._map.get(name.encode())
        if mgr is not None:
            mgr.converge_deltas(batch)

    async def converge_async(self, name: str, batch) -> None:
        """``converge`` under the repo lock, for the serving loop."""
        mgr = self._map.get(name.encode())
        if mgr is not None:
            await mgr.converge_async(batch)

    def flush_deltas(self, fn) -> None:
        for mgr in self._map.values():
            mgr.flush_deltas(fn)

    def stop_intake(self) -> None:
        """Reject new commands immediately (safe from a signal callback)."""
        for mgr in self._map.values():
            mgr._shutdown = True

    async def clean_shutdown_async(self) -> None:
        for mgr in self._map.values():
            await mgr.clean_shutdown_async()
