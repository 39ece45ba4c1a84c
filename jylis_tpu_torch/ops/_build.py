"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface,
``build/jylis_tpu_torch/lib<name>.so`` at the root of the checkout, and
is loaded with ``ctypes``. A library is rebuilt only when its source, or
a header beside it, is newer than it. Nothing here runs at import time:
the first call to a kernel builds what it needs, and ``build()`` builds
every kernel at once, one ``nvcc`` process per source, all started
together.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a nonzero code into an exception, so a refused launch
never passes silently. Each wrapper then calls ``count``: its
``.launches`` and its per-card tally ``.by_card`` (card index ->
launches) grow together, so on a node keys-sharded over several cards
the tally shows which cards ran the kernel; ``reset`` sets both to 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jylis_tpu_torch"
SOURCES = (
    "counter_drain_dense", "counter_drain_sparse", "tensor_join_dense",
    "treg_drain", "tensor_converge_batch", "tlog_drain", "ujson_join",
    "ujson_fold_flat", "replica_join",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build on the "
            "machine with the GPU"
        )
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not out.exists():
        return True
    newest = max(
        p.stat().st_mtime
        for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    )
    return newest > out.stat().st_mtime


def build(names=SOURCES) -> dict[str, float]:
    """Compile every stale library in ``names`` in parallel; returns the
    wall seconds of each compile that ran. Raises with nvcc's output if
    any compile fails. Each library is written under a temporary name
    and renamed into place, so a concurrent loader never sees half a
    file."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            ),
            tmp,
        )
    seconds, failed = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{out.decode()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def function(name: str, entry: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``entry`` of library ``name`` (built if stale), with
    its argument types declared so pointers pass as 64-bit values."""
    fn = _fns.get((name, entry))
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, entry)] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")


def counter(fn, classes: bool = False):
    """Give kernel wrapper ``fn`` its launch counts: ``.launches``, the
    per-card ``.by_card`` and, with ``classes``, ``.classes`` (launches
    by the class ops/row_plan.py picked)."""
    fn.launches, fn.by_card = 0, {}
    if classes:
        fn.classes = {}
    return fn


def count(fn, device, kind: str | None = None) -> None:
    """One launch of wrapper ``fn`` on CUDA ``device`` (a torch.device
    with an index, or an int): ``.launches``, ``.by_card`` and, given
    ``kind``, ``.classes`` each gain one."""
    card = device if isinstance(device, int) else device.index
    fn.launches += 1
    fn.by_card[card] = fn.by_card.get(card, 0) + 1
    if kind is not None:
        fn.classes[kind] = fn.classes.get(kind, 0) + 1


def reset(*fns) -> None:
    """Set the launch counts of every wrapper in ``fns`` to 0."""
    for fn in fns:
        fn.launches = 0
        fn.by_card.clear()
        if hasattr(fn, "classes"):
            fn.classes.clear()
