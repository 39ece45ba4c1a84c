"""The native (C++) host layer, loaded with ctypes: the RESP scanner, the
serving engine and the cluster wire codec.

The port's copy of jylis_tpu/native/__init__.py. The C++ sources are the
port's own copy under ``src/`` (the JAX package's ``native/*.cpp`` and
``engine.h``, byte for byte when copied), built with
``g++ -O2 -std=c++17 -shared -fPIC`` into
``build/jylis_tpu_torch/libjylis_native.so`` at the root of the checkout
on first use. The library is rebuilt only when a source is newer than
it. A build writes a temporary file and renames it into place, under a
file lock, so concurrent processes never load half a file and build it
once between them.

There is no quiet fallback: where the JAX package's ``lib()`` returns
None and its callers go Python, the port's ``lib()`` raises with the
compiler's output when the build or the load fails. The pure-Python
tables and codec are the oracles, chosen explicitly (``engine="python"``,
``codec.encode(msg, native=False)``), never by the library's absence.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jylis_tpu_torch"
SO_NAME = "libjylis_native.so"
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build or load did: the library's path, the build's wall
# seconds (0.0 when the library was fresh) and the compiler's version
info: dict = {}


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cpp"))


def so_path(build_dir: Path = BUILD_DIR) -> Path:
    return Path(build_dir) / SO_NAME


def _stale(out: Path) -> bool:
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in [*sources(), SRC_DIR / "engine.h"])
    return newest > out.stat().st_mtime


def compiler_version(cxx: str = CXX) -> str:
    try:
        proc = subprocess.run([cxx, "--version"], capture_output=True, timeout=30)
    except OSError as e:
        return f"{cxx}: {e}"
    return proc.stdout.decode(errors="replace").splitlines()[0] if proc.stdout else cxx


def build(build_dir: Path = BUILD_DIR, cxx: str = CXX) -> float:
    """Build the library into ``build_dir`` when it is missing or stale;
    returns the wall seconds of the build (0.0 when none was needed).
    Raises NativeBuildError with the compiler's output on failure."""
    out = so_path(build_dir)
    if not _stale(out):
        return 0.0
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    with open(Path(build_dir) / f"{SO_NAME}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building
        if not _stale(out):
            return 0.0
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, sources())]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, timeout=600)
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeBuildError(f"native build failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"native build failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                + proc.stderr.decode(errors="replace")
            )
        os.replace(tmp, out)
        return time.perf_counter() - t0


def load(build_dir: Path = BUILD_DIR, cxx: str = CXX) -> ctypes.CDLL:
    """Build when stale, then load a handle on the library with the
    scanner's and the codec's signatures declared (not memoised: ``lib``
    is)."""
    seconds = build(build_dir, cxx)
    path = so_path(build_dir)
    try:
        cdll = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeBuildError(f"native library failed to load: {path}: {e}") from e
    _declare_scanner(cdll)
    _declare_codec(cdll)
    info.update(path=str(path), build_s=seconds, compiler=compiler_version(cxx))
    return cdll


def lib() -> ctypes.CDLL:
    """The port's native library, built and loaded once per process."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = load()
    return _lib


def _declare_scanner(cdll: ctypes.CDLL) -> None:
    """Signatures of the RESP scanner (src/resp_parser.cpp)."""
    c = ctypes
    p64, p32 = c.POINTER(c.c_int64), c.POINTER(c.c_int32)
    cdll.resp_scan.restype = c.c_int32
    cdll.resp_scan.argtypes = [c.c_void_p, c.c_int64, p64, p64, p64, c.c_int32, p32]
    cdll.resp_scan_many.restype = c.c_int32
    cdll.resp_scan_many.argtypes = [
        c.c_void_p, c.c_int64, p64, p32, c.c_int32, p64, p64, c.c_int32, p32,
    ]


def _declare_codec(cdll: ctypes.CDLL) -> None:
    """Signatures of the cluster wire codec (src/cluster_codec.cpp) and
    the UJSON wire paths (src/ujson_planes.cpp)."""
    c = ctypes
    p64 = c.POINTER(c.c_int64)
    vp, cp, i32, i64 = c.c_void_p, c.c_char_p, c.c_int32, c.c_int64
    sigs = {
        # encode: (..., out, cap) -> bytes written or -1
        "jy_push_counters_encode": (
            i64, [cp, i64, i64, cp, vp, vp, i32, vp, vp, vp, vp, i64],
        ),
        "jy_push_treg_encode": (
            i64, [cp, i64, i64, cp, vp, vp, cp, vp, vp, vp, vp, i64],
        ),
        "jy_push_tlog_encode": (
            i64, [cp, i64, i64, cp, vp, vp, vp, cp, vp, vp, vp, vp, vp, i64],
        ),
        # measure/decode: -> 0 ok, -1 malformed, -2 outside the fast path
        "jy_push_counters_measure": (i32, [cp, i64, i32, p64, p64]),
        "jy_push_counters_decode": (i32, [cp, i64, i32, vp, vp, vp, vp, vp]),
        "jy_push_treg_measure": (i32, [cp, i64, p64]),
        "jy_push_treg_decode": (i32, [cp, i64, vp, vp, vp, vp, vp]),
        "jy_push_tlog_measure": (i32, [cp, i64, p64, p64]),
        "jy_push_tlog_decode": (i32, [cp, i64, vp, vp, vp, vp, vp, vp, vp]),
        "jy_push_ujson_encode": (
            i64,
            [cp, i64, i64, cp, vp, vp, vp, vp, vp, vp, cp, vp, vp, vp, vp, vp,
             vp, vp, i64],
        ),
        "jy_ujson_split_measure": (i32, [cp, i64, p64]),
        "jy_ujson_split": (i32, [cp, i64, vp, vp, vp, vp, vp, vp, vp, vp]),
        "jy_ujson_grid_fill": (
            i32,
            [cp, i64, vp, vp, vp, i32, i64, i64, i64, vp, i64, vp, vp, vp, vp,
             vp, p64, vp, vp, p64, p64],
        ),
    }
    for fn_name, (restype, argtypes) in sigs.items():
        fn = getattr(cdll, fn_name)
        fn.restype = restype
        fn.argtypes = argtypes
