"""Keep the JAX reference of the port's parity tests on its Python paths.

The JAX package builds its native library with g++ straight into
``native/libjylis_native.so``, with no lock and no write-then-rename,
and ``jylis_tpu.native.lib()`` memoises a failed load. Under tier-1's
parallel workers a port test module that reaches that build can race a
JAX test module building the same file, and one of them then runs
without the library for the rest of its life. The port's parity tests
compare against the JAX package's Python paths (its codec's oracle, its
Python RESP parser, its Python tables, the resident store's Python grid
encode), which the JAX package's own tests hold equal to its native
ones, so they need no JAX native build at all.

Each port test module that imports the JAX package imports
``jax_python_paths``: an autouse fixture in a module's namespace applies
to that module, and patches ``lib`` to None in every JAX module that
loads the library, for the module's duration.
"""

import pytest

_JAX_NATIVE_MODULES = (
    "jylis_tpu.native",
    "jylis_tpu.native.codec",
    "jylis_tpu.native.engine",
    "jylis_tpu.native.resp",
)


@pytest.fixture(scope="module", autouse=True)
def jax_python_paths():
    import importlib

    patch = pytest.MonkeyPatch()
    for name in _JAX_NATIVE_MODULES:
        patch.setattr(importlib.import_module(name), "lib", lambda: None)
    yield
    patch.undo()
