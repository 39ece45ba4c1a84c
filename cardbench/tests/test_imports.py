"""Nothing under cardbench/ imports JAX or the JAX package, and the
references import nothing of the program either. Top-level names are
compared whole: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "jylis_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not top_level_imports(path) & (NEVER | {"jylis_tpu_torch", "torch"})


def test_the_traffic_imports_nothing_of_the_program():
    for path in (PKG / "traffic").rglob("*.py"):
        assert "jylis_tpu_torch" not in top_level_imports(path), path
