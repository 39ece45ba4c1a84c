"""No harness file outside types/ and reference/ names a data type in a
string: what depends on the type lives in its module (types/<type>.py),
so the next type's cell is new files only. The wire's frozen copy of the
cluster schema (``SCHEMA_TEXT``, whose hash is the handshake signature)
names every type and is left out."""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
TYPE_NAMES = ("TREG", "TLOG", "GCOUNT", "PNCOUNT", "UJSON", "TENSOR", "MAP", "BCOUNT")
NAMED = re.compile(r"\b(" + "|".join(TYPE_NAMES) + r")\b")
OWN = ("types", "reference", "tests")
EXEMPT = {"SCHEMA_TEXT"}

HARNESS = sorted(p for p in PKG.rglob("*.py") if p.relative_to(PKG).parts[0] not in OWN)


def named_types(source: str) -> list[tuple[int, str]]:
    """(line, text) of every string constant that names a data type,
    outside the assignments to an ``EXEMPT`` name."""
    tree = ast.parse(source)
    skip = {id(n) for a in ast.walk(tree) if isinstance(a, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id in EXEMPT for t in a.targets)
            for n in ast.walk(a.value)}
    return [(n.lineno, n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in skip and NAMED.search(n.value)]


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(PKG)))
def test_no_data_type_is_named_outside_its_module(path):
    assert named_types(path.read_text()) == []


def test_the_guard_sees_literals_docstrings_and_f_strings():
    src = 'x = "PNCOUNT"\ndef f():\n    """the TLOG drain"""\n    return f"{x} MAP"\n'
    assert [line for line, _ in named_types(src)] == [1, 3, 4]
    assert named_types('SCHEMA_TEXT = "delta/TREG=(value ts)"\ny = "MAPPING TREGS"\n') == []


def test_the_scan_covers_the_files_that_must_stay_type_free():
    names = {str(p.relative_to(PKG)) for p in HARNESS}
    assert {"run.py", "judge.py", "control.py", "traffic/gen.py", "traffic/peer.py",
            "traffic/wire.py", "roofline/drains.py", "metrics/drain_roofline_pct.py"} <= names
