"""The lower-precision control (control.py) comes out not correct in every
cell, at a size a test run holds, while the reference in its own place
comes out correct."""

from __future__ import annotations

import pytest

from cardbench import control
from cardbench.tests.cells import SMALL, small_cell


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("seed", [7, 2**31 + 3, 2**33 + 1])
def test_the_narrow_reference_fails_the_comparison(name, seed):
    cell = small_cell(name)
    out = control.run_control(cell, seed, frames_past_fill=6)
    assert out["reference_correct"]
    assert not out["control_correct"]
    assert max(c["value"] for c in out["checks"].values()) > SMALL[name] // 10
    # every key's value (every register) reads wrong
    wrong = "wrong_registers" if "wrong_registers" in out["checks"] else "wrong_values"
    assert out["checks"][wrong]["value"] == SMALL[name]
