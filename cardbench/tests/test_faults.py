"""Whole runs of each cell on the CPU at a small size (the node with
``--device cpu``, its drains on the plain versions of the kernels), past
the harness's look for a card: a sound run comes out correct, and a run
with the timed path broken underneath comes out not correct, once for
each fault a one-card cell can have:

* "unchanged": every drain step returns its state unchanged (its deltas
  joined as nothing);
* "half": every drain step joins the first half of its batch and leaves
  the rest out, its answers zero;
* "altered": every drain step alters one answer where it is produced
  (the first slot's value out, or the first slot's register written).

The exchange between cards has no place on one card.
"""

from __future__ import annotations

import contextlib
import functools

import pytest

from cardbench import run
from cardbench.tests.cells import SMALL, small_cell
from jylis_tpu_torch.ops import pncount, treg


def _state_of(table_or_plan):
    return table_or_plan.state if hasattr(table_or_plan, "state") else table_or_plan.parts[0]


def _pn_step(orig, kind):
    def step(t, ki, dp, dn, out):
        if kind == "unchanged":
            dp.zero_()
            dn.zero_()
        if kind == "half":
            h = ki.shape[0] // 2
            out[h:] = 0
            return orig(t, ki[:h], dp[:h], dn[:h], out[:h])
        res = orig(t, ki, dp, dn, out)
        if kind == "altered":
            out[0] += 1
        return res
    return step


def _treg_step(orig, kind):
    def step(t, ki, ts, rank, vid, out):
        if kind == "unchanged":
            ts.zero_()
            rank.zero_()
            vid.fill_(-1)
        if kind == "half":
            h = ki.shape[0] // 2
            for o in out:
                o[h:] = 0
            return orig(t, ki[:h], ts[:h], rank[:h], vid[:h], tuple(o[:h] for o in out))
        res = orig(t, ki, ts, rank, vid, out)
        if kind == "altered":
            _state_of(t).ts[ki[0].long()] += 1
        return res
    return step


@contextlib.contextmanager
def fault(monkeypatch, kind):
    if kind is not None:
        for mod, wrap in ((pncount, _pn_step), (treg, _treg_step)):
            for name in ("drain_sparse", "drain_dense"):
                orig = getattr(mod, name)
                # keeps the launch counters the node reads off the function
                monkeypatch.setattr(mod, name, functools.update_wrapper(wrap(orig, kind), orig))
    yield


# the numbers each cell compares, in the order a run prints them
CHECKS = {
    "pn100k-r8.sweep-read": ["wrong_values", "unread_keys", "error_replies", "lost_replies"],
    "pn100k-r8.sweep-batch": ["wrong_values", "unread_keys"],
    "treg1m.sweep": ["wrong_registers", "wrong_gets", "unread_keys"],
}


def small_run(name: str, seed: int) -> dict:
    return run.run_cell(small_cell(name), seed, 2.0, False, device="cpu")


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("kind", [None, "unchanged", "half", "altered"])
def test_a_broken_drain_comes_out_not_correct(monkeypatch, name, kind):
    with fault(monkeypatch, kind):
        out = small_run(name, 2**31 + 11)
    result = out["result"]
    assert not out["loaded"]
    assert result["correct"] is (kind is None), result["checks"]
    assert list(result["checks"]) == CHECKS[name]
    if kind is None:
        assert out["record"]["merges"] > 0 and result["metrics"]["setup_s"]["value"] > 0
    else:
        assert any(c["value"] > c["limit"] for c in result["checks"].values())
