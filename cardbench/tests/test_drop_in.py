"""A data type the harness has no module for comes in as new files only:
the type modules copied to a directory of the test's own, a GCOUNT
module written beside them (a PNCOUNT stream with its p plane only) and
a configuration file, run whole on the CPU through ``run.make_cell`` and
``run.run_cell`` with the loader pointed at that directory. The run
comes out correct, and with its drains broken, not correct."""

from __future__ import annotations

import functools
import json
import shutil
from pathlib import Path

import pytest

from cardbench import run, types
from cardbench.tests.cells import E2E
from jylis_tpu_torch.ops import gcount

PKG = Path(__file__).resolve().parents[1]
KEYS = 4096

GCOUNT_MODULE = '''
"""GCOUNT: a peer's delta is its column, {rid: p} per key, raised every
cycle as PNCOUNT's p column is; a GET is the wrapping u64 row sum."""

import numpy as np

from cardbench.reference.pncount import PNCount
from cardbench.traffic import wire
from cardbench.types import _counters, pncount

NARROW = np.uint32
DRAIN_AT_CLOSE = _counters.DRAIN_AT_CLOSE
DRAIN_KERNELS = _counters.DRAIN_KERNELS


class Stream(pncount.Stream):
    def deltas(self, j, keys=None):
        return pncount.Stream.deltas(self, j, keys)[:1]

    def encode(self, key_rows, p):
        rid_col = np.frombuffer(wire.varint(1) + wire.varint(self.rid), np.uint8)
        return wire.push("GCOUNT", [wire.key_column(key_rows), rid_col, wire.leb128_fixed(p, 10)])


def reference(cfg, narrow=False):
    return PNCount(cfg["keys"], NARROW if narrow else np.uint64)


def join(ref, stream, keys, deltas):
    ref.join(keys, stream.rid, deltas[0], np.zeros(len(keys), np.uint64))


def values(ref):
    return ref.values().view(ref.dtype).astype(np.uint64)


def readback(node, resp, cfg, keys, seed):
    return {"gets": _counters.read_gets(resp, cfg, keys, np.uint64)}


def control_state(cfg, ref):
    return {"gets": (values(ref), 0)}


def compare(cfg, ref, state):
    return _counters.compare_values(*state["gets"], values(ref))


def drain_bytes_per_key(cfg):
    return _counters.bytes_per_key(1, cfg["replicas"])
'''


@pytest.fixture
def gcount_cell(tmp_path):
    shutil.copytree(types.DIR, tmp_path / "types", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "types" / "gcount.py").write_text(GCOUNT_MODULE)
    cfg = json.loads((PKG / "configs" / "pncount-100k-r8.json").read_text())
    cfg.update(name="gcount-4k-r8", type="GCOUNT", keys=KEYS, key_format="gc%06d")
    (tmp_path / "gcount.json").write_text(json.dumps(cfg))
    cell = run.make_cell("gc4k-r8.sweep-batch", 1, tmp_path / "gcount.json", "sweep-batch",
                         E2E, [], types_dir=tmp_path / "types")
    cell["traffic"]["warmup_s"] = 1
    return cell


def test_the_harness_has_no_module_of_its_own_for_the_type():
    with pytest.raises(ValueError):
        types.load("GCOUNT")


def _unchanged(orig):
    def step(t, ki, d, out=None):
        d.zero_()
        return orig(t, ki, d, out)
    return functools.update_wrapper(step, orig)


@pytest.mark.parametrize("broken", [False, True])
def test_a_new_type_runs_whole_from_new_files(monkeypatch, gcount_cell, broken):
    if broken:
        for name in ("drain_sparse", "drain_dense"):
            monkeypatch.setattr(gcount, name, _unchanged(getattr(gcount, name)))
    out = run.run_cell(gcount_cell, 2**31 + 13, 2.0, False, device="cpu")
    result = out["result"]
    assert not out["loaded"]
    assert list(result["checks"]) == ["wrong_values", "unread_keys"]
    assert result["correct"] is not broken, result["checks"]
    assert out["record"]["merges"] > 0
    if broken:
        assert result["checks"]["wrong_values"]["value"] > KEYS // 2
