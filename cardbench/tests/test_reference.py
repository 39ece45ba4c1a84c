"""The plain references against hand-worked cases."""

from __future__ import annotations

import numpy as np

from cardbench.reference.pncount import PNCount
from cardbench.reference.treg import TReg

U64 = 1 << 64


def test_pncount_joins_by_the_per_replica_max_and_wraps():
    ref = PNCount(3)
    ref.join(np.array([0, 1]), 7, [5, 2**64 - 1], [1, 0])
    ref.join(np.array([0, 1]), 7, [3, 4], [2, 0])  # p 3 < 5 and 4 < 2^64-1 lose
    ref.join(np.array([1, 2]), 9, [1, 10], [0, 11])
    # key 0: p = 5, n = 2 -> 3; key 1: p = (2^64 - 1) + 1 wraps to 0 -> 0;
    # key 2: 10 - 11 = -1
    assert ref.values().tolist() == [3, 0, -1]


def test_pncount_value_reads_the_wrapped_difference_as_signed():
    ref = PNCount(2)
    ref.join(np.array([0, 1]), 1, [2**63, 0], [0, 2**63 + 1])
    # 2^63 as i64 is -2^63; 0 - (2^63 + 1) wraps to 2^63 - 1
    assert ref.values().tolist() == [-(2**63), 2**63 - 1]


def test_pncount_narrow_control_truncates():
    ref = PNCount(1, np.uint32)
    ref.join(np.array([0]), 1, [2**32 + 5], [1])
    assert ref.values().tolist() == [4]


def val(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8).reshape(1, -1)


def test_treg_higher_timestamp_wins_then_larger_value():
    ref = TReg(2, 4)
    ref.join(np.array([0]), val("bbbb"), [5])
    ref.join(np.array([0]), val("zzzz"), [4])  # older: loses
    ref.join(np.array([0]), val("aaaa"), [5])  # same ts, smaller value: loses
    ref.join(np.array([0]), val("bbbc"), [5])  # same ts, larger value: wins
    assert ref.set.tolist() == [True, False]
    assert ref.ts.tolist() == [5, 0]
    assert ref.value[0] == b"bbbc"


def test_treg_compares_timestamps_unsigned_and_narrow_control_truncates():
    ref = TReg(1, 2)
    ref.join(np.array([0]), val("aa"), [2**63])
    ref.join(np.array([0]), val("bb"), [2**62])
    assert ref.value[0] == b"aa"
    narrow = TReg(1, 2, np.uint32)
    narrow.join(np.array([0]), val("aa"), [2**63 + 1])
    narrow.join(np.array([0]), val("bb"), [2**62 + 2])
    assert narrow.value[0] == b"bb"
