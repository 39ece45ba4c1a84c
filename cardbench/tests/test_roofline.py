"""The drains' byte counts against hand counts at shapes of PERF.md's
kernel table (staged calls, NVIDIA H100 80GB HBM3)."""

from __future__ import annotations

from cardbench import types
from cardbench.roofline.drains import memory_rate
from cardbench.types._counters import bytes_per_key

PNCOUNT = types.load("PNCOUNT")
TREG = types.load("TREG")


def test_counter_drain_bytes_match_the_staged_call_row():
    # counter_drain_sparse<2>, K = 1,048,576, R = 64, B = 65,536: 202.1 MB.
    # Per key: 2 planes x 64 columns x 8 B, read, read and written, + the
    # row index (4) + the sum (8)
    b = 65536
    assert bytes_per_key(2, 64) == 2 * 64 * 8 * 3 + 12
    assert b * PNCOUNT.drain_bytes_per_key({"replicas": 64}) == 202_113_024
    # counter_drain_sparse<1> at the same shape: 101.4 MB
    assert b * bytes_per_key(1, 64) == 101_449_728


def test_treg_drain_bytes_match_the_staged_call_row_less_the_wins():
    # treg_drain_sparse staged, B = 65,536 with 23,577 wins: 4.21 MB
    # counted with the winners' 20-byte writes, which this count leaves out
    b, wins = 65536, 23577
    assert TREG.BYTES_PER_KEY == 4 + 1 + 12 + 20 + 20
    assert b * TREG.drain_bytes_per_key({"replicas": 8}) + wins * 20 == 4_207_092


def test_memory_rate_by_card():
    assert memory_rate("NVIDIA H100 80GB HBM3") == 3.35e12
    assert memory_rate("cpu") is None
