"""Median send-to-Pong time of the peers' frames in the window: the
cluster read loop, the codec and the manager's converge as a peer
meets them."""

from cardbench.metrics._common import percentile


def read(record: dict) -> float | None:
    return percentile(record["push_ack_ms"], 50)
