"""Session incarnation ids, as the cluster names its delta streams.

The port's copy of ``make_rid`` from jylis_tpu/sessions.py (:86-91);
``rid_addr`` comes with the session index, its one caller. The cluster
stamps each sequenced flush with its origin incarnation (advertised
address + boot epoch) and folds the peers' streams into a session index
when its Database has one (``getattr(database, "sessions", None)``).
The port's Database has none yet: the ``SESSION`` command family and
its ``SessionIndex`` come later, and the cluster works without them.
"""

from __future__ import annotations


def make_rid(addr: str, epoch: int) -> str:
    """One origin incarnation: advertised address + boot epoch. The
    epoch (boot wall-ms through the cluster's injectable clock) is what
    keeps a rebooted origin's restarted seq counter from aliasing its
    previous stream in every peer's vector."""
    return f"{addr}!{epoch}"

