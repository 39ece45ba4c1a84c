"""P2Set: two-phase set lattice (host-side).

The port's copy of jylis_tpu/ops/p2set.py, whole.

Used solely for cluster membership (reference: cluster.pony:14 keeps
known addresses in a P2Set so that a removed element can never re-appear —
that permanence is what makes stale-name blacklisting work,
cluster.pony:215-230). Data volume is a handful of addresses, so this
lattice stays on host; it is part of the CRDT inventory (SURVEY.md
section 2.9) nonetheless.

Join: adds = adds_a | adds_b; removes = removes_a | removes_b; membership =
adds - removes. Once removed, an element is permanently dead.
"""

from __future__ import annotations

from typing import Generic, Hashable, Iterator, TypeVar

T = TypeVar("T", bound=Hashable)


class P2Set(Generic[T]):
    __slots__ = ("adds", "removes")

    def __init__(self, initial=()):
        self.adds: set[T] = set(initial)
        self.removes: set[T] = set()

    def add(self, item: T) -> bool:
        """Returns False if the item is tombstoned (can never re-join)."""
        self.adds.add(item)
        return item not in self.removes

    def unset(self, item: T) -> None:
        """Permanent removal (tombstone)."""
        self.adds.add(item)
        self.removes.add(item)

    def __contains__(self, item: T) -> bool:
        return item in self.adds and item not in self.removes

    def __iter__(self) -> Iterator[T]:
        return iter(self.adds - self.removes)

    def __len__(self) -> int:
        return len(self.adds - self.removes)

    def converge(self, other: "P2Set[T]") -> bool:
        before = (len(self.adds), len(self.removes))
        self.adds |= other.adds
        self.removes |= other.removes
        return (len(self.adds), len(self.removes)) != before

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, P2Set)
            and self.adds == other.adds
            and self.removes == other.removes
        )

    # mutable lattice: deliberately unhashable (messages carrying one are
    # compared by value, never used as dict/set keys)
    __hash__ = None

    def copy(self) -> "P2Set[T]":
        out = P2Set()
        out.adds = set(self.adds)
        out.removes = set(self.removes)
        return out
