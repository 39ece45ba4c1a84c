"""Pure-Python reference lattices: the TLog the SYSTEM log keeps.

The port's copy of the ``TLog`` of jylis_tpu/ops/hostref.py (:104-158),
unchanged in behaviour. The SYSTEM repo (models/repo_system.py) keeps
its tiny single-key log in it, on the host: a device round-trip per log
line would be absurd. The other reference lattices of that module are
test oracles and are not copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TLog:
    """Timestamp-sorted log with grow-only cutoff.

    Entries are (value: bytes, ts: u64), sorted ts desc then value desc;
    duplicates (equal ts AND value) are dropped; entries with ts < cutoff
    are dropped; cutoffs merge by max (tlog.md:116-133).
    """

    entries: list[tuple[bytes, int]] = field(default_factory=list)
    cutoff: int = 0

    def insert(self, value: bytes, ts: int) -> bool:
        if ts < self.cutoff or (value, ts) in self.entries:
            return False
        self.entries.append((value, ts))
        self.entries.sort(key=lambda e: (e[1], e[0]), reverse=True)
        return True

    def size(self) -> int:
        return len(self.entries)

    def latest(self, count: int | None = None) -> list[tuple[bytes, int]]:
        return self.entries if count is None else self.entries[:count]

    def trim(self, count: int) -> None:
        """Raise cutoff to ts of entry at index count-1 (tlog.md:54-60);
        count 0 behaves like clear; negative counts are a no-op (the
        reference parses count as unsigned)."""
        if count == 0:
            self.clear()
        elif 0 < count <= len(self.entries):
            self.raise_cutoff(self.entries[count - 1][1])

    def raise_cutoff(self, ts: int) -> None:
        if ts > self.cutoff:
            self.cutoff = ts
            self.entries = [e for e in self.entries if e[1] >= self.cutoff]

    def clear(self) -> None:
        """Cutoff = latest ts + 1; no-op on an empty log (tlog.md:62-66)."""
        if self.entries:
            self.raise_cutoff(self.entries[0][1] + 1)

    def converge(self, other: "TLog") -> bool:
        before = (len(self.entries), self.cutoff)
        merged = set(self.entries) | set(other.entries)
        self.cutoff = max(self.cutoff, other.cutoff)
        self.entries = sorted(
            (e for e in merged if e[1] >= self.cutoff),
            key=lambda e: (e[1], e[0]),
            reverse=True,
        )
        return (len(self.entries), self.cutoff) != before
