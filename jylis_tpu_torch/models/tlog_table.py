"""Host state of the TLOG repo: the pure-Python table.

The port's copies of jylis_tpu/models/tlog_table.py's two tables:
``PyTlogTable`` (pure-Python, the oracle, ``engine="python"``) and
``NativeTlogTable`` (a view over the native serving engine's TLOG table:
the same state the server's burst applier mutates). They keep TLOG's
host bookkeeping: key interning, the per-row pending window,
length/cutoff caches, the merged-view memo that serves SIZE/GET without
device reads, and the outbound delta accumulators.

Semantics mirror repo_tlog.pony:16-111 via docs tlog.md: entries dedup on
(ts, value), cutoffs are grow-only and filter the view, TRIM/CLR raise
cutoffs. The merged view (drained ∪ pending, deduped, cutoff-filtered) is
memoised per row; the drained "base" CARRIES ACROSS drains — when the
memo is current at drain time, the post-drain row content equals the memo
filtered by the returned cutoff (the device performs the same lattice
join), so reads keep serving host-side without a device gather. A length
mismatch at that handoff invalidates the base (``size`` then returns -1
and the repo rebuilds it from one device row gather via ``set_base``).
"""

from __future__ import annotations


# drain thresholds; native/src/engine.h TlogTable must match
ROW_DRAIN_THRESHOLD = 1024
PENDING_DRAIN_THRESHOLD = 4096


class _Row:
    __slots__ = (
        "pend", "pend_cutoff", "len_cache", "cut_cache", "base", "base_valid",
        "memo", "memo_valid", "memo_plen", "memo_cut", "gen",
        "delta", "delta_cutoff", "delta_present", "touched",
    )

    def __init__(self):
        self.pend: list[tuple[int, bytes]] = []
        self.pend_cutoff = 0
        self.touched = False
        self.len_cache = 0
        self.cut_cache = 0
        self.base: list[tuple[int, bytes]] = []
        self.base_valid = True  # new rows have an empty drained part
        self.memo: set[tuple[int, bytes]] = set()
        self.memo_valid = False
        self.memo_plen = 0
        self.memo_cut = 0
        self.gen = 0
        self.delta: set[tuple[int, bytes]] = set()
        self.delta_cutoff = 0
        self.delta_present = False


class PyTlogTable:
    __slots__ = (
        "_keys", "_rkeys", "_rows", "_pend_rows_count", "_row_overdue",
        "_delta_rows", "_touched", "_live_total", "_sync_dirty",
    )

    def __init__(self):
        self._keys: dict[bytes, int] = {}
        self._rkeys: list[bytes] = []
        self._rows: list[_Row] = []
        self._pend_rows_count = 0
        self._row_overdue = False
        self._delta_rows: list[int] = []
        self._touched: list[int] = []  # rows with pend or pend_cutoff
        self._live_total = 0  # sum of len_cache over all rows
        self._sync_dirty: dict[int, None] = {}  # since last digest pass

    # -- keys ---------------------------------------------------------------

    def rows(self) -> int:
        return len(self._rkeys)

    def upsert(self, key: bytes) -> int:
        row = self._keys.get(key)
        if row is None:
            row = len(self._rkeys)
            self._keys[key] = row
            self._rkeys.append(key)
            self._rows.append(_Row())
        return row

    def find(self, key: bytes) -> int:
        return self._keys.get(key, -1)

    def key_of(self, row: int) -> bytes:
        return self._rkeys[row]

    # -- view math ------------------------------------------------------------

    def cutoff_view(self, row: int) -> int:
        r = self._rows[row]
        return max(r.pend_cutoff, r.cut_cache)

    def quiescent(self, row: int) -> bool:
        r = self._rows[row]
        return not r.pend and r.pend_cutoff <= r.cut_cache

    def _memo_current(self, r: _Row) -> bool:
        return (
            r.memo_valid
            and r.memo_plen == len(r.pend)
            and r.memo_cut == max(r.pend_cutoff, r.cut_cache)
        )

    def _touch(self, r: _Row, row: int) -> None:
        if not r.touched:
            r.touched = True
            self._touched.append(row)
        self._sync_dirty[row] = None

    def _append_pend(self, r: _Row, row: int, e: tuple[int, bytes]) -> None:
        if not r.pend:
            self._pend_rows_count += 1
        r.pend.append(e)
        self._touch(r, row)
        if len(r.pend) >= ROW_DRAIN_THRESHOLD:
            self._row_overdue = True

    # -- mutations ------------------------------------------------------------

    def ins(self, row: int, ts: int, value: bytes) -> None:
        r = self._rows[row]
        e = (ts, value)
        self._append_pend(r, row, e)
        r.gen += 1
        if r.memo_valid:
            cut = max(r.pend_cutoff, r.cut_cache)
            if r.memo_plen != len(r.pend) - 1 or r.memo_cut != cut:
                r.memo_valid = False
                r.memo = set()  # free, don't retain dead sets
            else:
                if ts >= cut:
                    r.memo.add(e)
                r.memo_plen = len(r.pend)
                r.memo_cut = cut
        if ts >= r.cut_cache:
            if not r.delta_present:
                r.delta_present = True
                self._delta_rows.append(row)
            if ts >= r.delta_cutoff:
                r.delta.add(e)

    def converge_entry(self, row: int, ts: int, value: bytes) -> None:
        r = self._rows[row]
        self._append_pend(r, row, (ts, value))
        r.gen += 1

    def converge_cutoff(self, row: int, c: int) -> None:
        r = self._rows[row]
        if c > r.pend_cutoff:
            r.pend_cutoff = c
            self._touch(r, row)
            r.gen += 1

    # -- the merged serving view ----------------------------------------------

    def size(self, row: int) -> int:
        r = self._rows[row]
        if self.quiescent(row):
            return r.len_cache
        if self._memo_current(r):
            return len(r.memo)
        if not r.base_valid:
            return -1
        cut = max(r.pend_cutoff, r.cut_cache)
        r.memo = {e for e in r.base if e[0] >= cut}
        r.memo.update(e for e in r.pend if e[0] >= cut)
        r.memo_valid = True
        r.memo_plen = len(r.pend)
        r.memo_cut = cut
        r.gen += 1
        return len(r.memo)

    def merged_entries(self, row: int):
        r = self._rows[row]
        if self._memo_current(r):
            return list(r.memo)
        if self.quiescent(row) and r.base_valid:
            return list(r.base)
        return None

    def base_entries(self, row: int):
        """The drained row content when the carried base is valid; None
        when the repo must gather it from the device."""
        r = self._rows[row]
        return list(r.base) if r.base_valid else None

    def base_valid(self, row: int) -> bool:
        return self._rows[row].base_valid

    def live_total(self) -> int:
        return self._live_total

    def export_sync_dirty(self) -> list[int]:
        rows = list(self._sync_dirty)
        self._sync_dirty.clear()
        return rows

    def compact_values(self) -> bool:
        return False  # raw bytes, freed with their entries: nothing interned

    def set_base(self, row: int, entries) -> None:
        r = self._rows[row]
        r.base = list(entries)
        r.base_valid = True
        r.memo_valid = False
        r.memo = set()
        r.gen += 1

    # -- drain plumbing -------------------------------------------------------

    def len_cache(self, row: int) -> int:
        return self._rows[row].len_cache

    def cut_cache(self, row: int) -> int:
        return self._rows[row].cut_cache

    def pend_cutoff(self, row: int) -> int:
        return self._rows[row].pend_cutoff

    def gen(self, row: int) -> int:
        return self._rows[row].gen

    def pend_len(self, row: int) -> int:
        return len(self._rows[row].pend)

    def pend_rows_count(self) -> int:
        return self._pend_rows_count

    def row_overdue(self) -> bool:
        return self._row_overdue

    def touched_rows(self) -> list[int]:
        return list(self._touched)

    def touched_count(self) -> int:
        return len(self._touched)

    def export_pend(self, row: int) -> list[tuple[int, bytes]]:
        return list(self._rows[row].pend)

    def export_pend_bulk(self, rows: list[int]):
        return {r: list(self._rows[r].pend) for r in rows}

    def finish_row(self, row: int, length: int, cut: int) -> None:
        r = self._rows[row]
        if self._memo_current(r):
            r.base = [e for e in r.memo if e[0] >= cut]
            r.base_valid = len(r.base) == length
        else:
            r.base = []
            r.base_valid = length == 0
        self._sync_dirty[row] = None  # a fused trim can change the view
        self._live_total += int(length) - r.len_cache
        r.len_cache = int(length)
        r.cut_cache = int(cut)
        if r.pend:
            self._pend_rows_count -= 1
        r.pend = []
        r.pend_cutoff = 0
        if r.base_valid:
            r.memo = set(r.base)
            r.memo_valid = True
            r.memo_plen = 0
            r.memo_cut = max(r.pend_cutoff, r.cut_cache)
        else:
            r.memo_valid = False
            r.memo = set()
        r.gen += 1

    def finish_drain_end(self) -> None:
        for row in self._touched:
            r = self._rows[row]
            r.touched = False
            if r.pend:  # touched but outside the drain set: cannot happen
                r.pend = []  # under the repo lock; mirror the global clear
                r.memo_valid = False
                r.gen += 1
            r.pend_cutoff = 0
        self._touched.clear()
        self._pend_rows_count = 0
        self._row_overdue = False

    # -- outbound deltas ------------------------------------------------------

    def deltas_size(self) -> int:
        return len(self._delta_rows)

    def delta_raise_cutoff(self, row: int, c: int) -> None:
        r = self._rows[row]
        if not r.delta_present:
            r.delta_present = True
            self._delta_rows.append(row)
        if c > r.delta_cutoff:
            r.delta_cutoff = c
            r.delta = {e for e in r.delta if e[0] >= c}

    def flush_deltas(self):
        out = []
        for row in self._delta_rows:
            r = self._rows[row]
            ents = sorted(r.delta, reverse=True)
            out.append(
                (
                    self._rkeys[row],
                    ([(v, t) for t, v in ents], r.delta_cutoff),
                )
            )
            r.delta = set()
            r.delta_cutoff = 0
            r.delta_present = False
        self._delta_rows.clear()
        out.sort()
        return out


class NativeTlogTable:
    """The TLOG view over a shared native serving engine."""

    __slots__ = ("_eng",)

    def __init__(self, engine):
        self._eng = engine

    def rows(self) -> int:
        return self._eng.tlog_rows()

    def upsert(self, key: bytes) -> int:
        return self._eng.tlog_upsert(key)

    def find(self, key: bytes) -> int:
        return self._eng.tlog_find(key)

    def key_of(self, row: int) -> bytes:
        return self._eng.tlog_key_of(row)

    def cutoff_view(self, row: int) -> int:
        return self._eng.tlog_cutoff_view(row)

    def quiescent(self, row: int) -> bool:
        return self._eng.tlog_quiescent(row)

    def ins(self, row: int, ts: int, value: bytes) -> None:
        self._eng.tlog_ins(row, ts, value)

    def converge_entry(self, row: int, ts: int, value: bytes) -> None:
        self._eng.tlog_conv_entry(row, ts, value)

    def converge_cutoff(self, row: int, c: int) -> None:
        self._eng.tlog_conv_cutoff(row, c)

    def size(self, row: int) -> int:
        return self._eng.tlog_size(row)

    def merged_entries(self, row: int):
        return self._eng.tlog_merged_entries(row)

    def base_entries(self, row: int):
        return self._eng.tlog_base_entries(row)

    def base_valid(self, row: int) -> bool:
        return self._eng.tlog_base_valid(row)

    def live_total(self) -> int:
        return self._eng.tlog_live_total()

    def export_sync_dirty(self) -> list[int]:
        return self._eng.tlog_export_sync_dirty()

    def compact_values(self) -> bool:
        return self._eng.tlog_compact()

    def set_base(self, row: int, entries) -> None:
        self._eng.tlog_set_base(row, entries)

    def len_cache(self, row: int) -> int:
        return self._eng.tlog_len_cache(row)

    def cut_cache(self, row: int) -> int:
        return self._eng.tlog_cut_cache(row)

    def pend_cutoff(self, row: int) -> int:
        return self._eng.tlog_pend_cutoff(row)

    def gen(self, row: int) -> int:
        return self._eng.tlog_gen(row)

    def pend_len(self, row: int) -> int:
        return self._eng.tlog_pend_len(row)

    def pend_rows_count(self) -> int:
        return self._eng.tlog_pend_rows_count()

    def row_overdue(self) -> bool:
        return self._eng.tlog_row_overdue()

    def touched_rows(self) -> list[int]:
        return self._eng.tlog_touched_rows()

    def touched_count(self) -> int:
        return self._eng.tlog_touched_count()

    def export_pend(self, row: int) -> list[tuple[int, bytes]]:
        return self._eng.tlog_export_pend(row)

    def export_pend_bulk(self, rows: list[int]):
        return self._eng.tlog_export_pend_bulk(rows)

    def finish_row(self, row: int, length: int, cut: int) -> None:
        self._eng.tlog_finish_row(row, int(length), int(cut))

    def finish_drain_end(self) -> None:
        self._eng.tlog_finish_end()

    def deltas_size(self) -> int:
        return self._eng.tlog_deltas_size()

    def delta_raise_cutoff(self, row: int, c: int) -> None:
        self._eng.tlog_delta_raise_cutoff(row, c)

    def flush_deltas(self):
        return self._eng.tlog_flush_deltas()
