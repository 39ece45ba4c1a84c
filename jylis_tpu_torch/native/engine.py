"""ctypes wrapper for the native serving engine (src/engine.h,
src/counter_engine.cpp and src/serve_engine.cpp).

The port's copy of jylis_tpu/native/engine.py. ``ServeEngine`` owns the
host state every command touches: the GCOUNT/PNCOUNT counter tables, the
TREG winner/pending/delta registers, the TLOG pending/merged-view/delta
logs, the validated UJSON write queue and the UJSON per-(key, path)
render memo. It applies whole pipelined command bursts per FFI call
(``scan_apply``). The pure-Python tables (models/counter_table.py,
models/treg_table.py, models/tlog_table.py) are the oracles, taken with
``engine="python"``; the parity tests hold the two equal.

u64 values cross the boundary as numpy ``uint64`` arrays and come back
as Python ints in [0, 2^64) (``tolist``), never through a signed cast.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import lib

G = 0
PN = 1

_OUT_CAP = 1 << 16
_MAX_ARGS = 1024

# jy_tlog_export_merged's "view unavailable" sentinel (serve_engine.cpp)
_TLOG_UNAVAILABLE = -1 - (1 << 40)


def _declare(c: ctypes.CDLL) -> None:
    ct = ctypes
    vp, i32, i64, u64, u8p = (
        ct.c_void_p, ct.c_int32, ct.c_int64, ct.c_uint64, ct.c_char_p,
    )
    pi64 = ct.POINTER(ct.c_int64)
    pi32 = ct.POINTER(ct.c_int32)
    pvp = ct.POINTER(ct.c_void_p)
    pu64 = ct.POINTER(ct.c_uint64)
    sigs = {
        "jy_eng_new": (vp, []),
        "jy_eng_free": (None, [vp]),
        "jy_eng_rows": (i64, [vp, i32]),
        "jy_eng_upsert": (i64, [vp, i32, u8p, i64]),
        "jy_eng_find": (i64, [vp, i32, u8p, i64]),
        "jy_eng_key": (None, [vp, i32, i64, pvp, pi64]),
        "jy_eng_inc": (None, [vp, i32, i64, i32, u64]),
        "jy_eng_is_foreign": (i32, [vp, i32, i64]),
        "jy_eng_set_foreign": (None, [vp, i32, i64]),
        "jy_eng_upsert_foreign": (None, [vp, i32, u8p, vp, vp, i64, vp]),
        "jy_eng_value": (u64, [vp, i32, i64]),
        "jy_eng_own": (u64, [vp, i32, i64, i32]),
        "jy_eng_own_max": (None, [vp, i32, i64, i32, u64]),
        "jy_eng_own_set": (i32, [vp, i32, i64]),
        "jy_eng_apply_drain": (None, [vp, i32, vp, vp, i64]),
        "jy_eng_export_pending": (i64, [vp, i32, vp, vp, vp, i64, i32]),
        "jy_eng_dirty_count": (i64, [vp, i32]),
        "jy_eng_pend_count": (i64, [vp, i32]),
        "jy_eng_export_dirty": (i64, [vp, i32, vp, vp, vp, vp, i64]),
        "jy_eng_export_sync_dirty": (i64, [vp, i32, vp, i64]),
        "jy_treg_export_sync_dirty": (i64, [vp, vp, i64]),
        "jy_tlog_export_sync_dirty": (i64, [vp, vp, i64]),
        "jy_treg_deltas_info": (None, [vp, pi64, pi64, pi64]),
        "jy_treg_export_deltas_bulk": (
            None, [vp, vp, vp, vp, vp, vp, vp, vp],
        ),
        "jy_tlog_deltas_info": (None, [vp, pi64, pi64, pi64]),
        "jy_tlog_export_deltas_bulk": (
            None, [vp, vp, vp, vp, vp, vp, vp, vp],
        ),
        "jy_tlog_export_pend_bulk": (i64, [vp, vp, i64, vp, vp, vp, i64]),
        "jy_tlog_vals_info": (None, [vp, i32, pi64, pi64]),
        "jy_tlog_export_vals": (None, [vp, i32, vp, vp, vp]),
        # TREG
        "jy_treg_rows": (i64, [vp]),
        "jy_treg_upsert": (i64, [vp, u8p, i64]),
        "jy_treg_find": (i64, [vp, u8p, i64]),
        "jy_treg_key": (None, [vp, i64, pvp, pi64]),
        "jy_treg_write": (None, [vp, i64, u64, u8p, i64]),
        "jy_treg_note_delta": (None, [vp, i64, u64, u8p, i64]),
        "jy_treg_winner": (i32, [vp, i64, pu64, pvp, pi64]),
        "jy_treg_pend_count": (i64, [vp]),
        "jy_treg_export_pend": (i64, [vp, vp, vp, i64]),
        "jy_treg_pend_val": (None, [vp, i64, pvp, pi64]),
        "jy_treg_fold_pend": (None, [vp]),
        "jy_treg_delta_count": (i64, [vp]),
        "jy_treg_export_deltas": (i64, [vp, vp, vp, i64]),
        "jy_treg_delta_val": (None, [vp, i64, pvp, pi64]),
        "jy_treg_clear_deltas": (None, [vp]),
        # TLOG
        "jy_tlog_rows": (i64, [vp]),
        "jy_tlog_upsert": (i64, [vp, u8p, i64]),
        "jy_tlog_find": (i64, [vp, u8p, i64]),
        "jy_tlog_key": (None, [vp, i64, pvp, pi64]),
        "jy_tlog_ins": (None, [vp, i64, u64, u8p, i64]),
        "jy_tlog_conv_entry": (None, [vp, i64, u64, u8p, i64]),
        "jy_tlog_conv_cutoff": (None, [vp, i64, u64]),
        "jy_tlog_size": (i64, [vp, i64]),
        "jy_tlog_len_cache": (i64, [vp, i64]),
        "jy_tlog_cut_cache": (u64, [vp, i64]),
        "jy_tlog_cutoff_view": (u64, [vp, i64]),
        "jy_tlog_pend_cutoff": (u64, [vp, i64]),
        "jy_tlog_quiescent": (i32, [vp, i64]),
        "jy_tlog_gen": (u64, [vp, i64]),
        "jy_tlog_pend_len": (i64, [vp, i64]),
        "jy_tlog_pend_rows_count": (i64, [vp]),
        "jy_tlog_row_overdue": (i32, [vp]),
        "jy_tlog_touched_rows": (i64, [vp, vp, i64]),
        "jy_tlog_touched_count": (i64, [vp]),
        "jy_tlog_export_base": (i64, [vp, i64, vp, vp, i64]),
        "jy_tlog_compact": (i32, [vp]),
        "jy_tlog_base_valid": (i32, [vp, i64]),
        "jy_tlog_live_total": (i64, [vp]),
        "jy_tlog_export_pend": (i64, [vp, i64, vp, vp, i64]),
        "jy_tlog_val": (None, [vp, i32, pvp, pi64]),
        "jy_tlog_intern": (i32, [vp, u8p, i64]),
        "jy_tlog_finish_row": (None, [vp, i64, i64, u64]),
        "jy_tlog_finish_end": (None, [vp]),
        "jy_tlog_set_base": (None, [vp, i64, i64, vp, vp]),
        "jy_tlog_export_merged": (i64, [vp, i64, vp, vp, i64]),
        "jy_tlog_delta_rows_count": (i64, [vp]),
        "jy_tlog_export_delta_rows": (i64, [vp, vp, i64]),
        "jy_tlog_export_delta": (i64, [vp, i64, vp, vp, i64]),
        "jy_tlog_delta_cutoff": (u64, [vp, i64]),
        "jy_tlog_delta_raise_cutoff": (None, [vp, i64, u64]),
        "jy_tlog_clear_deltas": (None, [vp]),
        "jy_eng_served": (None, [vp, vp]),
        # UJSON queue + render memo
        "jy_uq_count": (i64, [vp]),
        "jy_uq_bytes": (i64, [vp]),
        "jy_uq_data": (i64, [vp, vp, i64]),
        "jy_uq_clear": (None, [vp]),
        "jy_uj_upsert": (i64, [vp, u8p, i64]),
        "jy_uj_memo_put": (None, [vp, i64, u8p, i64, u8p, i64]),
        "jy_uj_invalidate": (None, [vp, u8p, i64, u8p, i64, i32]),
        "jy_uj_memo_len": (i64, [vp, u8p, i64]),
        # batch applier
        "jy_eng_scan_apply2": (
            i32,
            [vp, vp, i64, vp, i64, pi64, pi64, vp, vp, i32, pi32, vp],
        ),
    }
    for fn_name, (restype, argtypes) in sigs.items():
        fn = getattr(c, fn_name)
        fn.restype = restype
        fn.argtypes = argtypes


class ServeEngine:
    """One native engine instance = all five data-type tables of one node."""

    def __init__(self, cdll):
        if not getattr(cdll, "_jy_engine_declared", False):
            _declare(cdll)
            cdll._jy_engine_declared = True
        self._lib = cdll
        self._h = cdll.jy_eng_new()
        self._out = (ctypes.c_uint8 * _OUT_CAP)()
        self._offs = (ctypes.c_int64 * _MAX_ARGS)()
        self._lens = (ctypes.c_int64 * _MAX_ARGS)()
        self._changed = (ctypes.c_int32 * 5)()
        self._tlog_vals: list[bytes] = []  # native vid -> bytes mirror

    @property
    def cdll(self) -> ctypes.CDLL:
        """The library this engine lives in (the node's RESP scanner
        comes from the same handle)."""
        return self._lib

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.jy_eng_free(self._h)
            self._h = None

    # ---- counter table ops -------------------------------------------------

    def rows(self, which: int) -> int:
        return self._lib.jy_eng_rows(self._h, which)

    def upsert(self, which: int, key: bytes) -> int:
        return self._lib.jy_eng_upsert(self._h, which, key, len(key))

    def find(self, which: int, key: bytes) -> int:
        return self._lib.jy_eng_find(self._h, which, key, len(key))

    def key_of(self, which: int, row: int) -> bytes:
        ptr = ctypes.c_void_p()
        n = ctypes.c_int64()
        self._lib.jy_eng_key(self._h, which, row, ctypes.byref(ptr), ctypes.byref(n))
        return ctypes.string_at(ptr, n.value)

    def inc(self, which: int, row: int, polarity: int, amount: int) -> None:
        self._lib.jy_eng_inc(self._h, which, row, polarity, amount)

    def is_foreign(self, which: int, row: int) -> bool:
        return bool(self._lib.jy_eng_is_foreign(self._h, which, row))

    def set_foreign(self, which: int, row: int) -> None:
        self._lib.jy_eng_set_foreign(self._h, which, row)

    def upsert_foreign(self, which: int, keys) -> np.ndarray:
        """Upsert each of ``keys`` and mark its row foreign, in one call:
        the rows, int64, in the keys' order."""
        n = len(keys)
        lens = np.fromiter(map(len, keys), np.int64, n)
        offs = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        rows = np.empty(n, np.int64)
        self._lib.jy_eng_upsert_foreign(
            self._h, which, b"".join(keys),
            offs.ctypes.data, lens.ctypes.data, n, rows.ctypes.data,
        )
        return rows

    def value(self, which: int, row: int) -> int:
        return self._lib.jy_eng_value(self._h, which, row)

    def own(self, which: int, row: int, polarity: int) -> int:
        return self._lib.jy_eng_own(self._h, which, row, polarity)

    def own_max(self, which: int, row: int, polarity: int, v: int) -> None:
        self._lib.jy_eng_own_max(self._h, which, row, polarity, v)

    def apply_drain(self, which: int, rows, values) -> None:
        rows = np.ascontiguousarray(rows, np.int64)
        values = np.ascontiguousarray(values, np.uint64)
        self._lib.jy_eng_apply_drain(
            self._h, which,
            rows.ctypes.data, values.ctypes.data, len(rows),
        )

    def export_pending(self, which: int, clear: bool = True):
        cap = 256
        while True:
            rows = np.empty(cap, np.int64)
            vp = np.empty(cap, np.uint64)
            vn = np.empty(cap, np.uint64)
            n = self._lib.jy_eng_export_pending(
                self._h, which,
                rows.ctypes.data, vp.ctypes.data, vn.ctypes.data, cap,
                1 if clear else 0,
            )
            if n >= 0:
                return rows[:n], vp[:n], vn[:n]
            cap = -n

    def dirty_count(self, which: int) -> int:
        return self._lib.jy_eng_dirty_count(self._h, which)

    def pend_count(self, which: int) -> int:
        return self._lib.jy_eng_pend_count(self._h, which)

    def export_dirty(self, which: int):
        cap = 256
        while True:
            rows = np.empty(cap, np.int64)
            op = np.empty(cap, np.uint64)
            on = np.empty(cap, np.uint64)
            sb = np.empty(cap, np.uint8)
            n = self._lib.jy_eng_export_dirty(
                self._h, which,
                rows.ctypes.data, op.ctypes.data, on.ctypes.data,
                sb.ctypes.data, cap,
            )
            if n >= 0:
                return rows[:n], op[:n], on[:n], sb[:n]
            cap = -n

    def own_set(self, which: int, row: int) -> int:
        """bit0 = P own ever written, bit1 = N own ever written."""
        return self._lib.jy_eng_own_set(self._h, which, row)

    def _export_sync_dirty(self, fn, *head) -> list[int]:
        cap = 256
        while True:
            rows = np.empty(cap, np.int64)
            n = fn(self._h, *head, rows.ctypes.data, cap)
            if n >= 0:
                return rows[:n].tolist()
            cap = -n

    def export_sync_dirty(self, which: int) -> list[int]:
        """Counter rows changed since the last digest pass; clears."""
        return self._export_sync_dirty(
            self._lib.jy_eng_export_sync_dirty, which
        )

    def treg_export_sync_dirty(self) -> list[int]:
        return self._export_sync_dirty(self._lib.jy_treg_export_sync_dirty)

    def tlog_export_sync_dirty(self) -> list[int]:
        return self._export_sync_dirty(self._lib.jy_tlog_export_sync_dirty)

    # ---- TREG table ops ----------------------------------------------------

    def treg_rows(self) -> int:
        return self._lib.jy_treg_rows(self._h)

    def treg_upsert(self, key: bytes) -> int:
        return self._lib.jy_treg_upsert(self._h, key, len(key))

    def treg_find(self, key: bytes) -> int:
        return self._lib.jy_treg_find(self._h, key, len(key))

    def treg_key_of(self, row: int) -> bytes:
        ptr = ctypes.c_void_p()
        n = ctypes.c_int64()
        self._lib.jy_treg_key(self._h, row, ctypes.byref(ptr), ctypes.byref(n))
        return ctypes.string_at(ptr, n.value)

    def treg_write(self, row: int, ts: int, value: bytes) -> None:
        self._lib.jy_treg_write(self._h, row, ts, value, len(value))

    def treg_note_delta(self, row: int, ts: int, value: bytes) -> None:
        self._lib.jy_treg_note_delta(self._h, row, ts, value, len(value))

    def treg_winner(self, row: int):
        ts = ctypes.c_uint64()
        ptr = ctypes.c_void_p()
        n = ctypes.c_int64()
        if not self._lib.jy_treg_winner(
            self._h, row, ctypes.byref(ts), ctypes.byref(ptr), ctypes.byref(n)
        ):
            return None
        return ts.value, ctypes.string_at(ptr, n.value)

    def treg_pend_count(self) -> int:
        return self._lib.jy_treg_pend_count(self._h)

    def treg_export_pend(self):
        """[(row, ts, value)] without clearing (clear = treg_fold_pend)."""
        cap = 256
        while True:
            rows = np.empty(cap, np.int64)
            ts = np.empty(cap, np.uint64)
            n = self._lib.jy_treg_export_pend(
                self._h, rows.ctypes.data, ts.ctypes.data, cap
            )
            if n >= 0:
                break
            cap = -n
        ptr = ctypes.c_void_p()
        ln = ctypes.c_int64()
        out = []
        for i in range(n):
            self._lib.jy_treg_pend_val(
                self._h, int(rows[i]), ctypes.byref(ptr), ctypes.byref(ln)
            )
            out.append((int(rows[i]), int(ts[i]), ctypes.string_at(ptr, ln.value)))
        return out

    def treg_fold_pend(self) -> None:
        self._lib.jy_treg_fold_pend(self._h)

    def treg_delta_count(self) -> int:
        return self._lib.jy_treg_delta_count(self._h)

    def treg_flush_deltas(self):
        """Sorted [(key, (value, ts))]; clears the delta window. ONE bulk
        FFI pass: an FFI round trip per row would cost a call per key."""
        n = ctypes.c_int64()
        vb = ctypes.c_int64()
        kb = ctypes.c_int64()
        self._lib.jy_treg_deltas_info(
            self._h, ctypes.byref(n), ctypes.byref(vb), ctypes.byref(kb)
        )
        n = n.value
        if n == 0:
            return []
        ts = np.empty(n, np.uint64)
        vo = np.empty(n, np.int64)
        vl = np.empty(n, np.int64)
        ko = np.empty(n, np.int64)
        kl = np.empty(n, np.int64)
        vblob = np.empty(max(vb.value, 1), np.uint8)
        kblob = np.empty(max(kb.value, 1), np.uint8)
        self._lib.jy_treg_export_deltas_bulk(
            self._h, ts.ctypes.data, vo.ctypes.data, vl.ctypes.data,
            vblob.ctypes.data, ko.ctypes.data, kl.ctypes.data,
            kblob.ctypes.data,
        )
        self._lib.jy_treg_clear_deltas(self._h)
        vbytes = vblob.tobytes()
        kbytes = kblob.tobytes()
        out = [
            (kbytes[o : o + ln], (vbytes[vo_ : vo_ + vl_], t))
            for o, ln, vo_, vl_, t in zip(
                ko.tolist(), kl.tolist(), vo.tolist(), vl.tolist(),
                ts.tolist(),
            )
        ]
        out.sort()
        return out

    # ---- TLOG table ops ----------------------------------------------------

    def _tlog_val(self, vid: int) -> bytes:
        vals = self._tlog_vals
        if vid >= len(vals):
            self._tlog_refill_vals()
        return vals[vid]

    def _tlog_refill_vals(self) -> None:
        """Mirror every native-interned value from the current mirror
        length up, in ONE bulk export."""
        lo = len(self._tlog_vals)
        n = ctypes.c_int64()
        nb = ctypes.c_int64()
        self._lib.jy_tlog_vals_info(
            self._h, lo, ctypes.byref(n), ctypes.byref(nb)
        )
        if n.value <= 0:
            return
        off = np.empty(n.value, np.int64)
        ln = np.empty(n.value, np.int64)
        blob = np.empty(max(nb.value, 1), np.uint8)
        self._lib.jy_tlog_export_vals(
            self._h, lo, off.ctypes.data, ln.ctypes.data, blob.ctypes.data
        )
        data = blob.tobytes()
        self._tlog_vals.extend(
            data[o : o + l] for o, l in zip(off.tolist(), ln.tolist())
        )

    def tlog_rows(self) -> int:
        return self._lib.jy_tlog_rows(self._h)

    def tlog_upsert(self, key: bytes) -> int:
        return self._lib.jy_tlog_upsert(self._h, key, len(key))

    def tlog_find(self, key: bytes) -> int:
        return self._lib.jy_tlog_find(self._h, key, len(key))

    def tlog_key_of(self, row: int) -> bytes:
        ptr = ctypes.c_void_p()
        n = ctypes.c_int64()
        self._lib.jy_tlog_key(self._h, row, ctypes.byref(ptr), ctypes.byref(n))
        return ctypes.string_at(ptr, n.value)

    def tlog_ins(self, row: int, ts: int, value: bytes) -> None:
        self._lib.jy_tlog_ins(self._h, row, ts, value, len(value))

    def tlog_conv_entry(self, row: int, ts: int, value: bytes) -> None:
        self._lib.jy_tlog_conv_entry(self._h, row, ts, value, len(value))

    def tlog_conv_cutoff(self, row: int, c: int) -> None:
        self._lib.jy_tlog_conv_cutoff(self._h, row, c)

    def tlog_size(self, row: int) -> int:
        return self._lib.jy_tlog_size(self._h, row)

    def tlog_len_cache(self, row: int) -> int:
        return self._lib.jy_tlog_len_cache(self._h, row)

    def tlog_cut_cache(self, row: int) -> int:
        return self._lib.jy_tlog_cut_cache(self._h, row)

    def tlog_cutoff_view(self, row: int) -> int:
        return self._lib.jy_tlog_cutoff_view(self._h, row)

    def tlog_pend_cutoff(self, row: int) -> int:
        return self._lib.jy_tlog_pend_cutoff(self._h, row)

    def tlog_quiescent(self, row: int) -> bool:
        return bool(self._lib.jy_tlog_quiescent(self._h, row))

    def tlog_gen(self, row: int) -> int:
        return self._lib.jy_tlog_gen(self._h, row)

    def tlog_pend_len(self, row: int) -> int:
        return self._lib.jy_tlog_pend_len(self._h, row)

    def tlog_pend_rows_count(self) -> int:
        return self._lib.jy_tlog_pend_rows_count(self._h)

    def tlog_row_overdue(self) -> bool:
        return bool(self._lib.jy_tlog_row_overdue(self._h))

    def tlog_touched_rows(self) -> list[int]:
        cap = 256
        while True:
            rows = np.empty(cap, np.int64)
            n = self._lib.jy_tlog_touched_rows(self._h, rows.ctypes.data, cap)
            if n >= 0:
                return rows[:n].tolist()
            cap = -n

    def tlog_touched_count(self) -> int:
        return self._lib.jy_tlog_touched_count(self._h)

    def tlog_base_entries(self, row: int):
        """[(ts, value)] of the drained row content when the carried base
        is valid; None when the repo must gather it from the device."""
        cap = 64
        while True:
            ts = np.empty(cap, np.uint64)
            vid = np.empty(cap, np.int32)
            n = self._lib.jy_tlog_export_base(
                self._h, row, ts.ctypes.data, vid.ctypes.data, cap
            )
            if n == _TLOG_UNAVAILABLE:
                return None
            if n >= 0:
                return [
                    (int(ts[i]), self._tlog_val(int(vid[i]))) for i in range(n)
                ]
            cap = -n

    def tlog_compact(self) -> bool:
        """Native value-interner compaction; resets the vid mirror when a
        remap happened."""
        if self._lib.jy_tlog_compact(self._h):
            self._tlog_vals.clear()
            return True
        return False

    def tlog_base_valid(self, row: int) -> bool:
        return bool(self._lib.jy_tlog_base_valid(self._h, row))

    def tlog_live_total(self) -> int:
        return self._lib.jy_tlog_live_total(self._h)

    def tlog_export_pend(self, row: int) -> list[tuple[int, bytes]]:
        cap = max(self.tlog_pend_len(row), 1)
        ts = np.empty(cap, np.uint64)
        vid = np.empty(cap, np.int32)
        n = self._lib.jy_tlog_export_pend(
            self._h, row, ts.ctypes.data, vid.ctypes.data, cap
        )
        assert n >= 0
        return [(int(ts[i]), self._tlog_val(int(vid[i]))) for i in range(n)]

    def tlog_export_pend_bulk(self, rows: list[int]):
        """{row: [(ts, value)]} for the drain's row set in one call."""
        nrows = len(rows)
        if nrows == 0:
            return {}
        rows_a = np.asarray(rows, np.int64)
        counts = np.empty(nrows, np.int64)
        cap = 256
        while True:
            ts = np.empty(cap, np.uint64)
            vid = np.empty(cap, np.int32)
            total = self._lib.jy_tlog_export_pend_bulk(
                self._h, rows_a.ctypes.data, nrows, counts.ctypes.data,
                ts.ctypes.data, vid.ctypes.data, cap,
            )
            if total >= 0:
                break
            cap = -total
        if int(vid[:total].max(initial=-1)) >= len(self._tlog_vals):
            self._tlog_refill_vals()
        vals = self._tlog_vals
        ts_l = ts[:total].tolist()
        vid_l = vid[:total].tolist()
        out = {}
        e = 0
        for row, c in zip(rows, counts.tolist()):
            out[row] = [(ts_l[j], vals[vid_l[j]]) for j in range(e, e + c)]
            e += c
        return out

    def tlog_intern(self, value: bytes) -> int:
        return self._lib.jy_tlog_intern(self._h, value, len(value))

    def tlog_finish_row(self, row: int, length: int, cut: int) -> None:
        self._lib.jy_tlog_finish_row(self._h, row, length, cut)

    def tlog_finish_end(self) -> None:
        self._lib.jy_tlog_finish_end(self._h)

    def tlog_set_base(self, row: int, entries) -> None:
        """entries: [(ts, value bytes)] — the drained row content."""
        n = len(entries)
        ts = np.empty(max(n, 1), np.uint64)
        vid = np.empty(max(n, 1), np.int32)
        for i, (t, v) in enumerate(entries):
            ts[i] = t
            vid[i] = self.tlog_intern(v)
        self._lib.jy_tlog_set_base(
            self._h, row, n, ts.ctypes.data, vid.ctypes.data
        )

    def tlog_merged_entries(self, row: int):
        """[(ts, value)] of the merged view, unsorted; None when the
        drained base is unknown (call tlog_size / tlog_set_base first)."""
        cap = 64
        while True:
            ts = np.empty(cap, np.uint64)
            vid = np.empty(cap, np.int32)
            n = self._lib.jy_tlog_export_merged(
                self._h, row, ts.ctypes.data, vid.ctypes.data, cap
            )
            if n == _TLOG_UNAVAILABLE:
                return None
            if n >= 0:
                return [
                    (int(ts[i]), self._tlog_val(int(vid[i]))) for i in range(n)
                ]
            cap = -n

    def tlog_deltas_size(self) -> int:
        return self._lib.jy_tlog_delta_rows_count(self._h)

    def tlog_delta_raise_cutoff(self, row: int, c: int) -> None:
        self._lib.jy_tlog_delta_raise_cutoff(self._h, row, c)

    def tlog_flush_deltas(self):
        """Sorted [(key, (entries latest-first, cutoff))]; clears. ONE
        bulk FFI pass (see treg_flush_deltas)."""
        n = ctypes.c_int64()
        te = ctypes.c_int64()
        kb = ctypes.c_int64()
        self._lib.jy_tlog_deltas_info(
            self._h, ctypes.byref(n), ctypes.byref(te), ctypes.byref(kb)
        )
        n = n.value
        if n == 0:
            return []
        counts = np.empty(n, np.int64)
        cutoffs = np.empty(n, np.uint64)
        ts_flat = np.empty(max(te.value, 1), np.uint64)
        vid_flat = np.empty(max(te.value, 1), np.int32)
        ko = np.empty(n, np.int64)
        kl = np.empty(n, np.int64)
        kblob = np.empty(max(kb.value, 1), np.uint8)
        self._lib.jy_tlog_export_deltas_bulk(
            self._h, counts.ctypes.data, cutoffs.ctypes.data,
            ts_flat.ctypes.data, vid_flat.ctypes.data,
            ko.ctypes.data, kl.ctypes.data, kblob.ctypes.data,
        )
        self._lib.jy_tlog_clear_deltas(self._h)
        if int(vid_flat[: te.value].max(initial=-1)) >= len(self._tlog_vals):
            self._tlog_refill_vals()
        vals = self._tlog_vals
        kbytes = kblob.tobytes()
        ts_l = ts_flat.tolist()
        vid_l = vid_flat.tolist()
        out = []
        e = 0
        for i, (c, cut, o, ln) in enumerate(
            zip(counts.tolist(), cutoffs.tolist(), ko.tolist(), kl.tolist())
        ):
            ents = sorted(
                ((ts_l[j], vals[vid_l[j]]) for j in range(e, e + c)),
                reverse=True,
            )
            e += c
            out.append((kbytes[o : o + ln], ([(v, t) for t, v in ents], cut)))
        out.sort()
        return out

    # the engine's changed/served-counter type order (serve_engine.cpp)
    TYPE_ORDER = ("GCOUNT", "PNCOUNT", "TREG", "TLOG", "UJSON")

    def served_counts(self) -> dict[str, int]:
        """Commands settled natively since startup, per data type."""
        out = np.zeros(5, np.uint64)
        self._lib.jy_eng_served(self._h, out.ctypes.data)
        return dict(zip(self.TYPE_ORDER, out.tolist()))

    # ---- UJSON render memo -------------------------------------------------

    @staticmethod
    def _uj_path_blob(path_args) -> bytes:
        """Path argument vector as the memo's length-prefixed blob key
        (binary-safe, and component-prefix == byte-prefix — engine.h).
        Components are CANONICALISED to the UTF-8 encoding of the
        errors="replace" decode the oracle applies (repo_ujson
        _decode_path): byte-distinct spellings that alias in the
        document alias in the memo too, so invalidation through one
        spelling can never leave another's render stale. The engine's
        bank-time invalidation uses raw bytes, which equal this
        canonical form exactly for valid UTF-8 — and it defers any
        write whose path is not valid UTF-8 (engine.h utf8_valid)."""
        return b"".join(
            struct.pack("<I", len(c)) + c
            for c in (
                bytes(p).decode("utf-8", "replace").encode()
                for p in path_args
            )
        )

    def uj_memo_put(self, key: bytes, path_args, reply: bytes) -> None:
        """Install the oracle-rendered GET reply for (key, path)."""
        row = self._lib.jy_uj_upsert(self._h, key, len(key))
        blob = self._uj_path_blob(path_args)
        self._lib.jy_uj_memo_put(
            self._h, row, blob, len(blob), reply, len(reply)
        )

    def uj_invalidate(self, key: bytes, path_args, subtree: bool) -> None:
        """Drop the renders a write at path can change: INS/RM
        (subtree=False) touch only renders at prefix paths; SET/CLR
        (subtree=True) rewrite the subtree, so both prefix directions."""
        blob = self._uj_path_blob(path_args)
        self._lib.jy_uj_invalidate(
            self._h, key, len(key), blob, len(blob), 1 if subtree else 0
        )

    def uj_memo_len(self, key: bytes) -> int:
        return self._lib.jy_uj_memo_len(self._h, key, len(key))

    # ---- UJSON queue -------------------------------------------------------

    def uq_count(self) -> int:
        return self._lib.jy_uq_count(self._h)

    def uq_drain(self) -> list[list[bytes]]:
        """Pop every banked UJSON write (INS/SET/RM/CLR) as its raw
        argument list (without the leading type word), in arrival
        order."""
        nbytes = self._lib.jy_uq_bytes(self._h)
        if nbytes == 0:
            return []
        blob = (ctypes.c_uint8 * nbytes)()
        got = self._lib.jy_uq_data(self._h, blob, nbytes)
        assert got == nbytes
        self._lib.jy_uq_clear(self._h)
        data = bytes(blob)
        out = []
        pos = 0
        while pos < len(data):
            (argc,) = struct.unpack_from("<I", data, pos)
            pos += 4
            args = []
            for _ in range(argc):
                (ln,) = struct.unpack_from("<I", data, pos)
                pos += 4
                args.append(data[pos : pos + ln])
                pos += ln
            out.append(args)
        return out

    # ---- the batch applier -------------------------------------------------

    def scan_apply(self, buf):
        """Apply a pipelined burst. Returns
        (rc, consumed, replies: bytes, unhandled: list[bytes] | None,
        changed: tuple of 5 per-type counts (G, PN, TREG, TLOG, UJSON));
        rc as documented in serve_engine.cpp."""
        if not buf:
            return 0, 0, b"", None, (0, 0, 0, 0, 0)
        base = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        out_len = ctypes.c_int64()
        consumed = ctypes.c_int64()
        n_args = ctypes.c_int32()
        rc = self._lib.jy_eng_scan_apply2(
            self._h, ctypes.c_void_p(base), len(buf),
            self._out, _OUT_CAP, ctypes.byref(out_len),
            ctypes.byref(consumed),
            self._offs, self._lens, _MAX_ARGS, ctypes.byref(n_args),
            self._changed,
        )
        replies = ctypes.string_at(self._out, out_len.value)
        unhandled = None
        if rc == 1:
            view = memoryview(buf)
            unhandled = [
                bytes(view[self._offs[i] : self._offs[i] + self._lens[i]])
                for i in range(n_args.value)
            ]
            del view
        return rc, consumed.value, replies, unhandled, tuple(self._changed)


def make_engine() -> ServeEngine:
    """A fresh native engine; raises when the library cannot be built or
    loaded (native.NativeBuildError)."""
    return ServeEngine(lib())


def resolve_engine(engine):
    """The repos' and the Database's shared engine argument: "auto" -> a
    fresh native engine (or the build's error), "python" -> None (the
    pure-Python tables, the oracle); a ServeEngine of this package, or
    None, passes through. Anything else, such as the JAX package's
    engine, is refused: an engine handle never crosses packages."""
    if engine == "auto":
        return make_engine()
    if engine == "python" or engine is None:
        return None
    if not isinstance(engine, ServeEngine):
        raise TypeError(f"not a jylis_tpu_torch ServeEngine: {engine!r}")
    return engine
