// Native counter engine — the GCOUNT/PNCOUNT host-state surface.
//
// The reference executes every command inside compiled Pony actors
// (repo_gcount.pony:25-60, repo_pncount.pony:26-67); the rebuild's
// Python engine seam tops out on interpreter dispatch. The counter
// tables (engine.h Table) own the counters' HOST state (key table, own
// contributions, serving value cache, dirty/pending/foreign bookkeeping
// — the exact fields jylis_tpu/models/repo_counters.py otherwise keeps
// in dicts); whole pipelined bursts apply through the all-types batch
// applier in serve_engine.cpp.
//
// Split of responsibilities (single source of truth):
//   * native: per-key own/value/dirty/pending-own/foreign + INC/DEC/GET
//   * Python: device drains, foreign-delta pending (dense u64 planes),
//     flush/snapshot orchestration, cluster converge — all via the bulk
//     upsert/export/apply calls below.
//
// All values are u64 bit patterns; PNCOUNT's serving value is the
// two's-complement wrapped i64 the reference's (p-n).i64() defines.

#include "engine.h"

using namespace jy;

extern "C" {

void* jy_eng_new() { return new Engine(); }
void jy_eng_free(void* e) { delete static_cast<Engine*>(e); }

int64_t jy_eng_rows(void* e, int32_t which) {
    return static_cast<Engine*>(e)->t[which].idx.rows();
}

int64_t jy_eng_upsert(void* e, int32_t which, const uint8_t* k, int64_t n) {
    return static_cast<Engine*>(e)->t[which].upsert(k, n);
}

int64_t jy_eng_find(void* e, int32_t which, const uint8_t* k, int64_t n) {
    return static_cast<Engine*>(e)->t[which].find(k, n);
}

void jy_eng_key(void* e, int32_t which, int64_t row, const uint8_t** ptr,
                int64_t* len) {
    Table& t = static_cast<Engine*>(e)->t[which];
    *ptr = t.idx.key_ptr(row);
    *len = t.idx.key_len[row];
}

void jy_eng_inc(void* e, int32_t which, int64_t row, int32_t polarity,
                uint64_t amount) {
    static_cast<Engine*>(e)->t[which].bump(row, polarity, amount);
}

int32_t jy_eng_is_foreign(void* e, int32_t which, int64_t row) {
    return (static_cast<Engine*>(e)->t[which].flags[row] & F_FOREIGN) ? 1 : 0;
}

void jy_eng_set_foreign(void* e, int32_t which, int64_t row) {
    static_cast<Engine*>(e)->t[which].flags[row] |= F_FOREIGN;
}

// a converge slice's table half: upsert each of the n keys (key i is
// buf[offs[i], offs[i] + lens[i])), mark its row foreign and write the
// row to rows[i] -- one call per slice in place of two per key
void jy_eng_upsert_foreign(void* e, int32_t which, const uint8_t* buf,
                           const int64_t* offs, const int64_t* lens,
                           int64_t n, int64_t* rows) {
    Table& t = static_cast<Engine*>(e)->t[which];
    for (int64_t i = 0; i < n; i++) {
        int64_t r = t.upsert(buf + offs[i], lens[i]);
        t.flags[r] |= F_FOREIGN;
        rows[i] = r;
    }
}

uint64_t jy_eng_value(void* e, int32_t which, int64_t row) {
    return static_cast<Engine*>(e)->t[which].value[row];
}

uint64_t jy_eng_own(void* e, int32_t which, int64_t row, int32_t polarity) {
    Table& t = static_cast<Engine*>(e)->t[which];
    return polarity ? t.own_n[row] : t.own_p[row];
}

void jy_eng_own_max(void* e, int32_t which, int64_t row, int32_t polarity,
                    uint64_t v) {
    Table& t = static_cast<Engine*>(e)->t[which];
    uint64_t& own = polarity ? t.own_n[row] : t.own_p[row];
    if (v > own) own = v;
    t.flags[row] |= polarity ? F_OWNSET_N : F_OWNSET_P;
}

int32_t jy_eng_own_set(void* e, int32_t which, int64_t row) {
    uint8_t f = static_cast<Engine*>(e)->t[which].flags[row];
    return ((f & F_OWNSET_P) ? 1 : 0) | ((f & F_OWNSET_N) ? 2 : 0);
}

// drain writeback: authoritative post-join values for these rows; the
// foreign mark clears (the pending batch that made them stale is gone)
void jy_eng_apply_drain(void* e, int32_t which, const int64_t* rows,
                        const uint64_t* values, int64_t n) {
    Table& t = static_cast<Engine*>(e)->t[which];
    for (int64_t i = 0; i < n; i++) {
        t.value[rows[i]] = values[i];
        t.flags[rows[i]] &= static_cast<uint8_t>(~F_FOREIGN);
    }
}

// pending-own export for the drain batch; `clear` zeroes the window
// (callers peek first, drain on device, then clear — so a device failure
// mid-drain leaves the window intact for the retry)
int64_t jy_eng_export_pending(void* e, int32_t which, int64_t* rows,
                              uint64_t* vp, uint64_t* vn, int64_t cap,
                              int32_t clear) {
    Table& t = static_cast<Engine*>(e)->t[which];
    int64_t n = static_cast<int64_t>(t.pend_rows.size());
    if (n > cap) return -n;  // caller regrows buffers
    for (int64_t i = 0; i < n; i++) {
        int64_t r = t.pend_rows[i];
        rows[i] = r;
        vp[i] = (t.flags[r] & F_PEND_P) ? t.pend_p[r] : 0;
        vn[i] = (t.flags[r] & F_PEND_N) ? t.pend_n[r] : 0;
        if (clear) {
            t.flags[r] &= static_cast<uint8_t>(~(F_PEND_P | F_PEND_N));
            t.pend_p[r] = 0;
            t.pend_n[r] = 0;
        }
    }
    if (clear) t.pend_rows.clear();
    return n;
}

// rows changed since the last sync-digest pass (F_SYNCD); clears
int64_t jy_eng_export_sync_dirty(void* e, int32_t which, int64_t* rows,
                                 int64_t cap) {
    Table& t = static_cast<Engine*>(e)->t[which];
    int64_t n = static_cast<int64_t>(t.sync_dirty.size());
    if (n > cap) return -n;
    for (int64_t i = 0; i < n; i++) {
        rows[i] = t.sync_dirty[i];
        t.flags[t.sync_dirty[i]] &= static_cast<uint8_t>(~F_SYNCD);
    }
    t.sync_dirty.clear();
    return n;
}

int64_t jy_eng_dirty_count(void* e, int32_t which) {
    return static_cast<int64_t>(
        static_cast<Engine*>(e)->t[which].dirty_rows.size());
}

int64_t jy_eng_pend_count(void* e, int32_t which) {
    return static_cast<int64_t>(
        static_cast<Engine*>(e)->t[which].pend_rows.size());
}

// flush export: dirty rows + own contributions + own-set bits (bit0 = P
// was written, bit1 = N was written); clears the dirty set
int64_t jy_eng_export_dirty(void* e, int32_t which, int64_t* rows,
                            uint64_t* op, uint64_t* on, uint8_t* set_bits,
                            int64_t cap) {
    Table& t = static_cast<Engine*>(e)->t[which];
    int64_t n = static_cast<int64_t>(t.dirty_rows.size());
    if (n > cap) return -n;
    for (int64_t i = 0; i < n; i++) {
        int64_t r = t.dirty_rows[i];
        rows[i] = r;
        op[i] = t.own_p[r];
        on[i] = t.own_n[r];
        set_bits[i] =
            static_cast<uint8_t>(((t.flags[r] & F_OWNSET_P) ? 1 : 0) |
                                 ((t.flags[r] & F_OWNSET_N) ? 2 : 0));
        t.flags[r] &= static_cast<uint8_t>(~F_DIRTY);
    }
    t.dirty_rows.clear();
    return n;
}

}  // extern "C"
