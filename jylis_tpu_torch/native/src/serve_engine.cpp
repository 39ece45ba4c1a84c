// Native serving engine v2 — the all-types command hot path.
//
// Extends the counter engine (counter_engine.cpp) to the full command
// mix the reference serves from compiled actors on every core
// (jylis/server_notify.pony:8-36): TREG SET/GET, TLOG INS/SIZE/GET/CUTOFF,
// UJSON GET (from the per-key render memo) and the validated UJSON
// INS/SET/RM/CLR write queue settle here, so a pipelined burst of
// mixed traffic makes ONE FFI call instead of one interpreter dispatch
// per command. TLOG TRIM/TRIMAT/CLR stay with Python: they dispatch a
// device drain. Table semantics live in engine.h; models/treg_table.py
// and models/tlog_table.py hold the pure-Python oracles, and
// differential tests pin the equivalence.

#include "engine.h"

using namespace jy;

namespace {

// pending-rows thresholds past which writes bounce so the Python repo
// runs its device drain (must match repo_treg.py PENDING_DRAIN_THRESHOLD
// and repo_tlog.py ROW/PENDING_DRAIN_THRESHOLD — pinned by
// tests/test_serve_tables.py)
constexpr int64_t TREG_PENDING_DRAIN = 4096;

}  // namespace

extern "C" {

// ---- TREG ------------------------------------------------------------------

int64_t jy_treg_rows(void* e) {
    return static_cast<Engine*>(e)->treg.idx.rows();
}

int64_t jy_treg_upsert(void* e, const uint8_t* k, int64_t n) {
    return static_cast<Engine*>(e)->treg.upsert(k, n);
}

int64_t jy_treg_find(void* e, const uint8_t* k, int64_t n) {
    return static_cast<Engine*>(e)->treg.idx.find(k, n);
}

void jy_treg_key(void* e, int64_t row, const uint8_t** ptr, int64_t* len) {
    TregTable& t = static_cast<Engine*>(e)->treg;
    *ptr = t.idx.key_ptr(row);
    *len = t.idx.key_len[row];
}

void jy_treg_write(void* e, int64_t row, uint64_t ts, const uint8_t* v,
                   int64_t n) {
    static_cast<Engine*>(e)->treg.write(row, ts, v, n);
}

void jy_treg_note_delta(void* e, int64_t row, uint64_t ts, const uint8_t* v,
                        int64_t n) {
    static_cast<Engine*>(e)->treg.note_delta(row, ts, v, n);
}

int32_t jy_treg_winner(void* e, int64_t row, uint64_t* ts,
                       const uint8_t** ptr, int64_t* len) {
    TregTable& t = static_cast<Engine*>(e)->treg;
    const std::string* val;
    if (!t.winner(row, ts, &val)) return 0;
    *ptr = reinterpret_cast<const uint8_t*>(val->data());
    *len = static_cast<int64_t>(val->size());
    return 1;
}

int64_t jy_treg_pend_count(void* e) {
    return static_cast<int64_t>(
        static_cast<Engine*>(e)->treg.pend_rows.size());
}

int64_t jy_treg_export_pend(void* e, int64_t* rows, uint64_t* ts,
                            int64_t cap) {
    TregTable& t = static_cast<Engine*>(e)->treg;
    int64_t n = static_cast<int64_t>(t.pend_rows.size());
    if (n > cap) return -n;
    for (int64_t i = 0; i < n; i++) {
        rows[i] = t.pend_rows[i];
        ts[i] = t.pend_ts[t.pend_rows[i]];
    }
    return n;
}

void jy_treg_pend_val(void* e, int64_t row, const uint8_t** ptr,
                      int64_t* len) {
    TregTable& t = static_cast<Engine*>(e)->treg;
    *ptr = reinterpret_cast<const uint8_t*>(t.pend_val[row].data());
    *len = static_cast<int64_t>(t.pend_val[row].size());
}

void jy_treg_fold_pend(void* e) { static_cast<Engine*>(e)->treg.fold_pending(); }

int64_t jy_treg_delta_count(void* e) {
    return static_cast<int64_t>(
        static_cast<Engine*>(e)->treg.delta_rows.size());
}

int64_t jy_treg_export_deltas(void* e, int64_t* rows, uint64_t* ts,
                              int64_t cap) {
    TregTable& t = static_cast<Engine*>(e)->treg;
    int64_t n = static_cast<int64_t>(t.delta_rows.size());
    if (n > cap) return -n;
    for (int64_t i = 0; i < n; i++) {
        rows[i] = t.delta_rows[i];
        ts[i] = t.delta_ts[t.delta_rows[i]];
    }
    return n;
}

void jy_treg_delta_val(void* e, int64_t row, const uint8_t** ptr,
                       int64_t* len) {
    TregTable& t = static_cast<Engine*>(e)->treg;
    *ptr = reinterpret_cast<const uint8_t*>(t.delta_val[row].data());
    *len = static_cast<int64_t>(t.delta_val[row].size());
}

// bulk delta export (the heartbeat flush hot path): sizes first, then
// ONE call fills every per-row array and both byte blobs — per-row FFI
// round-trips made the 100k-key flush ~12x slower than the dict oracle
void jy_treg_deltas_info(void* e, int64_t* n, int64_t* val_bytes,
                         int64_t* key_bytes) {
    TregTable& t = static_cast<Engine*>(e)->treg;
    *n = static_cast<int64_t>(t.delta_rows.size());
    int64_t vb = 0, kb = 0;
    for (int64_t row : t.delta_rows) {
        vb += static_cast<int64_t>(t.delta_val[row].size());
        kb += t.idx.key_len[row];
    }
    *val_bytes = vb;
    *key_bytes = kb;
}

void jy_treg_export_deltas_bulk(void* e, uint64_t* ts, int64_t* val_off,
                                int64_t* val_len, uint8_t* val_blob,
                                int64_t* key_off, int64_t* key_len,
                                uint8_t* key_blob) {
    TregTable& t = static_cast<Engine*>(e)->treg;
    int64_t vpos = 0, kpos = 0;
    for (size_t i = 0; i < t.delta_rows.size(); i++) {
        int64_t row = t.delta_rows[i];
        ts[i] = t.delta_ts[row];
        const std::string& v = t.delta_val[row];
        val_off[i] = vpos;
        val_len[i] = static_cast<int64_t>(v.size());
        memcpy(val_blob + vpos, v.data(), v.size());
        vpos += static_cast<int64_t>(v.size());
        key_off[i] = kpos;
        key_len[i] = t.idx.key_len[row];
        memcpy(key_blob + kpos, t.idx.key_ptr(row),
               static_cast<size_t>(t.idx.key_len[row]));
        kpos += t.idx.key_len[row];
    }
}

int64_t jy_treg_export_sync_dirty(void* e, int64_t* rows, int64_t cap) {
    TregTable& t = static_cast<Engine*>(e)->treg;
    int64_t n = static_cast<int64_t>(t.sync_dirty.size());
    if (n > cap) return -n;
    for (int64_t i = 0; i < n; i++) {
        rows[i] = t.sync_dirty[i];
        t.sync_flag[t.sync_dirty[i]] = 0;
    }
    t.sync_dirty.clear();
    return n;
}

void jy_treg_clear_deltas(void* e) {
    TregTable& t = static_cast<Engine*>(e)->treg;
    for (int64_t row : t.delta_rows) {
        t.delta_set[row] = 0;
        t.delta_val[row].clear();
    }
    t.delta_rows.clear();
}

// ---- TLOG ------------------------------------------------------------------

int64_t jy_tlog_rows(void* e) {
    return static_cast<Engine*>(e)->tlog.idx.rows();
}

int64_t jy_tlog_upsert(void* e, const uint8_t* k, int64_t n) {
    return static_cast<Engine*>(e)->tlog.upsert(k, n);
}

int64_t jy_tlog_find(void* e, const uint8_t* k, int64_t n) {
    return static_cast<Engine*>(e)->tlog.idx.find(k, n);
}

void jy_tlog_key(void* e, int64_t row, const uint8_t** ptr, int64_t* len) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    *ptr = t.idx.key_ptr(row);
    *len = t.idx.key_len[row];
}

void jy_tlog_ins(void* e, int64_t row, uint64_t ts, const uint8_t* v,
                 int64_t n) {
    static_cast<Engine*>(e)->tlog.ins(row, ts, v, n);
}

void jy_tlog_conv_entry(void* e, int64_t row, uint64_t ts, const uint8_t* v,
                        int64_t n) {
    static_cast<Engine*>(e)->tlog.converge_entry(row, ts, v, n);
}

void jy_tlog_conv_cutoff(void* e, int64_t row, uint64_t c) {
    static_cast<Engine*>(e)->tlog.raise_pend_cutoff(row, c);
}

int64_t jy_tlog_size(void* e, int64_t row) {
    return static_cast<Engine*>(e)->tlog.size(row);
}

int64_t jy_tlog_len_cache(void* e, int64_t row) {
    return static_cast<Engine*>(e)->tlog.rows[row].len_cache;
}

uint64_t jy_tlog_cut_cache(void* e, int64_t row) {
    return static_cast<Engine*>(e)->tlog.rows[row].cut_cache;
}

uint64_t jy_tlog_cutoff_view(void* e, int64_t row) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    return t.cutoff_view(t.rows[row]);
}

uint64_t jy_tlog_pend_cutoff(void* e, int64_t row) {
    return static_cast<Engine*>(e)->tlog.rows[row].pend_cutoff;
}

int32_t jy_tlog_quiescent(void* e, int64_t row) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    return t.quiescent(t.rows[row]) ? 1 : 0;
}

uint64_t jy_tlog_gen(void* e, int64_t row) {
    return static_cast<Engine*>(e)->tlog.rows[row].gen;
}

int64_t jy_tlog_pend_len(void* e, int64_t row) {
    return static_cast<int64_t>(
        static_cast<Engine*>(e)->tlog.rows[row].pend.size());
}

int64_t jy_tlog_pend_rows_count(void* e) {
    return static_cast<Engine*>(e)->tlog.pend_rows_count;
}

int32_t jy_tlog_row_overdue(void* e) {
    return static_cast<Engine*>(e)->tlog.row_overdue ? 1 : 0;
}

// rows with pending entries OR a pending cutoff — the drain's row set,
// maintained as an insertion-deduped list (O(touched), not O(rows))
int64_t jy_tlog_touched_rows(void* e, int64_t* out, int64_t cap) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    int64_t n = static_cast<int64_t>(t.touched_list.size());
    if (n > cap) return -n;
    for (int64_t i = 0; i < n; i++) out[i] = t.touched_list[i];
    return n;
}

int64_t jy_tlog_touched_count(void* e) {
    return static_cast<int64_t>(
        static_cast<Engine*>(e)->tlog.touched_list.size());
}

// the drained row content when the carried base is valid; the
// unavailable sentinel otherwise (repo gathers from the device instead)
int64_t jy_tlog_export_base(void* e, int64_t row, uint64_t* ts, int32_t* vid,
                            int64_t cap) {
    TlogRow& r = static_cast<Engine*>(e)->tlog.rows[row];
    if (!r.base_valid) return -1 - (int64_t(1) << 40);
    int64_t n = static_cast<int64_t>(r.base.size());
    if (n > cap) return -n;
    for (int64_t i = 0; i < n; i++) {
        ts[i] = r.base[i].ts;
        vid[i] = r.base[i].vid;
    }
    return n;
}

// bulk delta export (the heartbeat flush hot path; see the TREG analog)
void jy_tlog_deltas_info(void* e, int64_t* n, int64_t* total_entries,
                         int64_t* key_bytes) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    *n = static_cast<int64_t>(t.delta_rows.size());
    int64_t te = 0, kb = 0;
    for (int64_t row : t.delta_rows) {
        te += static_cast<int64_t>(t.rows[row].delta.size());
        kb += t.idx.key_len[row];
    }
    *total_entries = te;
    *key_bytes = kb;
}

void jy_tlog_export_deltas_bulk(void* e, int64_t* counts, uint64_t* cutoffs,
                                uint64_t* ts_flat, int32_t* vid_flat,
                                int64_t* key_off, int64_t* key_len,
                                uint8_t* key_blob) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    int64_t epos = 0, kpos = 0;
    for (size_t i = 0; i < t.delta_rows.size(); i++) {
        int64_t row = t.delta_rows[i];
        const TlogRow& r = t.rows[row];
        counts[i] = static_cast<int64_t>(r.delta.size());
        cutoffs[i] = r.delta_cutoff;
        for (const TlogEnt& en : r.delta) {
            ts_flat[epos] = en.ts;
            vid_flat[epos] = en.vid;
            epos++;
        }
        key_off[i] = kpos;
        key_len[i] = t.idx.key_len[row];
        memcpy(key_blob + kpos, t.idx.key_ptr(row),
               static_cast<size_t>(t.idx.key_len[row]));
        kpos += t.idx.key_len[row];
    }
}

// bulk pending export for the device drain: counts + flat entry arrays
// for the given row set in ONE call
int64_t jy_tlog_export_pend_bulk(void* e, const int64_t* rows, int64_t nrows,
                                 int64_t* counts, uint64_t* ts_flat,
                                 int32_t* vid_flat, int64_t cap) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    int64_t total = 0;
    for (int64_t i = 0; i < nrows; i++)
        total += static_cast<int64_t>(t.rows[rows[i]].pend.size());
    if (total > cap) return -total;
    int64_t epos = 0;
    for (int64_t i = 0; i < nrows; i++) {
        const TlogRow& r = t.rows[rows[i]];
        counts[i] = static_cast<int64_t>(r.pend.size());
        for (const TlogEnt& en : r.pend) {
            ts_flat[epos] = en.ts;
            vid_flat[epos] = en.vid;
            epos++;
        }
    }
    return total;
}

// bulk value resolution: every interned string from `lo` up in one call
// (the Python vid->bytes mirror refills after compaction with two calls
// instead of one per vid)
void jy_tlog_vals_info(void* e, int32_t lo, int64_t* n, int64_t* bytes_) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    int64_t total = 0;
    for (size_t i = lo; i < t.vals.size(); i++)
        total += static_cast<int64_t>(t.vals[i].size());
    *n = static_cast<int64_t>(t.vals.size()) - lo;
    *bytes_ = total;
}

void jy_tlog_export_vals(void* e, int32_t lo, int64_t* off, int64_t* len,
                         uint8_t* blob) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    int64_t pos = 0;
    for (size_t i = lo; i < t.vals.size(); i++) {
        const std::string& v = t.vals[i];
        off[i - lo] = pos;
        len[i - lo] = static_cast<int64_t>(v.size());
        memcpy(blob + pos, v.data(), v.size());
        pos += static_cast<int64_t>(v.size());
    }
}

int64_t jy_tlog_export_sync_dirty(void* e, int64_t* rows, int64_t cap) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    int64_t n = static_cast<int64_t>(t.sync_dirty.size());
    if (n > cap) return -n;
    for (int64_t i = 0; i < n; i++) {
        rows[i] = t.sync_dirty[i];
        t.rows[t.sync_dirty[i]].sync_flag = false;
    }
    t.sync_dirty.clear();
    return n;
}

int32_t jy_tlog_compact(void* e) {
    return static_cast<Engine*>(e)->tlog.compact_values() ? 1 : 0;
}

int32_t jy_tlog_base_valid(void* e, int64_t row) {
    return static_cast<Engine*>(e)->tlog.rows[row].base_valid ? 1 : 0;
}

int64_t jy_tlog_live_total(void* e) {
    return static_cast<Engine*>(e)->tlog.live_total;
}

int64_t jy_tlog_export_pend(void* e, int64_t row, uint64_t* ts, int32_t* vid,
                            int64_t cap) {
    TlogRow& r = static_cast<Engine*>(e)->tlog.rows[row];
    int64_t n = static_cast<int64_t>(r.pend.size());
    if (n > cap) return -n;
    for (int64_t i = 0; i < n; i++) {
        ts[i] = r.pend[i].ts;
        vid[i] = r.pend[i].vid;
    }
    return n;
}

void jy_tlog_val(void* e, int32_t vid, const uint8_t** ptr, int64_t* len) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    *ptr = reinterpret_cast<const uint8_t*>(t.vals[vid].data());
    *len = static_cast<int64_t>(t.vals[vid].size());
}

int32_t jy_tlog_intern(void* e, const uint8_t* v, int64_t n) {
    return static_cast<Engine*>(e)->tlog.intern(v, n);
}

void jy_tlog_finish_row(void* e, int64_t row, int64_t len, uint64_t cut) {
    static_cast<Engine*>(e)->tlog.finish_drain_row(row, len, cut);
}

void jy_tlog_finish_end(void* e) {
    static_cast<Engine*>(e)->tlog.finish_drain_end();
}

void jy_tlog_set_base(void* e, int64_t row, int64_t n, const uint64_t* ts,
                      const int32_t* vid) {
    TlogRow& r = static_cast<Engine*>(e)->tlog.rows[row];
    r.base.clear();
    r.base.reserve(n);
    for (int64_t i = 0; i < n; i++) r.base.push_back(TlogEnt{ts[i], vid[i]});
    r.base_valid = true;
    r.memo_valid = false;
    r.memo.clear();
    r.gen++;
}

// memo export; caller must have just called jy_tlog_size (>= 0) under the
// repo lock, so the memo is current (or the row quiescent, in which case
// the memo may be absent and the BASE is the view)
int64_t jy_tlog_export_merged(void* e, int64_t row, uint64_t* ts,
                              int32_t* vid, int64_t cap) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    TlogRow& r = t.rows[row];
    if (t.memo_current(r)) {
        int64_t n = static_cast<int64_t>(r.memo.size());
        if (n > cap) return -n;
        int64_t i = 0;
        for (const TlogEnt& en : r.memo) {
            ts[i] = en.ts;
            vid[i] = en.vid;
            i++;
        }
        return n;
    }
    if (t.quiescent(r) && r.base_valid) {
        int64_t n = static_cast<int64_t>(r.base.size());
        if (n > cap) return -n;
        for (int64_t i = 0; i < n; i++) {
            ts[i] = r.base[i].ts;
            vid[i] = r.base[i].vid;
        }
        return n;
    }
    return -1 - (int64_t(1) << 40);  // unavailable sentinel
}

int64_t jy_tlog_delta_rows_count(void* e) {
    return static_cast<int64_t>(
        static_cast<Engine*>(e)->tlog.delta_rows.size());
}

int64_t jy_tlog_export_delta_rows(void* e, int64_t* out, int64_t cap) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    int64_t n = static_cast<int64_t>(t.delta_rows.size());
    if (n > cap) return -n;
    for (int64_t i = 0; i < n; i++) out[i] = t.delta_rows[i];
    return n;
}

int64_t jy_tlog_export_delta(void* e, int64_t row, uint64_t* ts, int32_t* vid,
                             int64_t cap) {
    TlogRow& r = static_cast<Engine*>(e)->tlog.rows[row];
    int64_t n = static_cast<int64_t>(r.delta.size());
    if (n > cap) return -n;
    int64_t i = 0;
    for (const TlogEnt& en : r.delta) {
        ts[i] = en.ts;
        vid[i] = en.vid;
        i++;
    }
    return n;
}

uint64_t jy_tlog_delta_cutoff(void* e, int64_t row) {
    return static_cast<Engine*>(e)->tlog.rows[row].delta_cutoff;
}

// hostref.TLog.raise_cutoff on the delta accumulator, creating it like
// repo_tlog.py _delta_for does
void jy_tlog_delta_raise_cutoff(void* e, int64_t row, uint64_t c) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    TlogRow& r = t.rows[row];
    if (!r.delta_present) {
        r.delta_present = true;
        t.delta_rows.push_back(row);
    }
    if (c > r.delta_cutoff) {
        r.delta_cutoff = c;
        for (auto it = r.delta.begin(); it != r.delta.end();)
            it = it->ts < c ? r.delta.erase(it) : std::next(it);
    }
}

void jy_tlog_clear_deltas(void* e) {
    TlogTable& t = static_cast<Engine*>(e)->tlog;
    for (int64_t row : t.delta_rows) {
        TlogRow& r = t.rows[row];
        r.delta_present = false;
        r.delta.clear();
        r.delta_cutoff = 0;  // a fresh hostref.TLog after every flush
    }
    t.delta_rows.clear();
}

// commands settled natively since startup, per type (G, PN, TREG, TLOG,
// UJSON) — the SYSTEM METRICS "cmds" surface's native half
void jy_eng_served(void* e, uint64_t* out) {
    Engine* eng = static_cast<Engine*>(e);
    for (int i = 0; i < 5; i++) out[i] = eng->served[i];
}

// ---- UJSON queue -----------------------------------------------------------

int64_t jy_uq_count(void* e) { return static_cast<Engine*>(e)->uq.count; }

int64_t jy_uq_bytes(void* e) {
    return static_cast<int64_t>(static_cast<Engine*>(e)->uq.blob.size());
}

int64_t jy_uq_data(void* e, uint8_t* out, int64_t cap) {
    UjsonQueue& q = static_cast<Engine*>(e)->uq;
    int64_t n = static_cast<int64_t>(q.blob.size());
    if (n > cap) return -n;
    memcpy(out, q.blob.data(), static_cast<size_t>(n));
    return n;
}

void jy_uq_clear(void* e) { static_cast<Engine*>(e)->uq.clear(); }

// ---- UJSON render memo (engine.h UjsonTable) -------------------------------

int64_t jy_uj_upsert(void* e, const uint8_t* k, int64_t n) {
    return static_cast<Engine*>(e)->uj.upsert(k, n);
}

void jy_uj_memo_put(void* e, int64_t row, const uint8_t* path, int64_t pn,
                    const uint8_t* reply, int64_t rn) {
    static_cast<Engine*>(e)->uj.put(
        row, std::string(reinterpret_cast<const char*>(path),
                         static_cast<size_t>(pn)),
        std::string(reinterpret_cast<const char*>(reply),
                    static_cast<size_t>(rn)));
}

void jy_uj_invalidate(void* e, const uint8_t* k, int64_t n,
                      const uint8_t* path, int64_t pn, int32_t subtree) {
    UjsonTable& u = static_cast<Engine*>(e)->uj;
    int64_t row = u.idx.find(k, n);
    if (row >= 0)
        u.invalidate(row,
                     std::string(reinterpret_cast<const char*>(path),
                                 static_cast<size_t>(pn)),
                     subtree != 0);
}

int64_t jy_uj_memo_len(void* e, const uint8_t* k, int64_t n) {
    UjsonTable& u = static_cast<Engine*>(e)->uj;
    int64_t row = u.idx.find(k, n);
    return row < 0 ? 0 : static_cast<int64_t>(u.memo[row].size());
}

// ---- the batch applier -----------------------------------------------------
//
// Returns:
//   0  consumed all complete commands (tail incomplete or buffer empty)
//   1  stopped at a command Python must apply: its slices are in
//      offs/lens/n_args and *consumed INCLUDES it
//   2  reply buffer nearly full: flush replies and call again
//  -1  protocol error at the stop point (serve replies, drop connection)
//  -2  a command has more than max_args arguments (grow and retry)
// changed[5] counts state-changing applies per type
// (G, PN, TREG, TLOG, UJSON) for the caller's on-change notifications.
int32_t jy_eng_scan_apply2(void* ev, const uint8_t* buf, int64_t len,
                           uint8_t* out, int64_t out_cap, int64_t* out_len,
                           int64_t* consumed, int64_t* offs, int64_t* lens,
                           int32_t max_args, int32_t* n_args,
                           int32_t* changed) {
    Engine* eng = static_cast<Engine*>(ev);
    *out_len = 0;
    *consumed = 0;
    *n_args = 0;
    for (int i = 0; i < 5; i++) changed[i] = 0;
    while (true) {
        if (out_cap - *out_len < 64) return 2;
        int64_t sub_consumed = 0;
        int32_t argc = 0;
        int32_t rc = resp_scan(buf + *consumed, len - *consumed, &sub_consumed,
                               offs, lens, max_args, &argc);
        if (rc == 0) return 0;
        if (rc == -1) return -1;
        if (rc == -2) {
            *n_args = argc;
            return -2;
        }
        for (int32_t i = 0; i < argc; i++) offs[i] += *consumed;
        bool inline_blank = argc == 0 && buf[*consumed] != '*';
        if (inline_blank) {  // oracle parser skips blank inline lines
            *consumed += sub_consumed;
            continue;
        }
        // bounce THIS command to the Python path, consumed
        auto defer = [&]() -> int32_t {
            *n_args = argc;
            *consumed += sub_consumed;
            return 1;
        };

        // ---- counters (exact round-3 semantics) ---------------------------
        int32_t which = -1;
        if (argc >= 1 && word_is(buf, offs[0], lens[0], "GCOUNT")) which = 0;
        if (argc >= 1 && word_is(buf, offs[0], lens[0], "PNCOUNT")) which = 1;
        if (which >= 0) {
            Table& t = eng->t[which];
            // GET key — reply from the value cache unless foreign-dirty
            if (argc >= 3 && word_is(buf, offs[1], lens[1], "GET")) {
                int64_t row = t.find(buf + offs[2], lens[2]);
                if (row >= 0 && (t.flags[row] & F_FOREIGN))
                    return defer();  // Python drains and serves this one
                uint64_t v = row >= 0 ? t.value[row] : 0;
                *out_len += fmt_int_reply(out + *out_len, v, which == 1);
                eng->served[which]++;
                *consumed += sub_consumed;
                continue;
            }
            int polarity = -1;
            if (argc >= 4 && word_is(buf, offs[1], lens[1], "INC"))
                polarity = 0;
            if (which == 1 && argc >= 4 &&
                word_is(buf, offs[1], lens[1], "DEC"))
                polarity = 1;
            if (polarity >= 0) {
                uint64_t amount = 0;
                if (!parse_amount(buf + offs[3], lens[3], &amount))
                    return defer();  // ParseError -> help text, Python's job
                int64_t row = t.upsert(buf + offs[2], lens[2]);
                t.bump(row, polarity, amount);
                changed[which]++;
                eng->served[which]++;
                memcpy(out + *out_len, "+OK\r\n", 5);
                *out_len += 5;
                *consumed += sub_consumed;
                continue;
            }
            return defer();  // unknown subcommand / wrong arity -> help
        }

        // ---- TREG ---------------------------------------------------------
        if (argc >= 1 && word_is(buf, offs[0], lens[0], "TREG")) {
            TregTable& t = eng->treg;
            if (argc >= 3 && word_is(buf, offs[1], lens[1], "GET")) {
                int64_t row = t.idx.find(buf + offs[2], lens[2]);
                uint64_t ts = 0;
                const std::string* val = nullptr;
                if (row < 0 || !t.winner(row, &ts, &val)) {
                    memcpy(out + *out_len, "$-1\r\n", 5);
                    *out_len += 5;
                    eng->served[2]++;
                    *consumed += sub_consumed;
                    continue;
                }
                int64_t need =
                    static_cast<int64_t>(val->size()) + 64;  // headers + ts
                if (out_cap - *out_len < need) {
                    if (*out_len > 0) return 2;  // flush replies, re-enter
                    return defer();  // value alone outgrows the buffer
                }
                uint8_t* o = out + *out_len;
                int64_t n = 0;
                memcpy(o + n, "*2\r\n$", 5);
                n += 5;
                n += fmt_u64(o + n, val->size());
                o[n++] = '\r';
                o[n++] = '\n';
                memcpy(o + n, val->data(), val->size());
                n += static_cast<int64_t>(val->size());
                o[n++] = '\r';
                o[n++] = '\n';
                n += fmt_int_reply(o + n, ts, false);
                *out_len += n;
                eng->served[2]++;
                *consumed += sub_consumed;
                continue;
            }
            if (argc >= 5 && word_is(buf, offs[1], lens[1], "SET")) {
                uint64_t ts = 0;
                if (!parse_amount(buf + offs[4], lens[4], &ts))
                    return defer();  // ParseError -> help
                // the write about to land would tip the drain threshold:
                // Python's may_drain path must run it (threaded drain)
                if (static_cast<int64_t>(t.pend_rows.size()) + 1 >=
                    TREG_PENDING_DRAIN)
                    return defer();
                int64_t row = t.upsert(buf + offs[2], lens[2]);
                t.write(row, ts, buf + offs[3], lens[3]);
                t.note_delta(row, ts, buf + offs[3], lens[3]);
                changed[2]++;
                eng->served[2]++;
                memcpy(out + *out_len, "+OK\r\n", 5);
                *out_len += 5;
                *consumed += sub_consumed;
                continue;
            }
            return defer();
        }

        // ---- TLOG ---------------------------------------------------------
        if (argc >= 1 && word_is(buf, offs[0], lens[0], "TLOG")) {
            TlogTable& t = eng->tlog;
            if (argc >= 3 && word_is(buf, offs[1], lens[1], "CUTOFF")) {
                int64_t row = t.idx.find(buf + offs[2], lens[2]);
                uint64_t c = row < 0 ? 0 : t.cutoff_view(t.rows[row]);
                *out_len += fmt_int_reply(out + *out_len, c, false);
                eng->served[3]++;
                *consumed += sub_consumed;
                continue;
            }
            if (argc >= 3 && word_is(buf, offs[1], lens[1], "GET")) {
                int64_t row = t.idx.find(buf + offs[2], lens[2]);
                if (row < 0) {
                    memcpy(out + *out_len, "*0\r\n", 4);
                    *out_len += 4;
                    eng->served[3]++;
                    *consumed += sub_consumed;
                    continue;
                }
                // optional count: any missing/unparseable value means
                // "all" (base.py parse_opt_count; repo_tlog.pony:49-50)
                uint64_t count = UINT64_MAX;
                if (argc >= 4 &&
                    !parse_amount(buf + offs[3], lens[3], &count))
                    count = UINT64_MAX;
                const std::vector<TlogEnt>* view = t.sorted_view_of(row);
                if (view == nullptr)
                    return defer();  // device row render: Python's job
                uint64_t n = static_cast<uint64_t>(view->size()) < count
                                 ? view->size()
                                 : count;
                int64_t need = 1 + digits10(n) + 2;
                for (uint64_t i = 0; i < n; i++) {
                    const TlogEnt& en = (*view)[i];
                    const std::string& v = t.vals[en.vid];
                    need += 4 + 1 + digits10(v.size()) + 2 +
                            static_cast<int64_t>(v.size()) + 2 + 1 +
                            digits10(en.ts) + 2;
                }
                if (out_cap - *out_len < need) {
                    if (*out_len > 0) return 2;  // flush replies, re-enter
                    return defer();  // reply alone outgrows the buffer
                }
                uint8_t* o = out + *out_len;
                int64_t m = 0;
                o[m++] = '*';
                m += fmt_u64(o + m, n);
                o[m++] = '\r';
                o[m++] = '\n';
                for (uint64_t i = 0; i < n; i++) {
                    const TlogEnt& en = (*view)[i];
                    const std::string& v = t.vals[en.vid];
                    memcpy(o + m, "*2\r\n$", 5);
                    m += 5;
                    m += fmt_u64(o + m, v.size());
                    o[m++] = '\r';
                    o[m++] = '\n';
                    memcpy(o + m, v.data(), v.size());
                    m += static_cast<int64_t>(v.size());
                    o[m++] = '\r';
                    o[m++] = '\n';
                    m += fmt_int_reply(o + m, en.ts, false);
                }
                *out_len += m;
                eng->served[3]++;
                *consumed += sub_consumed;
                continue;
            }
            if (argc >= 3 && word_is(buf, offs[1], lens[1], "SIZE")) {
                int64_t row = t.idx.find(buf + offs[2], lens[2]);
                int64_t n = row < 0 ? 0 : t.size(row);
                if (n < 0) return defer();  // drained base unknown
                *out_len += fmt_int_reply(out + *out_len,
                                          static_cast<uint64_t>(n), false);
                eng->served[3]++;
                *consumed += sub_consumed;
                continue;
            }
            if (argc >= 5 && word_is(buf, offs[1], lens[1], "INS")) {
                uint64_t ts = 0;
                if (!parse_amount(buf + offs[4], lens[4], &ts))
                    return defer();  // ParseError -> help
                int64_t row = t.idx.find(buf + offs[2], lens[2]);
                int64_t in_row =
                    row < 0 ? 0
                            : static_cast<int64_t>(t.rows[row].pend.size());
                // repo_tlog.py may_drain's exact predicate: Python must
                // run (and thread-offload) the drain this INS triggers
                if (in_row + 1 >= TlogTable::ROW_DRAIN_THRESHOLD ||
                    t.pend_rows_count + 1 >=
                        TlogTable::PENDING_DRAIN_THRESHOLD)
                    return defer();
                if (row < 0) row = t.upsert(buf + offs[2], lens[2]);
                t.ins(row, ts, buf + offs[3], lens[3]);
                changed[3]++;
                eng->served[3]++;
                memcpy(out + *out_len, "+OK\r\n", 5);
                *out_len += 5;
                *consumed += sub_consumed;
                continue;
            }
            return defer();
        }

        // ---- UJSON --------------------------------------------------------
        if (argc >= 1 && word_is(buf, offs[0], lens[0], "UJSON")) {
            UjsonTable& u = eng->uj;
            // path args [lo, hi) as the memo's length-prefixed blob key
            auto path_blob = [&](int32_t lo, int32_t hi) {
                std::string b;
                for (int32_t i = lo; i < hi; i++) {
                    uint32_t ln = static_cast<uint32_t>(lens[i]);
                    b.append(reinterpret_cast<const char*>(&ln), 4);
                    b.append(reinterpret_cast<const char*>(buf + offs[i]),
                             static_cast<size_t>(lens[i]));
                }
                return b;
            };
            // GET key [path...]: the oracle-rendered reply, memoised per
            // (key, path) and invalidated by every overlapping write — a
            // miss (or a never-rendered key) defers, and the Python GET
            // repairs the memo while serving (the TLOG base-repair shape)
            if (argc >= 3 && word_is(buf, offs[1], lens[1], "GET")) {
                int64_t row = u.idx.find(buf + offs[2], lens[2]);
                const std::string* reply =
                    row < 0 ? nullptr : u.get(row, path_blob(3, argc));
                if (reply == nullptr) return defer();
                int64_t need = static_cast<int64_t>(reply->size());
                if (out_cap - *out_len < need) {
                    if (*out_len > 0) return 2;  // flush replies, re-enter
                    return defer();  // reply alone outgrows the buffer
                }
                memcpy(out + *out_len, reply->data(), reply->size());
                *out_len += need;
                eng->served[4]++;
                *consumed += sub_consumed;
                continue;
            }
            // INS/SET/RM/CLR key [path...] [value]: validate that the
            // oracle's apply cannot raise, invalidate the overlapping
            // render memos, bank the raw slices, reply +OK (the oracle
            // applies the queue, in arrival order, before any other
            // UJSON work — repo_ujson.py _flush_queue)
            bool is_ins = argc >= 4 && word_is(buf, offs[1], lens[1], "INS");
            bool is_set = argc >= 4 && word_is(buf, offs[1], lens[1], "SET");
            bool is_rm = argc >= 4 && word_is(buf, offs[1], lens[1], "RM");
            bool is_clr = argc >= 3 && word_is(buf, offs[1], lens[1], "CLR");
            bool ok = is_clr;
            if (is_ins || is_rm)
                ok = ujson_prim_ok(buf + offs[argc - 1], lens[argc - 1]);
            else if (is_set)
                ok = ujson_doc_ok(buf + offs[argc - 1], lens[argc - 1]);
            // path components must be valid UTF-8 so the raw bytes ARE
            // the memo's canonical key (engine.h utf8_valid) — an
            // invalid component defers to Python, whose invalidation
            // canonicalises the path the same way the oracle decodes it
            if (ok) {
                int32_t path_end = is_clr ? argc : argc - 1;
                for (int32_t i = 3; ok && i < path_end; i++)
                    ok = utf8_valid(buf + offs[i], lens[i]);
            }
            if (ok && !eng->uq.full()) {
                int64_t row = u.idx.find(buf + offs[2], lens[2]);
                if (row >= 0)
                    u.invalidate(row, path_blob(3, is_clr ? argc : argc - 1),
                                 is_set || is_clr);
                eng->uq.push(buf, offs + 1, lens + 1, argc - 1);
                changed[4]++;
                eng->served[4]++;
                memcpy(out + *out_len, "+OK\r\n", 5);
                *out_len += 5;
                *consumed += sub_consumed;
                continue;
            }
            return defer();
        }

        return defer();  // any other first word: datatype help / SYSTEM
    }
}

}  // extern "C"
