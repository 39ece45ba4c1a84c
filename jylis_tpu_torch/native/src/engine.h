// Shared host-state tables for the native serving engine.
//
// The reference executes every command inside compiled Pony actors
// scheduled across all cores (jylis/server_notify.pony:8-36,
// jylis/repo_manager.pony:18); the rebuild's Python serving seam tops out
// on interpreter dispatch. These tables own the per-type HOST state the
// Python repos otherwise keep in dicts, so whole pipelined bursts of ANY
// data type settle in one FFI call (native/serve_engine.cpp): parse (via
// resp_scan, same .so) + table update + reply bytes, all in C++.
//
// Split of responsibilities (single source of truth):
//   * native: key tables, serving winners/caches, pending windows, delta
//     accumulators — everything a command touches on the hot path
//   * Python: device drains, cluster converge orchestration, snapshots —
//     via the bulk export/apply calls in the .cpp files
// Any command the engine can't settle exactly like the Python oracle is
// returned to Python with its argument slices; the caller applies THAT
// command (after draining the UJSON write queue, which preserves
// per-connection ordering) and re-enters.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" int32_t resp_scan(const uint8_t* buf, int64_t len,
                             int64_t* consumed, int64_t* offs, int64_t* lens,
                             int32_t max_args, int32_t* n_args);

namespace jy {

// ---- open-addressing key index (FNV-1a, power-of-two, linear probe) --------

struct KeyIndex {
    std::vector<int64_t> slot_row;  // -1 empty
    std::vector<uint8_t> arena;     // key bytes, append-only
    std::vector<int64_t> key_off;
    std::vector<int64_t> key_len;
    std::vector<uint64_t> key_hash;

    KeyIndex() : slot_row(64, -1) {}

    size_t mask() const { return slot_row.size() - 1; }
    int64_t rows() const { return static_cast<int64_t>(key_off.size()); }

    static uint64_t hash(const uint8_t* k, int64_t n) {
        uint64_t h = 1469598103934665603ull;
        for (int64_t i = 0; i < n; i++) h = (h ^ k[i]) * 1099511628211ull;
        return h;
    }

    bool key_eq(int64_t row, const uint8_t* k, int64_t n) const {
        return key_len[row] == n &&
               memcmp(arena.data() + key_off[row], k,
                      static_cast<size_t>(n)) == 0;
    }

    void rehash() {
        std::vector<int64_t> fresh(slot_row.size() * 2, -1);
        size_t m = fresh.size() - 1;
        for (size_t r = 0; r < key_off.size(); r++) {
            size_t i = key_hash[r] & m;
            while (fresh[i] >= 0) i = (i + 1) & m;
            fresh[i] = static_cast<int64_t>(r);
        }
        slot_row.swap(fresh);
    }

    int64_t find(const uint8_t* k, int64_t n) const {
        uint64_t h = hash(k, n);
        size_t i = h & mask();
        while (true) {
            int64_t row = slot_row[i];
            if (row < 0) return -1;
            if (key_hash[row] == h && key_eq(row, k, n)) return row;
            i = (i + 1) & mask();
        }
    }

    // returns (row, was_new): callers append their per-row columns on new
    std::pair<int64_t, bool> upsert(const uint8_t* k, int64_t n) {
        uint64_t h = hash(k, n);
        size_t i = h & mask();
        while (true) {
            int64_t row = slot_row[i];
            if (row < 0) break;
            if (key_hash[row] == h && key_eq(row, k, n)) return {row, false};
            i = (i + 1) & mask();
        }
        int64_t row = rows();
        key_off.push_back(static_cast<int64_t>(arena.size()));
        key_len.push_back(n);
        key_hash.push_back(h);
        arena.insert(arena.end(), k, k + n);
        slot_row[i] = row;
        if (key_off.size() * 10 >= slot_row.size() * 7) rehash();
        return {row, true};
    }

    const uint8_t* key_ptr(int64_t row) const {
        return arena.data() + key_off[row];
    }
};

// ---- counter table (GCOUNT / PNCOUNT) --------------------------------------

constexpr uint8_t F_FOREIGN = 1;
constexpr uint8_t F_DIRTY = 2;
constexpr uint8_t F_PEND_P = 4;
constexpr uint8_t F_PEND_N = 8;
// "own was ever written" per polarity: flush emits a polarity's entry
// only when set, matching the Python dicts' key-presence semantics
// (an INC of 0 still creates the entry)
constexpr uint8_t F_OWNSET_P = 16;
constexpr uint8_t F_OWNSET_N = 32;
// row changed since the last sync-digest pass (cluster/syncdigest)
constexpr uint8_t F_SYNCD = 64;

struct Table {
    KeyIndex idx;
    // per-row state
    std::vector<uint64_t> value;  // serving value (u64 bits)
    std::vector<uint64_t> own_p;
    std::vector<uint64_t> own_n;
    std::vector<uint64_t> pend_p;  // max own within the drain window
    std::vector<uint64_t> pend_n;
    std::vector<uint8_t> flags;
    std::vector<int64_t> dirty_rows;  // insertion order; F_DIRTY dedups
    std::vector<int64_t> pend_rows;   // rows with any F_PEND_*
    std::vector<int64_t> sync_dirty;  // rows changed since last digest

    int64_t find(const uint8_t* k, int64_t n) const { return idx.find(k, n); }

    int64_t upsert(const uint8_t* k, int64_t n) {
        auto [row, fresh] = idx.upsert(k, n);
        if (fresh) {
            value.push_back(0);
            own_p.push_back(0);
            own_n.push_back(0);
            pend_p.push_back(0);
            pend_n.push_back(0);
            flags.push_back(0);
        }
        return row;
    }

    void mark_dirty(int64_t row) {
        if (!(flags[row] & F_DIRTY)) {
            flags[row] |= F_DIRTY;
            dirty_rows.push_back(row);
        }
    }

    // INC (polarity 0) / DEC (polarity 1): the exact sequence of
    // repo_counters.py _inc / PN apply
    void bump(int64_t row, int polarity, uint64_t amount) {
        uint64_t& own = polarity ? own_n[row] : own_p[row];
        uint64_t& pend = polarity ? pend_n[row] : pend_p[row];
        uint8_t bit = polarity ? F_PEND_N : F_PEND_P;
        flags[row] |= polarity ? F_OWNSET_N : F_OWNSET_P;
        own += amount;  // u64 wrap
        if (own > pend) pend = own;
        if (!(flags[row] & (F_PEND_P | F_PEND_N))) pend_rows.push_back(row);
        flags[row] |= bit;
        mark_dirty(row);
        if (!(flags[row] & F_SYNCD)) {
            flags[row] |= F_SYNCD;
            sync_dirty.push_back(row);
        }
        value[row] += polarity ? static_cast<uint64_t>(-amount) : amount;
    }
};

// ---- TREG table ------------------------------------------------------------
//
// Last-writer-wins registers (jylis/repo_treg.pony:11-68). The winner rule
// is lexicographic (ts, value-bytes) — exactly models/repo_treg.py's host
// compare, so the native winner NEVER needs a device read-back: a drain
// just folds the pending window into the drained cache (the join of what
// both already hold), and the device converges to the same winner.

struct TregTable {
    KeyIndex idx;
    // drained winner (the device mirror's exact host image)
    std::vector<uint64_t> cache_ts;
    std::vector<std::string> cache_val;
    std::vector<uint8_t> cache_set;
    // max (ts, value) written since the last drain
    std::vector<uint64_t> pend_ts;
    std::vector<std::string> pend_val;
    std::vector<uint8_t> pend_set;
    std::vector<int64_t> pend_rows;  // rows with pend_set, insertion order
    // max (ts, value) written locally since the last flush
    std::vector<uint64_t> delta_ts;
    std::vector<std::string> delta_val;
    std::vector<uint8_t> delta_set;
    std::vector<int64_t> delta_rows;
    // rows changed since the last sync-digest pass
    std::vector<uint8_t> sync_flag;
    std::vector<int64_t> sync_dirty;

    static bool wins(uint64_t ts, const uint8_t* v, int64_t n,
                     uint64_t cur_ts, const std::string& cur) {
        if (ts != cur_ts) return ts > cur_ts;
        size_t cn = cur.size();
        size_t m = static_cast<size_t>(n) < cn ? n : cn;
        int c = memcmp(v, cur.data(), m);
        if (c != 0) return c > 0;
        return static_cast<size_t>(n) > cn;
    }

    int64_t upsert(const uint8_t* k, int64_t n) {
        auto [row, fresh] = idx.upsert(k, n);
        if (fresh) {
            cache_ts.push_back(0);
            cache_val.emplace_back();
            cache_set.push_back(0);
            pend_ts.push_back(0);
            pend_val.emplace_back();
            pend_set.push_back(0);
            delta_ts.push_back(0);
            delta_val.emplace_back();
            delta_set.push_back(0);
            sync_flag.push_back(0);
        }
        return row;
    }

    // local SET / cluster converge both funnel here (repo_treg.py _write)
    void write(int64_t row, uint64_t ts, const uint8_t* v, int64_t n) {
        if (!sync_flag[row]) {
            sync_flag[row] = 1;
            sync_dirty.push_back(row);
        }
        if (!pend_set[row]) {
            pend_set[row] = 1;
            pend_ts[row] = ts;
            pend_val[row].assign(reinterpret_cast<const char*>(v), n);
            pend_rows.push_back(row);
        } else if (wins(ts, v, n, pend_ts[row], pend_val[row])) {
            pend_ts[row] = ts;
            pend_val[row].assign(reinterpret_cast<const char*>(v), n);
        }
    }

    void note_delta(int64_t row, uint64_t ts, const uint8_t* v, int64_t n) {
        if (!delta_set[row]) {
            delta_set[row] = 1;
            delta_ts[row] = ts;
            delta_val[row].assign(reinterpret_cast<const char*>(v), n);
            delta_rows.push_back(row);
        } else if (wins(ts, v, n, delta_ts[row], delta_val[row])) {
            delta_ts[row] = ts;
            delta_val[row].assign(reinterpret_cast<const char*>(v), n);
        }
    }

    // serving winner = join(cache, pend); returns false when the row has
    // never been written (GET -> null)
    bool winner(int64_t row, uint64_t* ts, const std::string** val) const {
        if (!cache_set[row] && !pend_set[row]) return false;
        if (!pend_set[row] ||
            (cache_set[row] &&
             !wins(pend_ts[row],
                   reinterpret_cast<const uint8_t*>(pend_val[row].data()),
                   static_cast<int64_t>(pend_val[row].size()), cache_ts[row],
                   cache_val[row]))) {
            *ts = cache_ts[row];
            *val = &cache_val[row];
        } else {
            *ts = pend_ts[row];
            *val = &pend_val[row];
        }
        return true;
    }

    // drain epilogue: the pending window folds into the drained cache
    // (the join both sides already agree on) and clears
    void fold_pending() {
        for (int64_t row : pend_rows) {
            if (!cache_set[row] ||
                wins(pend_ts[row],
                     reinterpret_cast<const uint8_t*>(pend_val[row].data()),
                     static_cast<int64_t>(pend_val[row].size()), cache_ts[row],
                     cache_val[row])) {
                cache_ts[row] = pend_ts[row];
                cache_val[row] = pend_val[row];
                cache_set[row] = 1;
            }
            pend_set[row] = 0;
            pend_val[row].clear();
        }
        pend_rows.clear();
    }
};

// ---- TLOG table ------------------------------------------------------------
//
// Timestamped logs with grow-only cutoff (jylis/repo_tlog.pony:16-111,
// docs tlog.md). Entries intern their value bytes once; the per-row
// merged view (drained ∪ pending, deduped on (ts, value), cutoff-
// filtered) is the SIZE serving surface — the exact mirror of
// models/repo_tlog.py's _merged_set memo, including its validity states.
// The drained "base" carries ACROSS drains: when the memo is current at
// drain time, the post-drain row content is exactly the memo filtered by
// the new cutoff, so SIZE keeps serving natively without ever reading
// the device back.

struct TlogEnt {
    uint64_t ts;
    int32_t vid;
    bool operator==(const TlogEnt& o) const {
        return ts == o.ts && vid == o.vid;
    }
};

struct TlogEntHash {
    size_t operator()(const TlogEnt& e) const {
        uint64_t h = e.ts * 0x9E3779B97F4A7C15ull;
        h ^= static_cast<uint64_t>(static_cast<uint32_t>(e.vid)) + (h >> 29);
        return static_cast<size_t>(h * 0xBF58476D1CE4E5B9ull);
    }
};

using TlogSet = std::unordered_set<TlogEnt, TlogEntHash>;

struct TlogRow {
    std::vector<TlogEnt> pend;  // un-drained entries, arrival order
    uint64_t pend_cutoff = 0;   // max incoming/trim cutoff not yet drained
    bool touched = false;       // in TlogTable::touched_list
    int64_t len_cache = 0;      // drained length (post-cutoff)
    uint64_t cut_cache = 0;     // drained cutoff
    // drained entries as a set-buildable list; valid when it exactly
    // mirrors the device row (maintained across drains via the memo)
    std::vector<TlogEnt> base;
    bool base_valid = true;  // new rows have an empty drained part
    // the merged-view memo: current when (memo_plen, memo_cut) matches
    // (pend.size(), cutoff_view) — repo_tlog.py _merged_set's state key
    TlogSet memo;
    bool memo_valid = false;
    int64_t memo_plen = 0;
    uint64_t memo_cut = 0;
    uint64_t gen = 0;  // bumped whenever the merged view may have changed
    // GET-order memo: the merged view sorted (ts, value-bytes) desc —
    // the native mirror of repo_tlog.py's _sorted cache, keyed by gen
    std::vector<TlogEnt> sorted_view;
    uint64_t sorted_gen = 0;
    bool sorted_valid = false;
    // delta accumulator (hostref.TLog): entry set + grow-only cutoff
    bool delta_present = false;
    TlogSet delta;
    uint64_t delta_cutoff = 0;
    bool sync_flag = false;  // in TlogTable::sync_dirty
};

struct TlogTable {
    KeyIndex idx;
    std::vector<TlogRow> rows;
    // value interner: vid -> bytes, bytes -> vid
    std::vector<std::string> vals;
    std::unordered_map<std::string, int32_t> vmap;
    int64_t pend_rows_count = 0;  // rows with non-empty pend
    bool row_overdue = false;     // some row's pend crossed ROW_DRAIN
    std::vector<int64_t> delta_rows;    // rows with delta_present
    std::vector<int64_t> touched_list;  // rows with pend or pend_cutoff
    std::vector<int64_t> sync_dirty;    // rows changed since last digest
    int64_t live_total = 0;  // sum of len_cache over all rows (O(1) reads)
    int64_t compact_floor;  // value-interner size below which no compact

    static constexpr int64_t ROW_DRAIN_THRESHOLD = 1024;   // repo_tlog.py:40
    static constexpr int64_t PENDING_DRAIN_THRESHOLD = 4096;
    static constexpr int64_t VAL_COMPACT_SLACK = 8192;

    TlogTable() : compact_floor(VAL_COMPACT_SLACK) {}

    int32_t intern(const uint8_t* v, int64_t n) {
        std::string s(reinterpret_cast<const char*>(v), n);
        auto it = vmap.find(s);
        if (it != vmap.end()) return it->second;
        int32_t id = static_cast<int32_t>(vals.size());
        vals.push_back(std::move(s));
        vmap.emplace(vals.back(), id);
        return id;
    }

    int64_t upsert(const uint8_t* k, int64_t n) {
        auto [row, fresh] = idx.upsert(k, n);
        if (fresh) rows.emplace_back();
        return row;
    }

    uint64_t cutoff_view(const TlogRow& r) const {
        return r.pend_cutoff > r.cut_cache ? r.pend_cutoff : r.cut_cache;
    }

    bool quiescent(const TlogRow& r) const {
        return r.pend.empty() && r.pend_cutoff <= r.cut_cache;
    }

    bool memo_current(const TlogRow& r) const {
        return r.memo_valid &&
               r.memo_plen == static_cast<int64_t>(r.pend.size()) &&
               r.memo_cut == cutoff_view(r);
    }

    void touch(TlogRow& r, int64_t row_i) {
        if (!r.touched) {
            r.touched = true;
            touched_list.push_back(row_i);
        }
        mark_sync(r, row_i);
    }

    void mark_sync(TlogRow& r, int64_t row_i) {
        if (!r.sync_flag) {
            r.sync_flag = true;
            sync_dirty.push_back(row_i);
        }
    }

    void append_pend(TlogRow& r, int64_t row_i, TlogEnt e) {
        if (r.pend.empty()) pend_rows_count++;
        r.pend.push_back(e);
        touch(r, row_i);
        if (static_cast<int64_t>(r.pend.size()) >= ROW_DRAIN_THRESHOLD)
            row_overdue = true;
    }

    // local INS (repo_tlog.py apply INS): pend append + memo upkeep
    // (_note_local_insert) + delta insert when ts clears the drained
    // cutoff
    void ins(int64_t row_i, uint64_t ts, const uint8_t* v, int64_t n) {
        TlogRow& r = rows[row_i];
        TlogEnt e{ts, intern(v, n)};
        append_pend(r, row_i, e);
        r.gen++;
        if (r.memo_valid) {
            uint64_t cut = cutoff_view(r);
            if (r.memo_plen != static_cast<int64_t>(r.pend.size()) - 1 ||
                r.memo_cut != cut) {
                r.memo_valid = false;
                TlogSet().swap(r.memo);  // free, don't retain dead sets
            } else {
                if (ts >= cut) r.memo.insert(e);
                r.memo_plen = static_cast<int64_t>(r.pend.size());
                r.memo_cut = cut;
            }
        }
        if (ts >= r.cut_cache) {
            if (!r.delta_present) {
                r.delta_present = true;
                delta_rows.push_back(row_i);
            }
            if (ts >= r.delta_cutoff) r.delta.insert(e);
        }
    }

    // cluster converge: entries/cutoff buffer without memo upkeep (the
    // memo's state key goes stale, exactly like the Python dict path)
    void converge_entry(int64_t row_i, uint64_t ts, const uint8_t* v,
                        int64_t n) {
        TlogRow& r = rows[row_i];
        append_pend(r, row_i, TlogEnt{ts, intern(v, n)});
        r.gen++;
    }

    void raise_pend_cutoff(int64_t row_i, uint64_t c) {
        TlogRow& r = rows[row_i];
        if (c > r.pend_cutoff) {
            r.pend_cutoff = c;
            touch(r, row_i);
            r.gen++;
        }
    }

    // merged-view size; -1 when the drained base is unknown (Python
    // rebuilds it from a device gather and calls set_base)
    int64_t size(int64_t row_i) {
        TlogRow& r = rows[row_i];
        if (quiescent(r)) return r.len_cache;
        if (memo_current(r)) return static_cast<int64_t>(r.memo.size());
        if (!r.base_valid) return -1;
        uint64_t cut = cutoff_view(r);
        r.memo.clear();
        for (const TlogEnt& e : r.base)
            if (e.ts >= cut) r.memo.insert(e);
        for (const TlogEnt& e : r.pend)
            if (e.ts >= cut) r.memo.insert(e);
        r.memo_valid = true;
        r.memo_plen = static_cast<int64_t>(r.pend.size());
        r.memo_cut = cut;
        r.gen++;
        return static_cast<int64_t>(r.memo.size());
    }

    // the merged view sorted (ts, value-bytes) desc — TLOG GET's serving
    // order (repo_tlog.py _merged_view). Returns nullptr when the drained
    // base is unknown (Python rebuilds it from a device gather) — the
    // caller defers the command. Cached per row, keyed by gen.
    const std::vector<TlogEnt>* sorted_view_of(int64_t row_i) {
        TlogRow& r = rows[row_i];
        if (size(row_i) < 0) return nullptr;  // base unknown: defer
        if (r.sorted_valid && r.sorted_gen == r.gen) return &r.sorted_view;
        r.sorted_view.clear();
        if (quiescent(r)) {
            if (!r.base_valid) return nullptr;  // device row render needed
            r.sorted_view = r.base;
        } else if (memo_current(r)) {
            r.sorted_view.assign(r.memo.begin(), r.memo.end());
        } else {
            return nullptr;  // unreachable after size() >= 0; stay safe
        }
        std::sort(r.sorted_view.begin(), r.sorted_view.end(),
                  [this](const TlogEnt& a, const TlogEnt& b) {
                      if (a.ts != b.ts) return a.ts > b.ts;
                      return vals[b.vid] < vals[a.vid];  // value desc
                  });
        r.sorted_valid = true;
        r.sorted_gen = r.gen;
        return &r.sorted_view;
    }

    static void drop_sorted(TlogRow& r) {
        r.sorted_valid = false;
        std::vector<TlogEnt>().swap(r.sorted_view);
    }

    // drain epilogue for one drained row: device reported (len, cut)
    void finish_drain_row(int64_t row_i, int64_t len, uint64_t cut) {
        TlogRow& r = rows[row_i];
        drop_sorted(r);  // free rather than wait for the gen-key miss
        bool memo_cur = memo_current(r);
        if (memo_cur) {
            r.base.clear();
            for (const TlogEnt& e : r.memo)
                if (e.ts >= cut) r.base.push_back(e);
            r.base_valid = static_cast<int64_t>(r.base.size()) == len;
        } else {
            r.base.clear();
            r.base_valid = (len == 0);
        }
        mark_sync(r, row_i);  // a fused trim can change the merged view
        live_total += len - r.len_cache;
        r.len_cache = len;
        r.cut_cache = cut;
        if (!r.pend.empty()) pend_rows_count--;
        r.pend.clear();
        r.pend_cutoff = 0;
        if (r.base_valid) {
            r.memo.clear();
            r.memo.insert(r.base.begin(), r.base.end());
            r.memo_valid = true;
            r.memo_plen = 0;
            r.memo_cut = cutoff_view(r);
        } else {
            r.memo_valid = false;
            r.memo.clear();
        }
        r.gen++;
    }

    // global drain tail: mirrors repo_tlog.py _finish_drain's
    // pend.clear() across every row + flag reset
    void finish_drain_end() {
        for (int64_t row_i : touched_list) {
            TlogRow& r = rows[row_i];
            r.touched = false;
            if (!r.pend.empty()) {  // touched but not in the drain set:
                r.pend.clear();     // cannot happen under the repo lock,
                r.memo_valid = false;  // but mirror the global clear
                r.gen++;
            }
            r.pend_cutoff = 0;
        }
        touched_list.clear();
        pend_rows_count = 0;
        row_overdue = false;
    }

    // value-interner epoch compaction (the host analog of the repo's
    // device-vid _maybe_compact_interner): once the table holds far more
    // strings than the live entry set references, remap every live vid
    // and drop the garbage. Returns true when a remap happened — callers
    // holding vid->bytes mirrors must reset them.
    bool compact_values() {
        if (static_cast<int64_t>(vals.size()) < compact_floor) return 0;
        std::vector<char> mark(vals.size(), 0);
        int64_t live = 0;
        auto see = [&](const TlogEnt& e) {
            if (e.vid >= 0 && !mark[e.vid]) {
                mark[e.vid] = 1;
                live++;
            }
        };
        for (TlogRow& r : rows) {
            for (const TlogEnt& e : r.pend) see(e);
            for (const TlogEnt& e : r.base) see(e);
            if (memo_current(r)) {
                for (const TlogEnt& e : r.memo) see(e);
            } else if (!r.memo.empty()) {
                // a state-stale memo (e.g. converge_entry appended past
                // it) is dead weight: free it rather than keeping its
                // vids alive through the compaction
                r.memo_valid = false;
                TlogSet().swap(r.memo);
            }
            for (const TlogEnt& e : r.delta) see(e);
        }
        if (static_cast<int64_t>(vals.size()) <= 2 * live + VAL_COMPACT_SLACK) {
            // genuinely live: raise the floor so the walk stays amortised
            compact_floor = static_cast<int64_t>(vals.size()) + VAL_COMPACT_SLACK;
            return 0;
        }
        std::vector<int32_t> remap(vals.size(), -1);
        std::vector<std::string> fresh;
        fresh.reserve(live);
        for (size_t i = 0; i < vals.size(); i++) {
            if (mark[i]) {
                remap[i] = static_cast<int32_t>(fresh.size());
                fresh.push_back(std::move(vals[i]));
            }
        }
        vals.swap(fresh);
        vmap.clear();
        for (size_t i = 0; i < vals.size(); i++)
            vmap.emplace(vals[i], static_cast<int32_t>(i));
        auto fix_vec = [&](std::vector<TlogEnt>& v) {
            for (TlogEnt& e : v)
                if (e.vid >= 0) e.vid = remap[e.vid];
        };
        auto fix_set = [&](TlogSet& s) {
            TlogSet out;
            out.reserve(s.size());
            for (TlogEnt e : s) {
                if (e.vid >= 0) e.vid = remap[e.vid];
                out.insert(e);
            }
            s.swap(out);
        };
        for (TlogRow& r : rows) {
            fix_vec(r.pend);
            fix_vec(r.base);
            fix_set(r.memo);
            fix_set(r.delta);
            // the GET-order cache holds vids too; a stale (old-gen) copy
            // may reference dead ids the remap never saw — drop it
            drop_sorted(r);
        }
        compact_floor =
            2 * static_cast<int64_t>(vals.size()) + VAL_COMPACT_SLACK;
        return 1;
    }
};

// ---- UJSON serving memo ----------------------------------------------------
//
// The ORSWOT document lattice stays in Python (host docs) or on the
// device (resident rows) — the engine never owns it. What it owns is the
// RENDER memo: per key, the exact reply bytes the Python oracle produced
// for `UJSON GET key [path...]`, keyed by the path argument vector. The
// Python GET path installs an entry after serving (repo_ujson.py), and
// every write invalidates the overlapping entries — natively at
// queue-bank time, from Python on converge/apply. This mirrors the TLOG
// merged-view memo contract: the memo is only ever a cache of what the
// oracle already rendered, a miss defers to Python (which repairs the
// memo while serving), and staleness is impossible because invalidation
// happens under the same repo-lock boundary as the write itself.
//
// Path keys are length-prefixed blobs (u32 len + bytes per component),
// which makes component-prefix exactly byte-prefix — so the precise
// invalidation rules are cheap:
//   * INS/RM at path p change only renders at paths q ⊆ p (q a prefix
//     of p): deeper disjoint subtrees keep serving natively;
//   * SET/CLR at p rewrite the subtree: q ⊆ p or p ⊆ q invalidates.

struct UjsonTable {
    KeyIndex idx;
    // row -> path-blob -> full reply payload ($len\r\nrender\r\n)
    std::vector<std::unordered_map<std::string, std::string>> memo;

    // renders cached per key; above this the row's map resets (GET paths
    // per key are few in practice — the cap only bounds pathology)
    static constexpr size_t MEMO_PER_KEY = 8;

    int64_t upsert(const uint8_t* k, int64_t n) {
        auto [row, fresh] = idx.upsert(k, n);
        if (fresh) memo.emplace_back();
        return row;
    }

    void put(int64_t row, std::string path, std::string reply) {
        auto& m = memo[row];
        if (m.size() >= MEMO_PER_KEY && m.find(path) == m.end()) m.clear();
        m[std::move(path)] = std::move(reply);
    }

    const std::string* get(int64_t row, const std::string& path) const {
        const auto& m = memo[row];
        auto it = m.find(path);
        return it == m.end() ? nullptr : &it->second;
    }

    static bool is_prefix(const std::string& a, const std::string& b) {
        return a.size() <= b.size() &&
               memcmp(a.data(), b.data(), a.size()) == 0;
    }

    // invalidate the renders a write at `path` can change; subtree=true
    // for SET/CLR (both prefix directions), false for INS/RM
    void invalidate(int64_t row, const std::string& path, bool subtree) {
        auto& m = memo[row];
        for (auto it = m.begin(); it != m.end();) {
            bool hit = is_prefix(it->first, path) ||
                       (subtree && is_prefix(path, it->first));
            it = hit ? m.erase(it) : std::next(it);
        }
    }
};

// ---- UJSON value validators ------------------------------------------------
//
// A natively banked write replies +OK immediately, so the one thing the
// engine must prove is that the oracle's later apply CANNOT raise — i.e.
// the value arg parses as Python's json.loads would parse it
// (ops/ujson_host.py parse_value/parse_doc; the token actually stored is
// the oracle's own canonical dumps, so no round-trip identity is needed
// for equivalence). These validators accept exactly Python's strict JSON
// grammar: escape-bearing and \uXXXX strings, raw UTF-8 (the oracle
// decodes argument bytes with errors="replace", so any byte >= 0x20 is
// parseable), full int/frac/exp numbers, and the NaN/Infinity literals
// json.loads allows by default. Raw control bytes inside strings, bad
// escapes, leading zeros, lone '-', and trailing garbage all bounce.

inline bool json_ws(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

// returns index past the closing quote, or -1
inline int64_t scan_json_string(const uint8_t* p, int64_t n, int64_t i) {
    i++;  // opening quote
    while (i < n) {
        uint8_t c = p[i];
        if (c == '"') return i + 1;
        if (c < 0x20) return -1;  // strict mode rejects raw controls
        if (c == '\\') {
            if (i + 1 >= n) return -1;
            uint8_t e = p[i + 1];
            if (e == 'u') {
                if (i + 5 >= n) return -1;
                for (int64_t j = i + 2; j < i + 6; j++) {
                    uint8_t h = p[j];
                    if (!((h >= '0' && h <= '9') || (h >= 'a' && h <= 'f') ||
                          (h >= 'A' && h <= 'F')))
                        return -1;
                }
                i += 6;
                continue;
            }
            if (e != '"' && e != '\\' && e != '/' && e != 'b' && e != 'f' &&
                e != 'n' && e != 'r' && e != 't')
                return -1;
            i += 2;
            continue;
        }
        i++;  // any other byte incl. raw UTF-8 (replace-decoded oracle-side)
    }
    return -1;
}

// Python json's number regex: -?(0|[1-9]\d*)(\.\d+)?([eE][+-]?\d+)?
// int() refuses digit strings past sys.int_max_str_digits (4300 by
// default), so an INTEGER token that long makes json.loads raise — stay
// comfortably below so a banked +OK can never turn into a late crash at
// queue-flush time (floats parse via float(), which has no such limit)
constexpr int64_t JSON_INT_DIGITS_MAX = 4000;

inline int64_t scan_json_number(const uint8_t* p, int64_t n, int64_t i) {
    if (i < n && p[i] == '-') i++;
    if (i >= n) return -1;
    int64_t int_start = i;
    if (p[i] == '0') {
        i++;
    } else if (p[i] >= '1' && p[i] <= '9') {
        while (i < n && p[i] >= '0' && p[i] <= '9') i++;
    } else {
        return -1;
    }
    if ((i >= n || (p[i] != '.' && p[i] != 'e' && p[i] != 'E')) &&
        i - int_start > JSON_INT_DIGITS_MAX)
        return -1;  // integer token: Python's int() conversion would raise
    if (i < n && p[i] == '.') {
        i++;
        if (i >= n || p[i] < '0' || p[i] > '9') return -1;
        while (i < n && p[i] >= '0' && p[i] <= '9') i++;
    }
    if (i < n && (p[i] == 'e' || p[i] == 'E')) {
        i++;
        if (i < n && (p[i] == '+' || p[i] == '-')) i++;
        if (i >= n || p[i] < '0' || p[i] > '9') return -1;
        while (i < n && p[i] >= '0' && p[i] <= '9') i++;
    }
    return i;
}

inline bool word_at(const uint8_t* p, int64_t n, int64_t i, const char* w) {
    int64_t wn = static_cast<int64_t>(strlen(w));
    return i + wn <= n && memcmp(p + i, w, static_cast<size_t>(wn)) == 0;
}

// literal constants json.loads accepts (allow_nan default); returns end
// index or -1
inline int64_t scan_json_literal(const uint8_t* p, int64_t n, int64_t i) {
    for (const char* w : {"true", "false", "null", "NaN", "Infinity",
                          "-Infinity"})
        if (word_at(p, n, i, w)) return i + static_cast<int64_t>(strlen(w));
    return -1;
}

// full JSON value (objects/arrays too), depth-capped so a pathologically
// nested doc defers to Python instead of recursing here; returns end or -1
inline int64_t scan_json_value(const uint8_t* p, int64_t n, int64_t i,
                               int depth) {
    if (depth <= 0) return -1;
    while (i < n && json_ws(p[i])) i++;
    if (i >= n) return -1;
    uint8_t c = p[i];
    if (c == '"') return scan_json_string(p, n, i);
    if (c == '{') {
        i++;
        while (i < n && json_ws(p[i])) i++;
        if (i < n && p[i] == '}') return i + 1;
        while (true) {
            while (i < n && json_ws(p[i])) i++;
            if (i >= n || p[i] != '"') return -1;
            i = scan_json_string(p, n, i);
            if (i < 0) return -1;
            while (i < n && json_ws(p[i])) i++;
            if (i >= n || p[i] != ':') return -1;
            i = scan_json_value(p, n, i + 1, depth - 1);
            if (i < 0) return -1;
            while (i < n && json_ws(p[i])) i++;
            if (i < n && p[i] == ',') {
                i++;
                continue;
            }
            if (i < n && p[i] == '}') return i + 1;
            return -1;
        }
    }
    if (c == '[') {
        i++;
        while (i < n && json_ws(p[i])) i++;
        if (i < n && p[i] == ']') return i + 1;
        while (true) {
            i = scan_json_value(p, n, i, depth - 1);
            if (i < 0) return -1;
            while (i < n && json_ws(p[i])) i++;
            if (i < n && p[i] == ',') {
                i++;
                continue;
            }
            if (i < n && p[i] == ']') return i + 1;
            return -1;
        }
    }
    {
        int64_t e = scan_json_literal(p, n, i);
        if (e >= 0) return e;
    }
    if (c == '-' || (c >= '0' && c <= '9')) return scan_json_number(p, n, i);
    return -1;
}

// strict UTF-8 validity (no overlongs, no surrogates, max U+10FFFF).
// The render memo is keyed on CANONICAL path bytes — the UTF-8 encoding
// of the errors="replace" decode the oracle applies — and valid UTF-8
// is exactly the class where raw bytes == canonical bytes. Writes whose
// path components fail this defer to Python, whose invalidation
// canonicalises (native/engine.py uj_invalidate), so byte-distinct
// paths that decode identically can never leave a stale memo behind.
inline bool utf8_valid(const uint8_t* p, int64_t n) {
    int64_t i = 0;
    while (i < n) {
        uint8_t c = p[i];
        if (c < 0x80) {
            i++;
            continue;
        }
        int len;
        uint32_t cp;
        if ((c & 0xE0) == 0xC0) {
            len = 2;
            cp = c & 0x1F;
        } else if ((c & 0xF0) == 0xE0) {
            len = 3;
            cp = c & 0x0F;
        } else if ((c & 0xF8) == 0xF0) {
            len = 4;
            cp = c & 0x07;
        } else {
            return false;
        }
        if (i + len > n) return false;
        for (int j = 1; j < len; j++) {
            if ((p[i + j] & 0xC0) != 0x80) return false;
            cp = (cp << 6) | (p[i + j] & 0x3F);
        }
        if (len == 2 && cp < 0x80) return false;          // overlong
        if (len == 3 && cp < 0x800) return false;         // overlong
        if (len == 4 && cp < 0x10000) return false;       // overlong
        if (cp >= 0xD800 && cp <= 0xDFFF) return false;   // surrogate
        if (cp > 0x10FFFF) return false;
        i += len;
    }
    return true;
}

// INS/RM value: a JSON *primitive* (parse_value raises on containers)
inline bool ujson_prim_ok(const uint8_t* p, int64_t n) {
    int64_t i = 0;
    while (i < n && json_ws(p[i])) i++;
    if (i >= n) return false;
    int64_t e;
    if (p[i] == '"') {
        e = scan_json_string(p, n, i);
    } else if ((e = scan_json_literal(p, n, i)) < 0) {
        e = scan_json_number(p, n, i);
    }
    if (e < 0) return false;
    while (e < n && json_ws(p[e])) e++;
    return e == n;
}

// SET value: any JSON document (parse_doc takes containers too)
inline bool ujson_doc_ok(const uint8_t* p, int64_t n) {
    int64_t e = scan_json_value(p, n, 0, 64);
    if (e < 0) return false;
    while (e < n && json_ws(p[e])) e++;
    return e == n;
}

// ---- UJSON write queue -----------------------------------------------------
//
// UJSON INS/SET/RM/CLR are applied by the ORACLE at queue-flush time
// (repo_ujson.py _flush_queue, which runs before any other UJSON work in
// arrival order — per-connection ordering and the observe-first
// delta/lattice semantics are exactly the reference's). The engine's job
// is validate-and-bank: prove the later apply cannot raise (the value
// validators above), record the raw argument slices, invalidate the
// overlapping render memos, and reply +OK.

struct UjsonQueue {
    // blob layout per command: u32 argc, then per arg u32 len + bytes
    std::vector<uint8_t> blob;
    int64_t count = 0;

    static constexpr int64_t MAX_CMDS = 65536;
    static constexpr size_t MAX_BYTES = 16u << 20;

    bool full() const {
        return count >= MAX_CMDS || blob.size() >= MAX_BYTES;
    }

    void push(const uint8_t* buf, const int64_t* offs, const int64_t* lens,
              int32_t argc) {
        uint32_t n = static_cast<uint32_t>(argc);
        const uint8_t* np = reinterpret_cast<const uint8_t*>(&n);
        blob.insert(blob.end(), np, np + 4);
        for (int32_t i = 0; i < argc; i++) {
            uint32_t ln = static_cast<uint32_t>(lens[i]);
            const uint8_t* lp = reinterpret_cast<const uint8_t*>(&ln);
            blob.insert(blob.end(), lp, lp + 4);
            blob.insert(blob.end(), buf + offs[i], buf + offs[i] + lens[i]);
        }
        count++;
    }

    void clear() {
        blob.clear();
        count = 0;
    }
};

// ---- the engine ------------------------------------------------------------

struct Engine {
    Table t[2];  // 0 = GCOUNT, 1 = PNCOUNT
    TregTable treg;
    TlogTable tlog;
    UjsonQueue uq;
    UjsonTable uj;
    // commands settled natively, per type (G, PN, TREG, TLOG, UJSON) —
    // reads included; deferred commands count on the Python side instead
    // (models/manager.py _apply_core's per-Database tally). SYSTEM
    // METRICS reports the sum.
    uint64_t served[5] = {0, 0, 0, 0, 0};
};

// ---- shared formatting / parsing helpers -----------------------------------

inline int64_t digits10(uint64_t v) {
    int64_t n = 1;
    while (v >= 10) {
        v /= 10;
        n++;
    }
    return n;
}

inline int64_t fmt_u64(uint8_t* out, uint64_t v) {
    char tmp[24];
    int n = 0;
    do {
        tmp[n++] = static_cast<char>('0' + v % 10);
        v /= 10;
    } while (v);
    for (int i = 0; i < n; i++) out[i] = static_cast<uint8_t>(tmp[n - 1 - i]);
    return n;
}

inline int64_t fmt_int_reply(uint8_t* out, uint64_t bits, bool signed_i64) {
    int64_t n = 0;
    out[n++] = ':';
    if (signed_i64 && static_cast<int64_t>(bits) < 0) {
        out[n++] = '-';
        bits = ~bits + 1;  // unsigned-domain negate: defined for INT64_MIN
    }
    n += fmt_u64(out + n, bits);
    out[n++] = '\r';
    out[n++] = '\n';
    return n;
}

// strict u64 parse: ASCII digits only, must fit (models/base.py parse_u64)
inline bool parse_amount(const uint8_t* s, int64_t n, uint64_t* out) {
    if (n <= 0) return false;
    uint64_t v = 0;
    for (int64_t i = 0; i < n; i++) {
        if (s[i] < '0' || s[i] > '9') return false;
        uint64_t d = static_cast<uint64_t>(s[i] - '0');
        if (v > (UINT64_MAX - d) / 10) return false;
        v = v * 10 + d;
    }
    *out = v;
    return true;
}

inline bool word_is(const uint8_t* buf, int64_t off, int64_t len,
                    const char* w) {
    int64_t n = static_cast<int64_t>(strlen(w));
    return len == n && memcmp(buf + off, w, static_cast<size_t>(n)) == 0;
}

}  // namespace jy
