// Native UJSON wire fast paths: split a PushDeltas body into per-key
// payload spans (the lazy WireUJSON receive path) and encode raw delta
// payloads straight into the packed device planes the resident store
// folds (jylis_tpu/ops/ujson_resident.py) — replica-id interning against
// the store's global columns and payload interning by canonical wire
// bytes happen here, so the per-delta Python cost on the anti-entropy
// hot path drops to array bookkeeping.
//
// Wire shape (cluster/codec.py _SCHEMA_TEXT, delta/UJSON):
//   entries: varint n, then per entry varint rid, varint seq,
//            varint n_path, n_path strings, token string
//   vv:      varint n, then per item varint rid, varint val
//   cloud:   varint n, then per item varint rid, varint seq
// (strings are varint-length-prefixed utf-8)
//
// Return conventions: 0 ok; -1 malformed; -2 value outside the requested
// layout (seq/col past the shift packing, vv past u32, varint past u64);
// -3 replica columns exceeded the vv plane width (caller grows and
// retries). The split validates utf-8 up front so that the Python-side
// lazy materialisation can never fail mid-serving.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Reader {
  const uint8_t* base;
  const uint8_t* p;
  const uint8_t* end;
  int rc = 0;  // sticky: 0 ok, -1 malformed, -2 unsupported

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (true) {
      if (p >= end) {
        rc = rc ? rc : -1;
        return 0;
      }
      uint8_t b = *p++;
      if (shift >= 64 && (b & 0x7f)) {
        rc = rc ? rc : -2;
        return 0;
      }
      if (shift == 63 && (b & 0x7e)) {
        rc = rc ? rc : -2;
        return 0;
      }
      if (shift < 64) v |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 70) {
        rc = rc ? rc : -1;
        return 0;
      }
    }
  }
  int64_t count() {
    uint64_t v = varint();
    if (rc) return 0;
    if (v > static_cast<uint64_t>(end - p)) {
      rc = -1;
      return 0;
    }
    return static_cast<int64_t>(v);
  }
  int64_t bytes(int64_t* len_out) {
    uint64_t n = varint();
    if (rc) return 0;
    if (static_cast<uint64_t>(end - p) < n) {
      rc = -1;
      return 0;
    }
    int64_t off = p - base;
    p += n;
    *len_out = static_cast<int64_t>(n);
    return off;
  }
  bool done() const { return rc == 0 && p == end; }
};

bool utf8_valid(const uint8_t* s, int64_t n) {
  int64_t i = 0;
  while (i < n) {
    uint8_t b = s[i];
    if (b < 0x80) {
      i++;
    } else if ((b & 0xe0) == 0xc0) {
      if (i + 1 >= n || (s[i + 1] & 0xc0) != 0x80 || b < 0xc2) return false;
      i += 2;
    } else if ((b & 0xf0) == 0xe0) {
      if (i + 2 >= n || (s[i + 1] & 0xc0) != 0x80 || (s[i + 2] & 0xc0) != 0x80)
        return false;
      // reject overlongs and surrogates like Python's decoder does
      if (b == 0xe0 && s[i + 1] < 0xa0) return false;
      if (b == 0xed && s[i + 1] >= 0xa0) return false;
      i += 3;
    } else if ((b & 0xf8) == 0xf0) {
      if (i + 3 >= n || (s[i + 1] & 0xc0) != 0x80 ||
          (s[i + 2] & 0xc0) != 0x80 || (s[i + 3] & 0xc0) != 0x80)
        return false;
      if (b == 0xf0 && s[i + 1] < 0x90) return false;
      if (b > 0xf4 || (b == 0xf4 && s[i + 1] >= 0x90)) return false;
      i += 4;
    } else {
      return false;
    }
  }
  return true;
}

// walk one delta payload; optionally validate utf-8; track counts + max seq
void walk_delta(Reader& r, bool check_utf8, int64_t* n_entries,
                int64_t* n_vv, int64_t* n_cloud, uint64_t* max_seq) {
  uint64_t ms = 0;
  int64_t ne = r.count();
  for (int64_t i = 0; i < ne && !r.rc; i++) {
    r.varint();  // rid
    uint64_t seq = r.varint();
    if (seq > ms) ms = seq;
    int64_t np = r.count();
    for (int64_t j = 0; j <= np && !r.rc; j++) {
      int64_t len;
      int64_t off = r.bytes(&len);
      if (!r.rc && check_utf8 && !utf8_valid(r.base + off, len)) {
        r.rc = -2;  // the oracle raises CodecError; fast path declines
      }
    }
  }
  int64_t nv = r.count();
  for (int64_t i = 0; i < nv && !r.rc; i++) {
    r.varint();
    uint64_t v = r.varint();
    if (v > ms) ms = v;
  }
  int64_t nc = r.count();
  for (int64_t i = 0; i < nc && !r.rc; i++) {
    r.varint();
    uint64_t seq = r.varint();
    if (seq > ms) ms = seq;
  }
  *n_entries = ne;
  *n_vv = nv;
  *n_cloud = nc;
  *max_seq = ms;
}

// open-addressing u64 -> int32 map (replica-id interning)
struct U64Map {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  std::vector<int64_t> slots;  // -1 empty

  explicit U64Map(int64_t expect) {
    int64_t cap = 16;
    while (cap < expect * 2) cap <<= 1;
    slots.assign(static_cast<size_t>(cap), -1);
  }
  static uint64_t hash(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    return k;
  }
  void grow() {
    std::vector<int64_t> ns(slots.size() * 2, -1);
    size_t m = ns.size() - 1;
    for (size_t i = 0; i < keys.size(); i++) {
      size_t s = hash(keys[i]) & m;
      while (ns[s] >= 0) s = (s + 1) & m;
      ns[s] = static_cast<int64_t>(i);
    }
    slots.swap(ns);
  }
  int32_t get_or_add(uint64_t k, bool* added) {
    size_t m = slots.size() - 1;
    size_t s = hash(k) & m;
    while (slots[s] >= 0) {
      if (keys[static_cast<size_t>(slots[s])] == k) {
        *added = false;
        return vals[static_cast<size_t>(slots[s])];
      }
      s = (s + 1) & m;
    }
    int32_t id = static_cast<int32_t>(keys.size());
    slots[s] = static_cast<int64_t>(keys.size());
    keys.push_back(k);
    vals.push_back(id);
    *added = true;
    if (keys.size() * 10 >= slots.size() * 7) grow();
    return id;
  }
};

// open-addressing byte-span -> int32 map (payload interning)
struct SpanMap {
  const uint8_t* base;
  std::vector<int64_t> offs;
  std::vector<int64_t> lens;
  std::vector<uint64_t> hashes;
  std::vector<int64_t> slots;

  explicit SpanMap(const uint8_t* b, int64_t expect) : base(b) {
    int64_t cap = 16;
    while (cap < expect * 2) cap <<= 1;
    slots.assign(static_cast<size_t>(cap), -1);
  }
  static uint64_t hash(const uint8_t* s, int64_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t i = 0; i < n; i++) {
      h ^= s[i];
      h *= 1099511628211ULL;
    }
    return h;
  }
  void grow() {
    std::vector<int64_t> ns(slots.size() * 2, -1);
    size_t m = ns.size() - 1;
    for (size_t i = 0; i < offs.size(); i++) {
      size_t s = hashes[i] & m;
      while (ns[s] >= 0) s = (s + 1) & m;
      ns[s] = static_cast<int64_t>(i);
    }
    slots.swap(ns);
  }
  int32_t get_or_add(int64_t off, int64_t len) {
    uint64_t h = hash(base + off, len);
    size_t m = slots.size() - 1;
    size_t s = h & m;
    while (slots[s] >= 0) {
      size_t r = static_cast<size_t>(slots[s]);
      if (hashes[r] == h && lens[r] == len &&
          memcmp(base + offs[r], base + off, static_cast<size_t>(len)) == 0) {
        return static_cast<int32_t>(r);
      }
      s = (s + 1) & m;
    }
    int32_t id = static_cast<int32_t>(offs.size());
    slots[s] = static_cast<int64_t>(offs.size());
    offs.push_back(off);
    lens.push_back(len);
    hashes.push_back(h);
    if (offs.size() * 10 >= slots.size() * 7) grow();
    return id;
  }
};

}  // namespace

extern "C" {

// ---- PushDeltas body split (past tag + name) -------------------------------

int32_t jy_ujson_split_measure(const uint8_t* body, int64_t body_len,
                               int64_t* n_keys_out) {
  Reader r{body, body, body + body_len};
  int64_t n_keys = r.count();
  for (int64_t k = 0; k < n_keys && !r.rc; k++) {
    int64_t klen;
    r.bytes(&klen);
    int64_t ne, nv, nc;
    uint64_t ms;
    walk_delta(r, /*check_utf8=*/true, &ne, &nv, &nc, &ms);
  }
  if (r.rc) return r.rc;
  if (!r.done()) return -1;
  *n_keys_out = n_keys;
  return 0;
}

int32_t jy_ujson_split(const uint8_t* body, int64_t body_len, int64_t* key_off,
                       int64_t* key_len, int64_t* pay_off, int64_t* pay_len,
                       int64_t* n_entries, int64_t* n_vv, int64_t* n_cloud,
                       uint64_t* max_seq) {
  Reader r{body, body, body + body_len};
  int64_t n_keys = r.count();
  for (int64_t k = 0; k < n_keys && !r.rc; k++) {
    key_off[k] = r.bytes(&key_len[k]);
    int64_t start = r.p - r.base;
    walk_delta(r, /*check_utf8=*/false, &n_entries[k], &n_vv[k], &n_cloud[k],
               &max_seq[k]);
    pay_off[k] = start;
    pay_len[k] = (r.p - r.base) - start;
  }
  return r.rc;
}

// ---- wire -> device planes -------------------------------------------------
// Planes are pre-filled by the caller (dots/cloud with the layout's pad,
// pay with -1, vv with 0). dest_rows maps delta i to its plane row.

int32_t jy_ujson_grid_fill(
    const uint8_t* blob, int64_t n_deltas, const int64_t* d_off,
    const int64_t* d_len, const int64_t* dest_rows, int32_t shift, int64_t w,
    int64_t c, int64_t n_rep, const uint64_t* known_rids, int64_t n_known,
    void* dots_v, int32_t* pay, uint32_t* vv, void* cloud_v,
    uint64_t* new_rids_out, int64_t* n_new_out, int64_t* pay_span_off,
    int64_t* pay_span_len, int64_t* n_pays_out, int64_t* rids_seen_out) {
  const bool narrow = shift < 32;
  const uint64_t seq_cap = 1ULL << shift;
  const uint64_t col_cap = narrow ? (1ULL << (31 - shift))
                                  : 0x100000000ULL;
  const int32_t pad32 = 0x7fffffff;
  const uint64_t pad64 = 0xffffffffffffffffULL;
  int32_t* dots32 = static_cast<int32_t*>(dots_v);
  uint64_t* dots64 = static_cast<uint64_t*>(dots_v);
  int32_t* cloud32 = static_cast<int32_t*>(cloud_v);
  uint64_t* cloud64 = static_cast<uint64_t*>(cloud_v);

  U64Map rid_map(n_known + 64);
  for (int64_t i = 0; i < n_known; i++) {
    bool added;
    rid_map.get_or_add(known_rids[i], &added);
    if (!added) return -1;  // duplicate in the caller's column list
  }
  SpanMap pay_map(blob, 256);

  std::vector<std::pair<uint64_t, int32_t>> row;   // (packed, local pay)
  std::vector<uint64_t> crow;                      // packed cloud
  int rc_budget = 0;

  for (int64_t i = 0; i < n_deltas; i++) {
    Reader r{blob, blob + d_off[i], blob + d_off[i] + d_len[i]};
    int64_t base_row = dest_rows[i];
    row.clear();
    crow.clear();
    int64_t ne = r.count();
    if (ne > w) return -1;  // caller sized w from the measured counts
    for (int64_t e = 0; e < ne && !r.rc; e++) {
      uint64_t rid = r.varint();
      uint64_t seq = r.varint();
      int64_t span_start = r.p - r.base;
      int64_t np = r.count();
      int64_t len;
      for (int64_t j = 0; j <= np && !r.rc; j++) r.bytes(&len);
      if (r.rc) break;
      int64_t span_len = (r.p - r.base) - span_start;
      bool added;
      int32_t col = rid_map.get_or_add(rid, &added);
      // budget first: exceeding the vv plane is the caller's decision
      // (grow columns, maybe re-pack narrower) — keep walking so
      // rids_seen reports the full need
      if (col >= n_rep) {
        rc_budget = 1;
        continue;
      }
      if (static_cast<uint64_t>(col) >= col_cap) return -2;
      if (seq >= seq_cap || seq == 0xffffffffffffffffULL) return -2;
      uint64_t packed =
          (static_cast<uint64_t>(col) << shift) | seq;
      if (narrow && packed == static_cast<uint64_t>(pad32)) return -2;
      if (!narrow && packed == pad64) return -2;
      int32_t pid = pay_map.get_or_add(span_start, span_len);
      row.emplace_back(packed, pid);
    }
    int64_t nv = r.count();
    for (int64_t e = 0; e < nv && !r.rc; e++) {
      uint64_t rid = r.varint();
      uint64_t val = r.varint();
      bool added;
      int32_t col = rid_map.get_or_add(rid, &added);
      if (col >= n_rep) {
        rc_budget = 1;
        continue;
      }
      if (val >= seq_cap || val > 0xffffffffULL) return -2;
      vv[base_row * n_rep + col] = static_cast<uint32_t>(val);
    }
    int64_t nc = r.count();
    if (nc > c) return -1;
    for (int64_t e = 0; e < nc && !r.rc; e++) {
      uint64_t rid = r.varint();
      uint64_t seq = r.varint();
      bool added;
      int32_t col = rid_map.get_or_add(rid, &added);
      if (col >= n_rep) {
        rc_budget = 1;
        continue;
      }
      if (static_cast<uint64_t>(col) >= col_cap) return -2;
      if (seq >= seq_cap) return -2;
      uint64_t packed = (static_cast<uint64_t>(col) << shift) | seq;
      if (narrow && packed == static_cast<uint64_t>(pad32)) return -2;
      if (!narrow && packed == pad64) return -2;
      crow.push_back(packed);
    }
    if (r.rc) return r.rc;
    if (!r.done()) return -1;
    if (rc_budget) continue;  // still walking for rids_seen, no writes
    // entries: stable sort by packed dot, duplicates keep the LAST wire
    // occurrence (the oracle's dict overwrite)
    std::stable_sort(row.begin(), row.end(),
                     [](const auto& a, const auto& b) {
                       return a.first < b.first;
                     });
    int64_t out = 0;
    for (size_t e = 0; e < row.size(); e++) {
      if (e + 1 < row.size() && row[e + 1].first == row[e].first) continue;
      int64_t at = base_row * w + out;
      if (narrow) {
        dots32[at] = static_cast<int32_t>(row[e].first);
      } else {
        dots64[at] = row[e].first;
      }
      pay[at] = row[e].second;
      out++;
    }
    // cloud: sort + dedup (the oracle's set)
    std::sort(crow.begin(), crow.end());
    crow.erase(std::unique(crow.begin(), crow.end()), crow.end());
    for (size_t e = 0; e < crow.size(); e++) {
      int64_t at = base_row * c + static_cast<int64_t>(e);
      if (narrow) {
        cloud32[at] = static_cast<int32_t>(crow[e]);
      } else {
        cloud64[at] = crow[e];
      }
    }
  }
  *rids_seen_out = static_cast<int64_t>(rid_map.keys.size());
  if (rc_budget) return -3;
  int64_t n_new = static_cast<int64_t>(rid_map.keys.size()) - n_known;
  for (int64_t i = 0; i < n_new; i++) {
    new_rids_out[i] = rid_map.keys[static_cast<size_t>(n_known + i)];
  }
  *n_new_out = n_new;
  *n_pays_out = static_cast<int64_t>(pay_map.offs.size());
  for (size_t i = 0; i < pay_map.offs.size(); i++) {
    pay_span_off[i] = pay_map.offs[i];
    pay_span_len[i] = pay_map.lens[i];
  }
  return 0;
}

}  // extern "C"
