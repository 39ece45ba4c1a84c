// Native fast path for the cluster wire codec's MsgPushDeltas hot loop.
//
// Reference analog: jylis/_serialise.pony:3-14 — the
// reference's message serialiser is compiled Pony; this is the rebuild's
// compiled equivalent for the anti-entropy broadcast/converge path, where
// per-key deltas would otherwise be varint-packed in a Python loop
// (jylis_tpu/cluster/codec.py is the always-available semantic oracle;
// output here must be byte-identical for every input this file accepts).
//
// Wire format (schema v1, see codec.py _SCHEMA_TEXT): LEB128 varints,
// varint-length-prefixed byte strings, tag 0x03 = PushDeltas followed by
// name, batch count, then per key: key bytes + a per-type delta payload.
//
// The Python wrapper (jylis_tpu/native/codec.py) flattens delta objects to
// contiguous arrays (one pass), and this file does all byte-level work in
// one FFI call per message. Decode is two-pass: measure (counts) then fill
// (slices + values); both passes are memory-speed walks.
//
// Return conventions: encode -> bytes written, or -1 (buffer too small /
// unencodable). measure/decode -> 0 ok, -1 malformed, -2 unsupported here
// (caller falls back to the Python oracle, e.g. varints past 64 bits).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

struct Writer {
  uint8_t* p;
  uint8_t* end;
  bool ok = true;

  void u8(uint8_t b) {
    if (p < end) {
      *p++ = b;
    } else {
      ok = false;
    }
  }
  void varint(uint64_t v) {
    while (true) {
      uint8_t b = v & 0x7f;
      v >>= 7;
      if (v) {
        u8(b | 0x80);
      } else {
        u8(b);
        return;
      }
    }
  }
  void bytes(const uint8_t* b, int64_t n) {
    varint(static_cast<uint64_t>(n));
    if (end - p >= n) {
      memcpy(p, b, static_cast<size_t>(n));
      p += n;
    } else {
      ok = false;
    }
  }
};

struct Reader {
  const uint8_t* base;
  const uint8_t* p;
  const uint8_t* end;
  int rc = 0;  // sticky: 0 ok, -1 malformed, -2 unsupported

  // Mirrors codec.py _Reader.varint: accepts up to shift 70, but any
  // value that does not fit in 64 bits is out of this fast path's domain
  // (the oracle would produce a Python bigint) -> rc -2.
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
  // An item count (keys, dict entries, log entries). Every counted item
  // consumes at least one byte, so any count exceeding the remaining
  // buffer guarantees the oracle raises "truncated" before finishing —
  // and bounding here keeps the count a sane non-negative int64 (a raw
  // 2^64-1 varint would cast to a NEGATIVE int64, silently skip the
  // entry loop the oracle still walks, and desync measure from decode).
  int64_t count() {
    uint64_t v = varint();
    if (rc) return 0;
    if (v > static_cast<uint64_t>(end - p)) {
      rc = -1;
      return 0;
    }
    return static_cast<int64_t>(v);
  }
  // A length-prefixed byte string; returns its offset from base.
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

}  // namespace

extern "C" {

// ---- counters: GCOUNT (ndicts=1) / PNCOUNT (ndicts=2) ----------------------
// delta/GCOUNT = [(rid:varint v:varint)]; PNCOUNT = two such dicts.
// rids/vals are flattened in key-major order; dict entries must already be
// in the oracle's canonical order (sorted by rid) for byte-identity.

int64_t jy_push_counters_encode(
    const uint8_t* name, int64_t name_len, int64_t n_keys,
    const uint8_t* key_base, const int64_t* key_off, const int64_t* key_len,
    int32_t ndicts, const int64_t* dict_counts,  // n_keys * ndicts
    const uint64_t* rids, const uint64_t* vals,  // flattened entries
    uint8_t* out, int64_t out_cap) {
  Writer w{out, out + out_cap};
  w.u8(3);
  w.bytes(name, name_len);
  w.varint(static_cast<uint64_t>(n_keys));
  int64_t e = 0;
  // the wire orders each dict's entries by replica id; spans arrive in
  // Python dict-iteration order and sort HERE (insertion sort on the
  // small spans — the per-key sorted() this replaces dominated encode)
  uint64_t sr[64];
  uint64_t sv[64];
  for (int64_t k = 0; k < n_keys; k++) {
    w.bytes(key_base + key_off[k], key_len[k]);
    for (int32_t d = 0; d < ndicts; d++) {
      int64_t c = dict_counts[k * ndicts + d];
      w.varint(static_cast<uint64_t>(c));
      if (c <= 64) {
        for (int64_t i = 0; i < c; i++) {
          uint64_t r = rids[e + i], v = vals[e + i];
          int64_t j = i;
          while (j > 0 && sr[j - 1] > r) {
            sr[j] = sr[j - 1];
            sv[j] = sv[j - 1];
            j--;
          }
          sr[j] = r;
          sv[j] = v;
        }
        for (int64_t i = 0; i < c; i++) {
          w.varint(sr[i]);
          w.varint(sv[i]);
        }
        e += c;
      } else {
        std::vector<std::pair<uint64_t, uint64_t>> big;
        big.reserve(c);
        for (int64_t i = 0; i < c; i++, e++) big.emplace_back(rids[e], vals[e]);
        std::sort(big.begin(), big.end());
        for (auto& rv : big) {
          w.varint(rv.first);
          w.varint(rv.second);
        }
      }
    }
  }
  return w.ok ? (w.p - out) : -1;
}

// body starts AT the batch-count varint (caller has read tag + name).
int32_t jy_push_counters_measure(const uint8_t* body, int64_t body_len,
                                 int32_t ndicts, int64_t* n_keys_out,
                                 int64_t* total_entries_out) {
  Reader r{body, body, body + body_len};
  int64_t n_keys = r.count();
  int64_t total = 0;
  for (int64_t k = 0; k < n_keys && !r.rc; k++) {
    int64_t klen;
    r.bytes(&klen);
    for (int32_t d = 0; d < ndicts && !r.rc; d++) {
      int64_t c = r.count();
      total += c;
      for (int64_t i = 0; i < c && !r.rc; i++) {
        r.varint();
        r.varint();
      }
    }
  }
  if (r.rc) return r.rc;
  if (!r.done()) return -1;  // trailing bytes after message
  *n_keys_out = n_keys;
  *total_entries_out = total;
  return 0;
}

int32_t jy_push_counters_decode(const uint8_t* body, int64_t body_len,
                                int32_t ndicts, int64_t* key_off,
                                int64_t* key_len, int64_t* dict_counts,
                                uint64_t* rids, uint64_t* vals) {
  Reader r{body, body, body + body_len};
  int64_t n_keys = r.count();
  int64_t e = 0;
  for (int64_t k = 0; k < n_keys && !r.rc; k++) {
    key_off[k] = r.bytes(&key_len[k]);
    for (int32_t d = 0; d < ndicts && !r.rc; d++) {
      int64_t c = r.count();
      dict_counts[k * ndicts + d] = c;
      for (int64_t i = 0; i < c && !r.rc; i++, e++) {
        rids[e] = r.varint();
        vals[e] = r.varint();
      }
    }
  }
  return r.rc;
}

// ---- TREG: per key (value:bytes ts:varint) ---------------------------------

int64_t jy_push_treg_encode(const uint8_t* name, int64_t name_len,
                            int64_t n_keys, const uint8_t* key_base,
                            const int64_t* key_off, const int64_t* key_len,
                            const uint8_t* val_base, const int64_t* val_off,
                            const int64_t* val_len, const uint64_t* ts,
                            uint8_t* out, int64_t out_cap) {
  Writer w{out, out + out_cap};
  w.u8(3);
  w.bytes(name, name_len);
  w.varint(static_cast<uint64_t>(n_keys));
  for (int64_t k = 0; k < n_keys; k++) {
    w.bytes(key_base + key_off[k], key_len[k]);
    w.bytes(val_base + val_off[k], val_len[k]);
    w.varint(ts[k]);
  }
  return w.ok ? (w.p - out) : -1;
}

int32_t jy_push_treg_measure(const uint8_t* body, int64_t body_len,
                             int64_t* n_keys_out) {
  Reader r{body, body, body + body_len};
  int64_t n_keys = r.count();
  for (int64_t k = 0; k < n_keys && !r.rc; k++) {
    int64_t len;
    r.bytes(&len);
    r.bytes(&len);
    r.varint();
  }
  if (r.rc) return r.rc;
  if (!r.done()) return -1;
  *n_keys_out = n_keys;
  return 0;
}

int32_t jy_push_treg_decode(const uint8_t* body, int64_t body_len,
                            int64_t* key_off, int64_t* key_len,
                            int64_t* val_off, int64_t* val_len, uint64_t* ts) {
  Reader r{body, body, body + body_len};
  int64_t n_keys = r.count();
  for (int64_t k = 0; k < n_keys && !r.rc; k++) {
    key_off[k] = r.bytes(&key_len[k]);
    val_off[k] = r.bytes(&val_len[k]);
    ts[k] = r.varint();
  }
  return r.rc;
}

// ---- TLOG / SYSTEM: per key (entries:[(value:bytes ts:varint)] cutoff) -----

int64_t jy_push_tlog_encode(const uint8_t* name, int64_t name_len,
                            int64_t n_keys, const uint8_t* key_base,
                            const int64_t* key_off, const int64_t* key_len,
                            const int64_t* entry_counts,
                            const uint8_t* ent_base, const int64_t* ent_off,
                            const int64_t* ent_len, const uint64_t* ent_ts,
                            const uint64_t* cutoffs, uint8_t* out,
                            int64_t out_cap) {
  Writer w{out, out + out_cap};
  w.u8(3);
  w.bytes(name, name_len);
  w.varint(static_cast<uint64_t>(n_keys));
  int64_t e = 0;
  for (int64_t k = 0; k < n_keys; k++) {
    w.bytes(key_base + key_off[k], key_len[k]);
    int64_t c = entry_counts[k];
    w.varint(static_cast<uint64_t>(c));
    for (int64_t i = 0; i < c; i++, e++) {
      w.bytes(ent_base + ent_off[e], ent_len[e]);
      w.varint(ent_ts[e]);
    }
    w.varint(cutoffs[k]);
  }
  return w.ok ? (w.p - out) : -1;
}

int32_t jy_push_tlog_measure(const uint8_t* body, int64_t body_len,
                             int64_t* n_keys_out, int64_t* total_entries_out) {
  Reader r{body, body, body + body_len};
  int64_t n_keys = r.count();
  int64_t total = 0;
  for (int64_t k = 0; k < n_keys && !r.rc; k++) {
    int64_t len;
    r.bytes(&len);
    int64_t c = r.count();
    total += c;
    for (int64_t i = 0; i < c && !r.rc; i++) {
      r.bytes(&len);
      r.varint();
    }
    r.varint();
  }
  if (r.rc) return r.rc;
  if (!r.done()) return -1;
  *n_keys_out = n_keys;
  *total_entries_out = total;
  return 0;
}

int32_t jy_push_tlog_decode(const uint8_t* body, int64_t body_len,
                            int64_t* key_off, int64_t* key_len,
                            int64_t* entry_counts, int64_t* ent_off,
                            int64_t* ent_len, uint64_t* ent_ts,
                            uint64_t* cutoffs) {
  Reader r{body, body, body + body_len};
  int64_t n_keys = r.count();
  int64_t e = 0;
  for (int64_t k = 0; k < n_keys && !r.rc; k++) {
    key_off[k] = r.bytes(&key_len[k]);
    int64_t c = r.count();
    entry_counts[k] = c;
    for (int64_t i = 0; i < c && !r.rc; i++, e++) {
      ent_off[e] = r.bytes(&ent_len[e]);
      ent_ts[e] = r.varint();
    }
    cutoffs[k] = r.varint();
  }
  return r.rc;
}

// ---- UJSON: per key (entries:[(rid seq path:[str] token:str)]
//                      vv:[(rid seq)] cloud:[(rid seq)]) ---------------------
// The Python wrapper flattens each delta in oracle order (entries sorted by
// dot, vv by rid, cloud sorted); strings are path parts then token per
// entry, all in one blob. counts holds 3 int64 per key: entries, vv, cloud.

int64_t jy_push_ujson_encode(
    const uint8_t* name, int64_t name_len, int64_t n_keys,
    const uint8_t* key_base, const int64_t* key_off, const int64_t* key_len,
    const int64_t* counts, const uint64_t* ent_rid, const uint64_t* ent_seq,
    const int64_t* path_counts, const uint8_t* str_base,
    const int64_t* str_off, const int64_t* str_len, const uint64_t* vv_rid,
    const uint64_t* vv_val, const uint64_t* cl_rid, const uint64_t* cl_seq,
    uint8_t* out, int64_t out_cap) {
  Writer w{out, out + out_cap};
  w.u8(3);
  w.bytes(name, name_len);
  w.varint(static_cast<uint64_t>(n_keys));
  int64_t e = 0, s = 0, v = 0, c = 0;
  for (int64_t k = 0; k < n_keys; k++) {
    w.bytes(key_base + key_off[k], key_len[k]);
    int64_t ne = counts[k * 3], nv = counts[k * 3 + 1], nc = counts[k * 3 + 2];
    w.varint(static_cast<uint64_t>(ne));
    for (int64_t i = 0; i < ne; i++, e++) {
      w.varint(ent_rid[e]);
      w.varint(ent_seq[e]);
      int64_t np = path_counts[e];
      w.varint(static_cast<uint64_t>(np));
      for (int64_t j = 0; j <= np; j++, s++) {  // path parts, then token
        w.bytes(str_base + str_off[s], str_len[s]);
      }
    }
    w.varint(static_cast<uint64_t>(nv));
    for (int64_t i = 0; i < nv; i++, v++) {
      w.varint(vv_rid[v]);
      w.varint(vv_val[v]);
    }
    w.varint(static_cast<uint64_t>(nc));
    for (int64_t i = 0; i < nc; i++, c++) {
      w.varint(cl_rid[c]);
      w.varint(cl_seq[c]);
    }
  }
  return w.ok ? (w.p - out) : -1;
}

// (UJSON decode lives in native/ujson_planes.cpp: the receive path
// splits the body into lazy per-key payload spans instead of walking
// every entry into flat arrays here.)

}  // extern "C"
