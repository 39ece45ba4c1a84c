// tlog_drain_sparse / tlog_drain_dense: the TLOG row merge with fused trim.
//
// Replace jylis_tpu/models/repo_tlog.py `_drain` (:70) and `_drain_dense`
// (:79), XLA programs over jylis_tpu/ops/tlog.py `converge_then_trim`
// (:361): `converge_batch` (:232), `_assemble` (:154), `_merge_planes`
// (:188) and `trim_batch` (:334). A row is the JAX package's sort planes
// (jylis_tpu_torch/ops/tlog.py): u32 nth (wide layout only), ntl and nv,
// whose ascending unsigned lexicographic order is the canonical order
// (valid entries first, ts descending, vid descending; PAD is all ones),
// plus an int32 length and a u64 cutoff.
//
// Per slot s of the batch (row = key_idx[s], or s itself when dense):
//   cut = max(cutoff[row], dcut[s]); the state's entries below cut drop
//   (a suffix: rows are canonical); delta entries with vid < 0 or
//   ts < cut drop; the delta is sorted and merged with the state row,
//   every entry equal to its left neighbour dropped (duplicates occur
//   inside a delta too); then the trim of counts[s]: >= 2^62 is a no-op,
//   0 is CLR (target latest + 1, wrapping to 0 at 2^64-1, 0 on an empty
//   row), 0 < count <= length takes the ts at index count-1, any other
//   count gives 0; the cutoff becomes max(cut, target) and the entries
//   below it drop. The row keeps its first `length` slots valid and PAD
//   after.
// Overflow: sparse flags merged length > L; dense flags length > L - Ld
// on every row, merged or not (jylis_tpu/ops/tlog.py:263), matching the
// JAX package's rules exactly. A flagged row is left untouched, so the
// repo grows the state and drains the same delta again: join, cutoff and
// trim are idempotent, so rows merged by the flagged attempt come out the
// same. A sparse slot whose row is >= K or negative (key_idx is compared
// unsigned) writes no state and reports overflow 0, length 0, cutoff 0;
// JAX clamps such gathers instead, and the repo reads live slots only.
// The narrow layout compares ts against a cutoff on the low plane only,
// as the JAX package does; the repo widens the state before any ts or
// cutoff exceeds 2^32 - 2.
//
// Design. A row's work is a chain of small dependent steps, so latency
// and synchronisation bound it, not bytes: a CTA of 256 threads on a row
// of a few hundred entries waits at a barrier between every step and
// idles 255 threads on a one-entry TRIM. A launch's rows share one width,
// and the
// wrapper (ops/tlog.py `drain_plan`, ops/row_plan.py) picks one of three
// classes for it:
//   warp     (tlog_drain_warp) a warp per row, up to 8 rows per CTA (as
//            many as keep the most rows resident on an SM), each warp
//            owning a slice of shared memory that holds the row's state
//            entries, its compacted delta and each delta entry's bound in
//            the state. The delta, 32*E entries (E = 1..8, Ld <= 256), is
//            read coalesced into registers, E a lane, and sorted there by
//            a warp bitonic network of shuffles (warp_ops.cuh);
//            duplicates are found with __shfl_up_sync, membership in the
//            state row by a binary search, and the survivors compacted
//            into the slice by __ballot_sync. Only __syncwarp between
//            steps: a warp reads its whole row before it writes any of it.
//   cta      (tlog_drain_cta) a CTA per row, for rows past a warp's
//            slice or Ld > 256: the delta is bitonic-sorted in the work
//            buffer (a barrier a stage), compacted by ballot scans of
//            one barrier each (warp_ops.cuh CtaGroup).
//   cluster  (tlog_drain_cluster) rows past a CTA's shared memory: a
//            thread-block cluster of n CTAs per row (n a power of two,
//            up to 16; cudaLaunchKernelEx), CTA q holding its share of
//            the work buffer in its own shared memory: delta columns
//            [q * P, (q + 1) * P) and state slots [q * PA, (q + 1) * PA).
//            Each CTA bitonic-sorts its P delta entries in shared memory;
//            log2(n) rounds of merge path then merge the sorted runs
//            pairwise across the cluster, each thread finding its co-rank
//            by a binary search over the two runs and merging its
//            outputs in order, reading the other CTAs' runs through
//            distributed shared memory (cluster.map_shared_rank): no
//            device-scratch sorting network. The dedup compares an entry
//            with its left neighbour (in the CTA before for a share's
//            first entry), the compaction takes its offsets from a
//            cluster-wide exclusive scan (each CTA publishes its count,
//            one cluster barrier, every CTA reads the others'), the
//            trim's co-rank and the cutoff's suffix search run over the
//            partitioned buffers, and cluster.sync() ends every step:
//            every CTA has read the state row before any CTA writes it.
//            A row too wide for 16 CTAs' shared memory keeps the shares
//            in device scratch, one region a cluster; the steps are the
//            same.
// In every class: a slot's delta and the scalars that need no row are
// loaded before the row's, so their latencies overlap; a row with no
// valid delta entry, no raised cutoff and no trim reads no state and
// writes nothing, and state entries below the first delta entry keep
// their slots unwritten (a TRIM writes only PAD); the state row's old length
// is copied (16-byte loads where the planes allow), not its L slots, and
// the copy finds where the entries surviving the cutoff end (a prefix);
// every thread computes the trim's target (a merge-path co-rank search)
// and the trimmed length itself, with searches the warp's 32 lanes run
// together (warp_partition_point), so no thread waits on another; a
// state entry's merged position is its index plus the delta entries
// whose bound lies at or below it (a search of the bounds), a delta
// entry's its index plus its bound, so the writes stay nearly coalesced.
// Compares are branch-free: a warp's lanes compare different entries,
// and a branch per plane would split the warp at every compare of the
// register sort.
// The crossover (the wrapper's WARP_ROW_BYTES), measured on an H100 by
// scripts/row_kernel_profile.py --sweep: PERF.md §6.
//
// Bound: bytes. Per live row: the state's valid entries read (4 bytes a
// plane), Ld delta entries (8-byte ts, 8-byte vid), length, cutoff, delta
// cutoff and count read; the rewritten slots written back (positions up
// to the larger of the old and new length), then length and cutoff; plus
// the outputs (overflow byte; sparse: 4 + 8 bytes, and the 4-byte
// index). Compares per row: Ldp * s for the sort (Ldp = 2^s: a merge
// sort's, the least a sort of Ldp entries needs), Ldp + (old length) for
// the filters, and log2(L + Ld) per merged and per delta entry for the
// searches.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "warp_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using u32 = unsigned int;
using u64 = unsigned long long;

constexpr int kCtaThreads = 256;
using jt::kClusterMax;
constexpr u32 kPad = 0xFFFFFFFFu;
constexpr long long kTrimNoop = 1LL << 62;

// one log entry: (nth, ntl, nv); nth is unused in the narrow layout
struct Ent {
  u32 h, l, v;
};

// lexicographic order and equality, without branches (a warp's lanes
// compare different entries; a branch per plane would diverge)
template <bool W>
__device__ __forceinline__ bool lt(const Ent& a, const Ent& b) {
  const bool lv = (a.l < b.l) | ((a.l == b.l) & (a.v < b.v));
  return W ? (a.h < b.h) | ((a.h == b.h) & lv) : lv;
}

template <bool W>
__device__ __forceinline__ bool eq(const Ent& a, const Ent& b) {
  return ((!W) | (a.h == b.h)) & (a.l == b.l) & (a.v == b.v);
}

// jylis_tpu/ops/tlog.py `_ts_ge`: ts >= cut as lex (nth, ntl) <=
// (~cut_hi, ~cut_lo); the narrow layout compares ntl only
template <bool W>
__device__ __forceinline__ bool ts_ge(const Ent& e, u64 cut) {
  const u64 nc = ~cut;
  const u32 nch = static_cast<u32>(nc >> 32), ncl = static_cast<u32>(nc);
  return W ? (e.h < nch) | ((e.h == nch) & (e.l <= ncl)) : e.l <= ncl;
}

template <bool W>
__device__ __forceinline__ u64 ts_of(const Ent& e) {
  const u64 lo = static_cast<u64>(~e.l);
  return W ? (static_cast<u64>(~e.h) << 32) | lo : lo;
}

// the planes of a state row or of a work buffer (generic pointers: shared
// or device memory); h is null in the narrow layout
template <bool W>
struct Planes {
  u32 *h, *l, *v;
  __device__ __forceinline__ Ent get(long long i) const {
    return Ent{W ? h[i] : kPad, l[i], v[i]};
  }
  __device__ __forceinline__ void put(long long i, const Ent& e) const {
    if (W) h[i] = e.h;
    l[i] = e.l;
    v[i] = e.v;
  }
  __device__ __forceinline__ Planes at(long long off) const {
    return Planes{W ? h + off : nullptr, l + off, v + off};
  }
};

// A row's work buffer: per plane `slice` u32 (its L state slots, then
// ldp delta slots), then ldp ints: where each compacted delta entry falls
// among the state's surviving entries (its lower bound there).
template <bool W>
__device__ __forceinline__ Planes<W> buffer(u32* w, long long slice) {
  return Planes<W>{W ? w : nullptr, w + (W ? slice : 0),
                   w + (W ? 2 : 1) * slice};
}

__device__ __forceinline__ long long buffer_u32(long long slice, int ldp, bool wide) {
  return slice * (wide ? 3 : 2) + ((ldp + 3) & ~3);
}

// entries of p[0, n) that are < e (p sorted ascending; p: Planes or Dist)
template <bool W, class P>
__device__ __forceinline__ int lower_bound(const P& p, int n, const Ent& e) {
  return jt::partition_point(n, [&](int i) { return lt<W>(p.get(i), e); });
}

// entries of p[0, n) with ts >= cut: a prefix of a sorted list. Every
// thread of the group calls it (a warp-parallel search).
template <bool W, class P>
__device__ __forceinline__ int live_prefix(const P& p, int n, u64 cut) {
  return jt::warp_partition_point(0, n, [&](int i) { return ts_ge<W>(p.get(i), cut); });
}

// the k-th entry (0-based) of the merge of sorted, disjoint a[0, na) and
// d[0, nd): a merge-path co-rank search for how many of the first k + 1
// come from a. Every thread of the group calls it.
template <bool W, class PA, class PD>
__device__ Ent merged_at(const PA& a, int na, const PD& d, int nd, int k) {
  const int kk = k + 1;
  const int i = jt::warp_partition_point(
      kk - nd > 0 ? kk - nd : 0, kk < na ? kk : na,
      [&](int mid) { return lt<W>(a.get(mid), d.get(kk - mid - 1)); });
  const int j = kk - i;
  if (i == 0) return d.get(j - 1);
  if (j == 0) return a.get(i - 1);
  const Ent x = a.get(i - 1), y = d.get(j - 1);
  return lt<W>(x, y) ? y : x;
}

// copy src[0, n) to dst[0, n) across the group: 16-byte words when vec
// (both planes 16-byte aligned, n rounded up within a row of L % 4 == 0
// slots, so the extra words are the row's own PAD). Returns the least
// index this thread copied whose entry has ts < cut, n if none: the
// group's least is where the entries that survive the cutoff end (they
// are a prefix), found while copying instead of by a search after it.
template <bool W, class G>
__device__ __forceinline__ int copy_row(const G& g, const Planes<W>& dst,
                                        const Planes<W>& src, int n, bool vec,
                                        u64 cut) {
  int fail = n;
  if (vec) {
    const int nq = (n + 3) >> 2;
    for (int q = g.rank; q < nq; q += G::kSize) {
      const uint4 h = W ? reinterpret_cast<const uint4*>(src.h)[q]
                        : make_uint4(kPad, kPad, kPad, kPad);
      const uint4 l = reinterpret_cast<const uint4*>(src.l)[q];
      if (W) reinterpret_cast<uint4*>(dst.h)[q] = h;
      reinterpret_cast<uint4*>(dst.l)[q] = l;
      reinterpret_cast<uint4*>(dst.v)[q] = reinterpret_cast<const uint4*>(src.v)[q];
      const u32 hs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        const int i = 4 * q + j;
        if (i < n && i < fail && !ts_ge<W>(Ent{hs[j], ls[j], 0}, cut)) fail = i;
      }
    }
  } else {
    for (int i = g.rank; i < n; i += G::kSize) {
      const Ent e = src.get(i);
      dst.put(i, e);
      if (i < fail && !ts_ge<W>(e, cut)) fail = i;
    }
  }
  return fail;
}

// a slot's inputs, read by every thread of its group (same addresses:
// one broadcast load each)
struct Slot {
  long long s, row;
  int old_len;
  u64 a_cut, cut;
  long long cnt;
};

// the slot's scalars; false when the slot is done already (a pad slot,
// or a row the dense rule flags), its outputs written by rank 0
__device__ __forceinline__ bool open_slot(
    int rank, long long s, const int* key_idx, long long k, int L, int ld,
    const int* length, const u64* cutoff, const u64* dcut,
    const long long* counts, unsigned char* ovf, int* out_len, u64* out_cut,
    Slot* o) {
  const u64 d_cut = dcut[s];  // (loads that need no row go first)
  const long long cnt = counts[s];
  long long row = s;
  if (key_idx) {
    row = static_cast<u32>(key_idx[s]);
    if (row >= k) {  // pad slot
      if (rank == 0) {
        ovf[s] = 0;
        out_len[s] = 0;
        out_cut[s] = 0;
      }
      return false;
    }
  }
  const int old_len = length[row];
  if (!key_idx && old_len > L - ld) {  // the dense rule, on every row
    if (rank == 0) ovf[s] = 1;
    return false;
  }
  const u64 a_cut = cutoff[row];
  *o = Slot{s, row, old_len, a_cut, a_cut > d_cut ? a_cut : d_cut, cnt};
  return true;
}

// rank 0 reports a slot that leaves its row as it was
__device__ __forceinline__ void report(int rank, const Slot& t, unsigned char flag,
                                       unsigned char* ovf, int* out_len,
                                       u64* out_cut) {
  if (rank == 0) {
    ovf[t.s] = flag;
    if (out_len) {
      out_len[t.s] = t.old_len;
      out_cut[t.s] = t.a_cut;
    }
  }
}

// delta column j of slot s as read (vid -1 past Ld): loaded before the
// slot's row is known, so the loads overlap the row's
struct Raw {
  u64 ts;
  long long vid;
};

__device__ __forceinline__ Raw delta_raw(const u64* dts, const long long* dvid,
                                         long long s, int ld, int j) {
  if (j < ld) return Raw{dts[s * ld + j], dvid[s * ld + j]};
  return Raw{0, -1};
}

// the entry of a raw delta column in plane order, PAD unless valid
// under cut
__device__ __forceinline__ Ent delta_entry(const Raw& r, u64 cut, bool* ok) {
  *ok = r.vid >= 0 && r.ts >= cut;
  const u64 nt = ~r.ts;
  return *ok ? Ent{static_cast<u32>(nt >> 32), static_cast<u32>(nt),
                   ~(static_cast<u32>(r.vid) + 1u)}
             : Ent{kPad, kPad, kPad};
}

// Keep delta entry e (sorted position: after prev, or first) unless it
// is PAD, equal to its left neighbour or already in a[0, na); *at gets
// its lower bound in a.
template <bool W, class PA>
__device__ __forceinline__ bool keep_delta(const PA& a, int na,
                                           const Ent& e, const Ent& prev,
                                           bool first, int* at) {
  if (e.v == kPad || (!first && eq<W>(prev, e))) return false;
  *at = lower_bound<W>(a, na, e);
  return *at == na || !eq<W>(a.get(*at), e);
}

// Everything after the delta is sorted, deduplicated, filtered against
// the state and compacted to d[0, nd), each entry's lower bound in
// a[0, na) in at[0, nd) (synced): the overflow rule, the trim, the
// write-back and the slot's outputs.
template <bool W, class G>
__device__ __forceinline__ void finish_row(
    const G& g, const Slot& t, const Planes<W>& R, const Planes<W>& A, int na,
    const Planes<W>& D, const int* at, int nd, int L, bool sparse, int* length,
    u64* cutoff, unsigned char* ovf, int* out_len, u64* out_cut) {
  const int m = na + nd;
  if (sparse && m > L) {  // the sparse rule
    report(g.rank, t, 1, ovf, out_len, out_cut);
    return;
  }
  // the fused trim's target, from the merged row
  // (with no delta entry the merged row is a's)
  u64 target = 0;
  if (t.cnt == 0) {
    if (m > 0) target = ts_of<W>(nd ? merged_at<W>(A, na, D, nd, 0) : A.get(0)) + 1;
  } else if (t.cnt > 0 && t.cnt <= m) {
    const int k = static_cast<int>(t.cnt - 1);
    target = ts_of<W>(nd ? merged_at<W>(A, na, D, nd, k) : A.get(k));
  }
  const u64 new_cut = t.cut > target ? t.cut : target;
  // the entries that survive it: a prefix of each list (all of a's when
  // the trim raised nothing: a[0, na) survived t.cut)
  const int ka = new_cut == t.cut ? na : live_prefix<W>(A, na, new_cut);
  const int kd = live_prefix<W>(D, nd, new_cut);
  const int nk = ka + kd;
  // write the merged, trimmed row; PAD over what is left of the old one.
  // Merged position: a state entry's index plus the delta entries below
  // it (at[] is sorted), a delta entry's index plus its bound in a[0, ka)
  if (nd > 0 || nk != t.old_len) {
    // (state entries below the first delta entry's bound keep their slots)
    const int i0 = kd && at[0] < ka ? at[0] : ka;
    for (int i = i0 + g.rank; i < ka; i += G::kSize) {
      R.put(i + jt::partition_point(kd, [&](int j) { return at[j] <= i; }), A.get(i));
    }
    for (int j = g.rank; j < kd; j += G::kSize) {
      R.put(j + (at[j] < ka ? at[j] : ka), D.get(j));
    }
    for (int p = nk + g.rank; p < t.old_len; p += G::kSize) {
      R.put(p, Ent{kPad, kPad, kPad});
    }
  }
  if (g.rank == 0) {
    length[t.row] = nk;
    cutoff[t.row] = new_cut;
    ovf[t.s] = 0;
    if (out_len) {
      out_len[t.s] = nk;
      out_cut[t.s] = new_cut;
    }
  }
}

// A warp per row, rows_per_cta warps per CTA; slice: u32 per plane of a
// warp's work buffer, whose delta part holds 32 << LogE slots.
template <bool W, int LogE>
__global__ void __launch_bounds__(256, W ? 2 : 3)
    tlog_drain_warp(u32* nth, u32* ntl, u32* nv, int* length, u64* cutoff,
                    const int* key_idx, const u64* dts, const long long* dvid,
                    const u64* dcut, const long long* counts,
                    unsigned char* ovf, int* out_len, u64* out_cut,
                    long long nslots, long long k, int L, int ld,
                    int rows_per_cta, long long slice, int vec) {
  constexpr int E = 1 << LogE;
  extern __shared__ __align__(16) u32 smem[];
  const jt::WarpGroup g;
  const int warp = static_cast<int>(threadIdx.x >> 5), lane = g.rank;
  u32* w = smem + warp * buffer_u32(slice, 32 << LogE, W);
  const Planes<W> A = buffer<W>(w, slice);
  const Planes<W> D = A.at(L);
  int* at = reinterpret_cast<int*>(w + slice * (W ? 3 : 2));
  const auto xshfl = [](const Ent& x, int m) {
    return Ent{W ? __shfl_xor_sync(jt::kFullMask, x.h, m) : kPad,
               __shfl_xor_sync(jt::kFullMask, x.l, m),
               __shfl_xor_sync(jt::kFullMask, x.v, m)};
  };

  for (long long s = static_cast<long long>(blockIdx.x) * rows_per_cta + warp;
       s < nslots; s += static_cast<long long>(gridDim.x) * rows_per_cta) {
    __syncwarp();  // the previous slot is done with the slice
    // the delta, E columns a lane (element e * 32 + lane), coalesced
    Raw raw[E];
#pragma unroll
    for (int e = 0; e < E; ++e) raw[e] = delta_raw(dts, dvid, s, ld, (e << 5) | lane);
    Slot t;
    if (!open_slot(lane, s, key_idx, k, L, ld, length, cutoff, dcut, counts,
                   ovf, out_len, out_cut, &t)) {
      continue;
    }
    // its entries under the cutoff, PAD elsewhere
    Ent d[E];
    int nvalid = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      bool ok;
      d[e] = delta_entry(raw[e], t.cut, &ok);
      nvalid += g.count(ok);
    }
    if (nvalid == 0 && t.cut == t.a_cut && t.cnt >= kTrimNoop) {  // unchanged
      report(lane, t, 0, ovf, out_len, out_cut);
      continue;
    }
    const long long off = t.row * L;
    const Planes<W> R{W ? nth + off : nullptr, ntl + off, nv + off};
    const int na = g.min(copy_row<W>(g, A, R, t.old_len, vec != 0, t.cut));
    if (nvalid > 1) {
      jt::warp_bitonic<LogE>(
          d, [](const Ent& a, const Ent& b) { return lt<W>(a, b); }, xshfl);
    }
    __syncwarp();

    // drop entries equal to their left neighbour or already in the state
    // row; compact the rest to D[0, nd) in sorted order
    int nd = 0;
    if (nvalid) {  // (no entry: nothing to drop or place)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        Ent prev{W ? __shfl_up_sync(jt::kFullMask, d[e].h, 1) : kPad,
                 __shfl_up_sync(jt::kFullMask, d[e].l, 1),
                 __shfl_up_sync(jt::kFullMask, d[e].v, 1)};
        if (e > 0) {  // lane 0's left neighbour is lane 31's previous entry
          const Ent w{W ? __shfl_sync(jt::kFullMask, d[e - 1].h, 31) : kPad,
                      __shfl_sync(jt::kFullMask, d[e - 1].l, 31),
                      __shfl_sync(jt::kFullMask, d[e - 1].v, 31)};
          if (lane == 0) prev = w;
        }
        int p = 0;
        const bool keep = keep_delta<W>(A, na, d[e], prev, e == 0 && lane == 0, &p);
        int tot;
        const int pos = g.scan(keep, &tot);
        if (keep) {
          D.put(nd + pos, d[e]);
          at[nd + pos] = p;
        }
        nd += tot;
      }
    }
    __syncwarp();
    finish_row<W>(g, t, R, A, na, D, at, nd, L, key_idx != nullptr, length,
                  cutoff, ovf, out_len, out_cut);
  }
}

// ascending bitonic sort of d[0, n), n a power of two, over the CTA
template <bool W>
__device__ void cta_bitonic(const Planes<W>& d, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kCtaThreads) {
        const int p = i ^ j;
        if (p > i) {
          const Ent a = d.get(i), b = d.get(p);
          if ((i & k) == 0 ? lt<W>(b, a) : lt<W>(a, b)) {
            d.put(i, b);
            d.put(p, a);
          }
        }
      }
      __syncthreads();
    }
  }
}

// A CTA per row (grid-stride over slots); the work buffer of `slice` u32
// per plane (L state slots, then ldp delta slots) in shared memory.
template <bool W>
__global__ void __launch_bounds__(kCtaThreads)
    tlog_drain_cta(u32* nth, u32* ntl, u32* nv, int* length, u64* cutoff,
                   const int* key_idx, const u64* dts, const long long* dvid,
                   const u64* dcut, const long long* counts,
                   unsigned char* ovf, int* out_len, u64* out_cut,
                   long long nslots, long long k, int L, int ld, int ldp,
                   long long slice, int vec) {
  extern __shared__ __align__(16) u32 smem[];
  __shared__ int sums[2 * kCtaThreads / 32];
  jt::CtaGroup<kCtaThreads> g(sums);
  u32* w = smem;
  const Planes<W> A = buffer<W>(w, slice);
  const Planes<W> D = A.at(L);
  int* at = reinterpret_cast<int*>(w + slice * (W ? 3 : 2));
  const int tid = g.rank;

  for (long long s = blockIdx.x; s < nslots; s += gridDim.x) {
    __syncthreads();  // the previous slot is done with the work buffer
    const Raw first = delta_raw(dts, dvid, s, ld, tid);  // the first chunk
    Slot t;
    if (!open_slot(tid, s, key_idx, k, L, ld, length, cutoff, dcut, counts,
                   ovf, out_len, out_cut, &t)) {
      continue;
    }
    // the delta's entries under the cutoff, PAD elsewhere
    int nvalid = 0;
    for (int j0 = 0; j0 < ldp; j0 += kCtaThreads) {
      const int j = j0 + tid;
      bool ok = false;
      if (j < ldp) {
        D.put(j, delta_entry(j0 ? delta_raw(dts, dvid, s, ld, j) : first, t.cut, &ok));
      }
      nvalid += g.count(ok);
    }
    if (nvalid == 0 && t.cut == t.a_cut && t.cnt >= kTrimNoop) {  // unchanged
      report(tid, t, 0, ovf, out_len, out_cut);
      continue;
    }
    const long long off = t.row * L;
    const Planes<W> R{W ? nth + off : nullptr, ntl + off, nv + off};
    // (the min's barrier orders the copy and the delta's writes ahead of
    // the reads below)
    const int na = g.min(copy_row<W>(g, A, R, t.old_len, vec != 0, t.cut));
    if (nvalid > 1) cta_bitonic<W>(D, ldp);  // each stage ends on a barrier

    // drop delta entries equal to their left neighbour or already in the
    // state row; compact the rest to D[0, nd) in place. A chunk reads
    // before its scan's barrier and writes after it, at or below each
    // source index; the left neighbour of a chunk's first entry was read
    // by the chunk before (`last`), never after a write.
    int nd = 0;
    Ent last{kPad, kPad, kPad};
    for (int j0 = 0; j0 < (nvalid ? ldp : 0); j0 += kCtaThreads) {
      const int j = j0 + tid;
      bool keep = false;
      int p = 0;
      Ent e{kPad, kPad, kPad};
      if (j < ldp) {
        e = D.get(j);
        keep = keep_delta<W>(A, na, e, tid ? D.get(j - 1) : last, j == 0, &p);
      }
      const int jl = j0 + kCtaThreads - 1;
      if (jl < ldp) last = D.get(jl);
      int tot;
      const int pos = g.scan(keep, &tot);
      if (keep) {
        D.put(nd + pos, e);
        at[nd + pos] = p;
      }
      nd += tot;
    }
    if (nvalid) __syncthreads();
    finish_row<W>(g, t, R, A, na, D, at, nd, L, key_idx != nullptr, length,
                  cutoff, ovf, out_len, out_cut);
  }
}

// ---- the cluster class: a row's work buffer split across a cluster -------

// A CTA's view of one array of every work buffer of its cluster: CTA r's
// share at peers[r] + off (u32), `plane` u32 a plane, entries [r << log_p,
// (r + 1) << log_p) of the array (plane == 1 << log_p). Generic pointers:
// another CTA's shared memory through the cluster window, or device
// scratch.
template <bool W>
struct Dist {
  u32* const* peers;
  int off, log_p;
  __device__ __forceinline__ Planes<W> part(int r) const {
    return buffer<W>(peers[r] + off, 1 << log_p);
  }
  __device__ __forceinline__ Ent get(int i) const {
    return part(i >> log_p).get(i & ((1 << log_p) - 1));
  }
  __device__ __forceinline__ void put(int i, const Ent& e) const {
    part(i >> log_p).put(i & ((1 << log_p) - 1), e);
  }
};

struct DistInt {
  u32* const* peers;
  int off, log_p;
  __device__ __forceinline__ int& operator[](int i) const {
    return reinterpret_cast<int*>(peers[i >> log_p] + off)[i & ((1 << log_p) - 1)];
  }
};

// One round of the cluster's merge sort: runs of h entries of src (h a
// multiple of the P entries a CTA holds) merged pairwise into runs of 2h
// of dst. CTA q writes outputs [q * P, (q + 1) * P) of dst, its share
// `out`, each thread a contiguous stretch of them: a co-rank search over the two runs for its
// first output (merge path, a before b on ties), then a merge in order.
template <bool W>
__device__ void merge_round(const Dist<W>& src, const Planes<W>& out, int q,
                            int log_p, int h) {
  const int P = 1 << log_p;
  const int per = (P + kCtaThreads - 1) / kCtaThreads;
  const int o0 = q * P + static_cast<int>(threadIdx.x) * per;
  const int o1 = min(o0 + per, (q + 1) * P);
  if (o0 >= o1) return;
  const int base = o0 / (2 * h) * (2 * h), d = o0 - base;
  int lo = d > h ? d - h : 0, hi = d < h ? d : h;
  while (lo < hi) {  // outputs [0, d) take a[mid] iff a[mid] <= b[d - 1 - mid]
    const int mid = (lo + hi) >> 1;
    const bool in = !lt<W>(src.get(base + h + d - mid - 1), src.get(base + mid));
    lo = in ? mid + 1 : lo;
    hi = in ? hi : mid;
  }
  int i = lo, j = d - lo;
  const Ent pad{kPad, kPad, kPad};
  Ent x = i < h ? src.get(base + i) : pad, y = j < h ? src.get(base + h + j) : pad;
  for (int o = o0; o < o1; ++o) {
    const bool ta = i < h && (j >= h || !lt<W>(y, x));
    out.put(o - q * P, ta ? x : y);
    if (ta) {
      if (++i < h) x = src.get(base + i);
    } else {
      if (++j < h) y = src.get(base + h + j);
    }
  }
}

// A cluster of n CTAs per row (grid-stride over the clusters). CTA q's
// share of the work buffer (u32): two delta buffers of P entries each
// plane (the merge's two sides), P ints of bounds (`at`, by compacted
// delta index), P ints of compaction positions, then state slots
// [q * pa, (q + 1) * pa), each plane; in shared memory, or (InScratch)
// at blockIdx.x * stride bytes of device scratch. A CTA reaches its own
// share through `mine` (shared memory as such, so the compiler emits
// shared-memory accesses), the others' through peers.
template <bool W, bool InScratch>
__global__ void __launch_bounds__(kCtaThreads)
    tlog_drain_cluster(u32* nth, u32* ntl, u32* nv, int* length, u64* cutoff,
                       const int* key_idx, const u64* dts, const long long* dvid,
                       const u64* dcut, const long long* counts,
                       unsigned char* ovf, int* out_len, u64* out_cut,
                       char* scratch, long long stride, long long nslots,
                       long long k, int L, int ld, int log_p, int pa) {
  extern __shared__ __align__(16) u32 smem[];
  __shared__ int sums[2 * kCtaThreads / 32];
  __shared__ u32* peers[kClusterMax];
  __shared__ int tab[kClusterMax];
  __shared__ int pub[2];
  cg::cluster_group cluster = cg::this_cluster();
  jt::CtaGroup<kCtaThreads> g(sums);
  const int q = static_cast<int>(cluster.block_rank());
  const int n = static_cast<int>(cluster.num_blocks());
  const long long cid = blockIdx.x / n, nclusters = gridDim.x / n;
  const int tid = g.rank, crank = q * kCtaThreads + tid, csize = n * kCtaThreads;
  constexpr int NP = W ? 3 : 2;
  const int P = 1 << log_p;
  if (tid < n) {
    peers[tid] = InScratch
        ? reinterpret_cast<u32*>(scratch + (cid * n + tid) * stride)
        : cluster.map_shared_rank(smem, tid);
  }
  u32* const mine = InScratch ? reinterpret_cast<u32*>(scratch + blockIdx.x * stride) : smem;
  const Dist<W> D0{peers, 0, log_p}, D1{peers, NP * P, log_p};
  const DistInt AT{peers, 2 * NP * P, log_p};
  int xc = 0;

  for (long long s = cid; s < nslots; s += nclusters) {
    cluster.sync();  // every CTA is done with the previous slot's buffers
    int* pos = reinterpret_cast<int*>(mine + 2 * NP * P + P);
    const Planes<W> A = buffer<W>(mine + 2 * NP * P + 2 * P, pa);
    Slot t;
    if (!open_slot(crank, s, key_idx, k, L, ld, length, cutoff, dcut, counts,
                   ovf, out_len, out_cut, &t)) {
      continue;
    }
    // this CTA's delta columns [q * P, (q + 1) * P) under the cutoff, PAD
    // elsewhere
    const Planes<W> S0 = buffer<W>(mine, P), S1 = buffer<W>(mine + NP * P, P);
    int* const at_mine = reinterpret_cast<int*>(mine + 2 * NP * P);
    int nv_here = 0;
    for (int i0 = 0; i0 < P; i0 += kCtaThreads) {
      const int i = i0 + tid;
      bool ok = false;
      if (i < P) S0.put(i, delta_entry(delta_raw(dts, dvid, s, ld, q * P + i), t.cut, &ok));
      nv_here += g.count(ok);
    }
    jt::exchange(cluster, pub, xc, nv_here, tab);
    int nvalid = 0;
    for (int r = 0; r < n; ++r) nvalid += tab[r];
    if (nvalid == 0 && t.cut == t.a_cut && t.cnt >= kTrimNoop) {  // unchanged
      report(crank, t, 0, ovf, out_len, out_cut);
      continue;
    }
    const long long off = t.row * L;
    const Planes<W> R{W ? nth + off : nullptr, ntl + off, nv + off};
    // this CTA's state slots, copied (the row is rewritten in place), and
    // the first entry among them below the cutoff
    const int a0 = min(q * pa, t.old_len), a1 = min(a0 + pa, t.old_len);
    int fail = t.old_len;
    for (int i = a0 + tid; i < a1; i += kCtaThreads) {
      const Ent e = R.get(i);
      A.put(i - a0, e);
      if (i < fail && !ts_ge<W>(e, t.cut)) fail = i;
    }
    fail = g.min(fail);
    if (nvalid > 1) cta_bitonic<W>(S0, P);  // each stage ends on a barrier
    jt::exchange(cluster, pub, xc, fail, tab);  // (the sorted runs, published)
    int na = t.old_len;
    for (int r = 0; r < n; ++r) na = min(na, tab[r]);
    // the runs merged across the cluster, log2(n) rounds
    bool in0 = true;
    for (int h = P; nvalid > 1 && h < n * P; h <<= 1) {
      merge_round<W>(in0 ? D0 : D1, in0 ? S1 : S0, q, log_p, h);
      in0 = !in0;
      cluster.sync();
    }
    const Dist<W>& S = in0 ? D0 : D1;
    const Dist<W>& T = in0 ? D1 : D0;
    // drop entries equal to their left neighbour or already in the state
    // row (searched in the row itself: nothing writes it before the
    // barrier ahead of the write-back); number the rest
    const Planes<W> Sq = in0 ? S0 : S1;
    int kept = 0;
    for (int i0 = 0; i0 < (nvalid ? P : 0); i0 += kCtaThreads) {
      const int i = i0 + tid, j = q * P + i;
      bool keep = false;
      if (i < P) {
        const Ent e = Sq.get(i);
        int p;
        keep = keep_delta<W>(R, na, e, i ? Sq.get(i - 1) : S.get(j > 0 ? j - 1 : 0),
                             j == 0, &p);
      }
      int tot;
      const int pp = g.scan(keep, &tot);
      if (i < P) pos[i] = keep ? kept + pp : -1;
      kept += tot;
    }
    jt::exchange(cluster, pub, xc, kept, tab);
    int base = 0, nd = 0;
    for (int r = 0; r < n; ++r) {
      base += r < q ? tab[r] : 0;
      nd += tab[r];
    }
    // the kept entries compacted into T[0, nd), each with its bound in
    // the state row's surviving entries
    for (int i = tid; i < (nvalid ? P : 0); i += kCtaThreads) {
      const int pp = pos[i];
      if (pp >= 0) {
        const Ent e = Sq.get(i);
        T.put(base + pp, e);
        AT[base + pp] = lower_bound<W>(R, na, e);
      }
    }
    cluster.sync();
    const int m = na + nd;
    if (key_idx && m > L) {  // the sparse rule
      report(crank, t, 1, ovf, out_len, out_cut);
      continue;
    }
    // the trim's target, the new cutoff and the surviving prefixes, from
    // the merged row (every warp searches alike)
    u64 target = 0;
    if (t.cnt == 0) {
      if (m > 0) target = ts_of<W>(nd ? merged_at<W>(R, na, T, nd, 0) : R.get(0)) + 1;
    } else if (t.cnt > 0 && t.cnt <= m) {
      const int kk = static_cast<int>(t.cnt - 1);
      target = ts_of<W>(nd ? merged_at<W>(R, na, T, nd, kk) : R.get(kk));
    }
    const u64 new_cut = t.cut > target ? t.cut : target;
    const int ka = new_cut == t.cut ? na : live_prefix<W>(R, na, new_cut);
    const int kd = live_prefix<W>(T, nd, new_cut);
    const int nk = ka + kd;
    cluster.sync();  // every CTA has read the state row: write it
    if (nd > 0 || nk != t.old_len) {
      // a state entry's merged position is its index plus the delta
      // entries whose bound lies at or below it; state entries below the
      // first delta entry's bound keep their slots
      const int at0 = kd ? AT[0] : ka;
      const int i0 = at0 < ka ? at0 : ka;
      for (int i = max(i0, q * pa) + tid; i < min(ka, q * pa + pa); i += kCtaThreads) {
        R.put(i + jt::partition_point(kd, [&](int j) { return AT[j] <= i; }),
              A.get(i - q * pa));
      }
      const Planes<W> Tq = in0 ? S1 : S0;
      for (int j = q * P + tid; j < min(kd, q * P + P); j += kCtaThreads) {
        const int a = at_mine[j - q * P];
        R.put(j + (a < ka ? a : ka), Tq.get(j - q * P));
      }
      for (int p = nk + crank; p < t.old_len; p += csize) R.put(p, Ent{kPad, kPad, kPad});
    }
    if (crank == 0) {
      length[t.row] = nk;
      cutoff[t.row] = new_cut;
      ovf[t.s] = 0;
      if (out_len) {
        out_len[t.s] = nk;
        out_cut[t.s] = new_cut;
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

template <typename F>
cudaError_t allow_smem(F* fn, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool W>
int launch(int kind, int log_e, void* nth, void* ntl, void* nv, void* length,
           void* cutoff, const void* key_idx, const void* dts,
           const void* dvid, const void* dcut, const void* counts, void* ovf,
           void* out_len, void* out_cut, void* scratch, long long nslots,
           long long k, long long L, long long ld, long long ldp,
           long long rows_per_cta, long long slice, long long grid,
           long long smem, int vec, long long csize, long long stride,
           cudaStream_t stream) {
  auto* a_h = static_cast<u32*>(nth);
  auto* a_l = static_cast<u32*>(ntl);
  auto* a_v = static_cast<u32*>(nv);
  auto* len = static_cast<int*>(length);
  auto* cut = static_cast<u64*>(cutoff);
  auto* ki = static_cast<const int*>(key_idx);
  auto* ts = static_cast<const u64*>(dts);
  auto* vid = static_cast<const long long*>(dvid);
  auto* dc = static_cast<const u64*>(dcut);
  auto* cn = static_cast<const long long*>(counts);
  auto* of = static_cast<unsigned char*>(ovf);
  auto* ol = static_cast<int*>(out_len);
  auto* oc = static_cast<u64*>(out_cut);
  const unsigned blocks = static_cast<unsigned>(grid);
  const size_t bytes = static_cast<size_t>(smem);
  cudaError_t e = cudaSuccess;
  if (kind == 0) {
    const unsigned threads = static_cast<unsigned>(32 * rows_per_cta);
    const int rpc = static_cast<int>(rows_per_cta);
#define JT_WARP_CASE(LE)                                                      \
  case LE:                                                                    \
    e = allow_smem(tlog_drain_warp<W, LE>, smem);                             \
    if (e != cudaSuccess) return static_cast<int>(e);                         \
    tlog_drain_warp<W, LE><<<blocks, threads, bytes, stream>>>(               \
        a_h, a_l, a_v, len, cut, ki, ts, vid, dc, cn, of, ol, oc, nslots, k,  \
        static_cast<int>(L), static_cast<int>(ld), rpc, slice, vec);          \
    break;
    switch (log_e) {
      JT_WARP_CASE(0)
      JT_WARP_CASE(1)
      JT_WARP_CASE(2)
      JT_WARP_CASE(3)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef JT_WARP_CASE
  } else if (kind == 1) {
    e = allow_smem(tlog_drain_cta<W>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    tlog_drain_cta<W><<<blocks, kCtaThreads, bytes, stream>>>(
        a_h, a_l, a_v, len, cut, ki, ts, vid, dc, cn, of, ol, oc, nslots, k,
        static_cast<int>(L), static_cast<int>(ld), static_cast<int>(ldp), slice,
        vec);
  } else if (kind == 2 && csize >= 2 && csize <= kClusterMax &&
             (csize & (csize - 1)) == 0 && ldp >= 1 && (ldp & (ldp - 1)) == 0 &&
             grid % csize == 0) {
    auto fn = scratch ? tlog_drain_cluster<W, true> : tlog_drain_cluster<W, false>;
    e = allow_smem(fn, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (csize > 8) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kCtaThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(csize);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // a cluster's CTAs must be resident together: refuse a launch the card
    // cannot place one cluster of
    int fits = 0;
    e = cudaOccupancyMaxActiveClusters(&fits, fn, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (fits < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    int log_p = 0;
    while ((1LL << log_p) < ldp) ++log_p;
    e = cudaLaunchKernelEx(&cfg, fn, a_h, a_l, a_v, len, cut, ki, ts, vid, dc, cn,
                           of, ol, oc, static_cast<char*>(scratch), stride, nslots,
                           k, static_cast<int>(L), static_cast<int>(ld), log_p,
                           static_cast<int>(slice));
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nplanes: 3 (wide, nth set) or 2 (narrow, nth null). key_idx: (B,) int32
// rows, or null for the dense drain (B = K slots, row = slot). dts, dvid:
// (B, Ld) u64 and int64; dcut, counts: (B,). ovf: (B,) bytes; out_len,
// out_cut: (B,) for the sparse drain, null for the dense one (its state
// planes are its outputs). kind: 0 the warp class (log_e: log2 of the
// delta entries a lane holds, 0..3; rows_per_cta warps a CTA), 1 a CTA a
// row, 2 a cluster of csize CTAs a row (a power of two, 2..16). ldp:
// delta slots of the work buffer (32 << log_e for the warp class, Ld
// rounded up to a power of two for a CTA, a CTA's share, a power of two,
// for a cluster); slice: u32 per plane of one row's work buffer, at least
// L + ldp, a multiple of 4 (a cluster: the state slots of a CTA's share).
// smem: shared-memory bytes a CTA; scratch: null, or for a cluster whose
// shares live in device memory grid * stride bytes (stride a CTA's
// share). vec: 1 when L % 4 == 0 and the state planes are 16-byte
// aligned. Returns a CUDA error code: cudaErrorInvalidConfiguration for a
// class it does not take or a cluster the card cannot place, else
// cudaGetLastError() after the launch.
extern "C" int jt_tlog_drain(int nplanes, void* nth, void* ntl, void* nv,
                             void* length, void* cutoff, const void* key_idx,
                             const void* dts, const void* dvid,
                             const void* dcut, const void* counts, void* ovf,
                             void* out_len, void* out_cut, void* scratch,
                             long long nslots, long long k, long long L,
                             long long ld, long long kind, long long log_e,
                             long long ldp, long long rows_per_cta,
                             long long slice, long long grid, long long smem,
                             long long vec, long long csize, long long stride,
                             void* stream) {
  if (nslots <= 0) return 0;
  auto fn = nplanes == 3 ? launch<true> : launch<false>;
  return fn(static_cast<int>(kind), static_cast<int>(log_e), nth, ntl, nv,
            length, cutoff, key_idx, dts, dvid, dcut, counts, ovf, out_len,
            out_cut, scratch, nslots, k, L, ld, ldp, rows_per_cta, slice,
            grid, smem, static_cast<int>(vec), csize, stride,
            static_cast<cudaStream_t>(stream));
}
