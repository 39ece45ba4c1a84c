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
// Design: one CTA of 256 threads per row (grid-stride over slots). The
// row's work buffer holds a copy of its L state slots and the delta's Ld
// slots rounded up to a power of two, per plane: in shared memory when it
// fits (the wrapper's SMEM_LIMIT), else in device scratch the wrapper
// allocates per CTA, so rows of any width merge (the code is the same:
// generic pointers). Steps, each ended by a barrier: load the delta
// (invalid entries as PAD) and copy the state row, counting the entries
// that survive the cutoff with __syncthreads_count; bitonic-sort the
// delta; drop each delta entry equal to its left neighbour or present in
// the state row (binary search), compacting with a block scan; then every
// surviving entry finds its merged position as its own index plus a
// binary search in the other list (both are sorted and disjoint). Thread
// 0 reads the trim's entries with a merge-path co-rank search. Positions
// below the trimmed length are written, PAD over the rest of the old
// length. A row with no valid delta entry, no raised cutoff and no trim
// is not written at all.
//
// Bound: bytes. Per live row: the state's valid entries read (4 bytes a
// plane), Ld delta entries (8-byte ts, 8-byte vid), length, cutoff, delta
// cutoff and count read; the rewritten slots written back (positions up
// to the larger of the old and new length), then length and cutoff; plus
// the outputs (overflow byte; sparse: 4 + 8 bytes, and the 4-byte
// index). Compares per row: Ldp/2 * s(s+1)/2 for the sort (Ldp = 2^s),
// Ldp + (old length) for the filters, and log2(L + Ld) per merged and per
// delta entry for the searches.
#include <cuda_runtime.h>

#include "block_ops.cuh"

namespace {

using u32 = unsigned int;
using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr u32 kPad = 0xFFFFFFFFu;
constexpr long long kTrimNoop = 1LL << 62;

// one log entry: (nth, ntl, nv); nth is unused in the narrow layout
struct Ent {
  u32 h, l, v;
};

template <bool W>
__device__ __forceinline__ bool lt(const Ent& a, const Ent& b) {
  if (W && a.h != b.h) return a.h < b.h;
  if (a.l != b.l) return a.l < b.l;
  return a.v < b.v;
}

template <bool W>
__device__ __forceinline__ bool eq(const Ent& a, const Ent& b) {
  return (!W || a.h == b.h) && a.l == b.l && a.v == b.v;
}

// jylis_tpu/ops/tlog.py `_ts_ge`: ts >= cut as lex (nth, ntl) <=
// (~cut_hi, ~cut_lo); the narrow layout compares ntl only
template <bool W>
__device__ __forceinline__ bool ts_ge(const Ent& e, u64 cut) {
  const u64 nc = ~cut;
  const u32 nch = static_cast<u32>(nc >> 32), ncl = static_cast<u32>(nc);
  if (W) return e.h < nch || (e.h == nch && e.l <= ncl);
  return e.l <= ncl;
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

// entries of p[0, n) that are < e (p sorted ascending)
template <bool W>
__device__ int lower_bound(const Planes<W>& p, int n, const Ent& e) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lt<W>(p.get(mid), e)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the k-th entry (0-based) of the merge of sorted, disjoint a[0, na) and
// d[0, nd): a merge-path co-rank search for how many of the first k + 1
// come from a
template <bool W>
__device__ Ent merged_at(const Planes<W>& a, int na, const Planes<W>& d,
                         int nd, int k) {
  const int kk = k + 1;
  int lo = kk - nd > 0 ? kk - nd : 0, hi = kk < na ? kk : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lt<W>(a.get(mid), d.get(kk - mid - 1))) lo = mid + 1;
    else hi = mid;
  }
  const int i = lo, j = kk - lo;
  if (i == 0) return d.get(j - 1);
  if (j == 0) return a.get(i - 1);
  const Ent x = a.get(i - 1), y = d.get(j - 1);
  return lt<W>(x, y) ? y : x;
}

// ascending bitonic sort of d[0, n), n a power of two
template <bool W>
__device__ void bitonic(const Planes<W>& d, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
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

template <bool W>
__global__ void __launch_bounds__(kThreads)
    tlog_drain(u32* nth, u32* ntl, u32* nv, int* length, u64* cutoff,
               const int* key_idx, const u64* dts, const long long* dvid,
               const u64* dcut, const long long* counts, unsigned char* ovf,
               int* out_len, u64* out_cut, u32* scratch, long long nslots,
               long long k, int L, int ld, int ldp) {
  extern __shared__ u32 smem[];
  __shared__ int warp_sums[kWarps];
  __shared__ u64 s_cut;
  const long long wsz = static_cast<long long>(L) + ldp;  // slots a plane
  u32* w = scratch ? scratch + static_cast<long long>(blockIdx.x) * wsz *
                                   (W ? 3 : 2)
                   : smem;
  const Planes<W> A{W ? w : nullptr, w + (W ? wsz : 0), w + (W ? 2 : 1) * wsz};
  const Planes<W> D = A.at(L);
  const int tid = threadIdx.x;

  for (long long s = blockIdx.x; s < nslots; s += gridDim.x) {
    __syncthreads();  // the previous slot is done with the work buffer
    long long row = s;
    if (key_idx) {
      row = static_cast<u32>(key_idx[s]);
      if (row >= k) {  // pad slot
        if (tid == 0) {
          ovf[s] = 0;
          out_len[s] = 0;
          out_cut[s] = 0;
        }
        continue;
      }
    }
    const int old_len = length[row];
    const u64 a_cut = cutoff[row];
    const u64 d_cut = dcut[s];
    const u64 cut = a_cut > d_cut ? a_cut : d_cut;
    const long long cnt = counts[s];
    if (!key_idx && old_len > L - ld) {  // the dense rule, on every row
      if (tid == 0) ovf[s] = 1;
      continue;
    }
    const long long off = row * L;
    const Planes<W> R{W ? nth + off : nullptr, ntl + off, nv + off};

    // the delta's entries under the cutoff, PAD elsewhere
    int nvalid = 0;
    for (int j0 = 0; j0 < ldp; j0 += kThreads) {
      const int j = j0 + tid;
      bool ok = false;
      if (j < ldp) {
        Ent e{kPad, kPad, kPad};
        if (j < ld) {
          const u64 ts = dts[s * ld + j];
          const long long vid = dvid[s * ld + j];
          ok = vid >= 0 && ts >= cut;
          if (ok) {
            const u64 nt = ~ts;
            e = Ent{static_cast<u32>(nt >> 32), static_cast<u32>(nt),
                    ~(static_cast<u32>(vid) + 1u)};
          }
        }
        D.put(j, e);
      }
      nvalid += __syncthreads_count(ok);
    }
    if (nvalid == 0 && cut == a_cut && cnt >= kTrimNoop) {  // unchanged
      if (tid == 0) {
        ovf[s] = 0;
        if (out_len) {
          out_len[s] = old_len;
          out_cut[s] = a_cut;
        }
      }
      continue;
    }

    // the state row's entries, and how many survive the cutoff (a prefix)
    int na = 0;
    for (int i0 = 0; i0 < old_len; i0 += kThreads) {
      const int i = i0 + tid;
      bool ok = false;
      if (i < old_len) {
        const Ent e = R.get(i);
        A.put(i, e);
        ok = ts_ge<W>(e, cut);
      }
      na += __syncthreads_count(ok);
    }

    bitonic<W>(D, ldp);

    // drop delta entries equal to their left neighbour or already in the
    // state row; compact the rest to d[0, nd)
    int nd = 0;
    for (int j0 = 0; j0 < ldp; j0 += kThreads) {
      const int j = j0 + tid;
      bool keep = false;
      Ent e{kPad, kPad, kPad};
      if (j < ldp) {
        e = D.get(j);
        keep = e.v != kPad && (j == 0 || !eq<W>(D.get(j - 1), e));
        if (keep) {
          const int p = lower_bound<W>(A, na, e);
          keep = p == na || !eq<W>(A.get(p), e);
        }
      }
      int tot;
      // the scan's barriers order this chunk's reads before its writes;
      // writes land at or below their source index, so the next chunk's
      // reads (from index j0 + kThreads - 1 on) see what they should
      const int pos = jt::block_scan<kThreads>(keep ? 1 : 0, warp_sums, &tot);
      if (keep) D.put(nd + pos, e);
      nd += tot;
      __syncthreads();
    }

    const int m = na + nd;
    if (key_idx && m > L) {  // the sparse rule
      if (tid == 0) {
        ovf[s] = 1;
        out_len[s] = old_len;
        out_cut[s] = a_cut;
      }
      continue;
    }

    // the fused trim's target, from the merged row
    if (tid == 0) {
      u64 target = 0;
      if (cnt == 0) {
        if (m > 0) target = ts_of<W>(merged_at<W>(A, na, D, nd, 0)) + 1;
      } else if (cnt > 0 && cnt <= m) {
        target = ts_of<W>(merged_at<W>(A, na, D, nd, static_cast<int>(cnt - 1)));
      }
      s_cut = cut > target ? cut : target;
    }
    __syncthreads();
    const u64 new_cut = s_cut;
    int nk = 0;
    for (int i0 = 0; i0 < m; i0 += kThreads) {
      const int i = i0 + tid;
      bool ok = false;
      if (i < m) ok = ts_ge<W>(i < na ? A.get(i) : D.get(i - na), new_cut);
      nk += __syncthreads_count(ok);
    }

    // write the merged, trimmed row; PAD over what is left of the old one
    if (nd > 0 || nk != old_len) {
      for (int i = tid; i < na; i += kThreads) {
        const Ent e = A.get(i);
        const int p = i + lower_bound<W>(D, nd, e);
        if (p < nk) R.put(p, e);
      }
      for (int j = tid; j < nd; j += kThreads) {
        const Ent e = D.get(j);
        const int p = j + lower_bound<W>(A, na, e);
        if (p < nk) R.put(p, e);
      }
      for (int p = nk + tid; p < old_len; p += kThreads) {
        R.put(p, Ent{kPad, kPad, kPad});
      }
    }
    if (tid == 0) {
      length[row] = nk;
      cutoff[row] = new_cut;
      ovf[s] = 0;
      if (out_len) {
        out_len[s] = nk;
        out_cut[s] = new_cut;
      }
    }
  }
}

template <bool W>
int launch(void* nth, void* ntl, void* nv, void* length, void* cutoff,
           const void* key_idx, const void* dts, const void* dvid,
           const void* dcut, const void* counts, void* ovf, void* out_len,
           void* out_cut, void* scratch, long long nslots, long long k,
           long long L, long long ld, long long ldp, long long grid,
           cudaStream_t stream) {
  if (nslots <= 0) return 0;
  const size_t smem =
      scratch ? 0 : static_cast<size_t>(W ? 3 : 2) * 4 * (L + ldp);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(tlog_drain<W>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  tlog_drain<W><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<u32*>(nth), static_cast<u32*>(ntl), static_cast<u32*>(nv),
      static_cast<int*>(length), static_cast<u64*>(cutoff),
      static_cast<const int*>(key_idx), static_cast<const u64*>(dts),
      static_cast<const long long*>(dvid), static_cast<const u64*>(dcut),
      static_cast<const long long*>(counts),
      static_cast<unsigned char*>(ovf), static_cast<int*>(out_len),
      static_cast<u64*>(out_cut), static_cast<u32*>(scratch), nslots, k,
      static_cast<int>(L), static_cast<int>(ld), static_cast<int>(ldp));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nplanes: 3 (wide, nth set) or 2 (narrow, nth null). key_idx: (B,) int32
// rows, or null for the dense drain (B = K slots, row = slot). dts, dvid:
// (B, Ld) u64 and int64; dcut, counts: (B,). ovf: (B,) bytes; out_len,
// out_cut: (B,) for the sparse drain, null for the dense one (its state
// planes are its outputs). scratch: null to keep each row's work buffer in
// shared memory, else grid * nplanes * (L + ldp) u32 of device memory.
// ldp: Ld rounded up to a power of two. Returns cudaGetLastError() after
// the launch.
extern "C" int jt_tlog_drain(int nplanes, void* nth, void* ntl, void* nv,
                             void* length, void* cutoff, const void* key_idx,
                             const void* dts, const void* dvid,
                             const void* dcut, const void* counts, void* ovf,
                             void* out_len, void* out_cut, void* scratch,
                             long long nslots, long long k, long long L,
                             long long ld, long long ldp, long long grid,
                             void* stream) {
  auto fn = nplanes == 3 ? launch<true> : launch<false>;
  return fn(nth, ntl, nv, length, cutoff, key_idx, dts, dvid, dcut, counts,
            ovf, out_len, out_cut, scratch, nslots, k, L, ld, ldp, grid,
            static_cast<cudaStream_t>(stream));
}
