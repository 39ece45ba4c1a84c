// ujson_fold_flat: the closed-form n-way fold of each key's UJSON delta
// stack.
//
// Replaces jylis_tpu/ops/ujson_resident.py `_fold_flat_one` (:88), which
// XLA runs under `_fold_grid` (:136) for stacks of D <= 64 deltas in
// `fold_join_subset` (:218), `fold_join_aligned` (:244) and
// `fold_broadcast_rows` (:256).
//
// Input: a (K, D, W) grid of DocBatch rows (jylis_tpu_torch/ops/
// ujson_device.py): per key, D delta rows of W sorted, duplicate-free,
// pad-filled dots (T = int narrow, pad 0x7FFFFFFF; T = unsigned long long
// wide, pad all ones, unsigned order) with int32 payload ids, a (D, R) u32
// version vector and (D, C) sorted, duplicate-free, pad-filled clouds.
// Per key, over its E = D * W entries in flat (delta, slot) order: an
// entry survives iff it is valid and every delta either contains it (is
// in that delta's dots) or does not cover it (seq <= vv[col], col as
// col_of decodes it, or the entry is in that delta's cloud). The
// survivors are sorted ascending, and of equal dots the LAST in flat
// order keeps its payload id (JAX's stable argsort, then dropping each
// entry equal to its right neighbour; ujson_resident.py:119-127); pads
// and -1 ids fill the rest of the E slots. vv = the max over the D rows; cloud = the D * C entries
// sorted and deduplicated, pads after.
//
// Design: no sort. Survival depends on the dot alone, so equal dots
// survive or die together, and the copy JAX keeps is the one no later
// delta holds. Entry (i, s) with dot x is KEPT iff no delta j != i
// covers x without holding it, and no delta j > i holds it. The kept
// dots are distinct, and each one's output slot is its rank among them:
// sum over the rows j of P_j(lb_j(x)), lb_j the lower bound of x in row
// j and P_j(p) the kept entries of row j before p (a kept bit per entry,
// a prefix count per 32-entry word). Cloud entries the same way, keeping
// the FIRST copy: (j, t) is kept iff no earlier row holds its dot. Pads
// are never probed.
//
// Classes (ops/ujson_resident.py `flat_plan`, ops/row_plan.py):
//   warp     D <= 64 deltas of at most B = 4 or 8 dots and cloud entries
//            (the store's flat legs): a warp per key, several keys a CTA.
//            Lane L holds deltas L and L + 32 in registers (their dots,
//            cloud entries, payload ids and kept bits); the warp's slice
//            of shared memory holds the key's live entries listed in lane
//            order (a warp scan numbers them), the lists of kept ones, and
//            the vv rows, copied in by cp.async (row stride R | 1: a
//            column read by every lane hits 32 banks). The entries go
//            four at a time: every lane reads each from the list and
//            answers for its two deltas (register compares and one vv
//            read), branch-free, then a ballot per entry decides; a kept
//            entry's slot is a warp sum of the lanes' kept bits below it.
//            No search, three __syncwarp a key.
//   cta      wider deltas: a CTA of 256 threads per key, the key's rows in
//            shared memory; the threads map over the concatenation of the
//            rows' live prefixes (a binary search for the first pad, one
//            warp's shuffle scan), probe with binary searches, set kept
//            bits with shared-memory atomics, count them per word, then
//            place. Five barriers a key.
//   cluster  keys past what a CTA holds or launches of too few keys to
//            fill the card: a thread-block cluster of up to 8 CTAs per key
//            (cudaLaunchKernelEx), CTA q probing the entries of deltas
//            [q * rpr, (q + 1) * rpr); the rows are read from the input
//            planes through L1 and the kept bits and counts sit in device
//            scratch, one region a cluster; cluster.sync() between the
//            steps. (A variant holding each CTA's deltas in its shared
//            memory and reading the others' through distributed shared
//            memory measured up to 2.3x slower: PERF.md §6.)
// Crossovers measured on an H100 by scripts/row_kernel_profile.py
// --sweep flat: PERF.md §6.
//
// Bound: bytes (each input read once: E dots and ids, D * C cloud
// entries, D * R vv; each output written once: E dots and ids, D * C
// cloud entries, R vv); operations, per key: D probes per live entry
// (a search of log2 W + log2 C + 3 steps each), one placement per kept
// dot and per kept cloud entry, and D * R for the vv max.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_ops.cuh"
#include "warp_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using u32 = unsigned int;
using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kClusterMax = 8;  // the portable cluster size

enum Kind { kWarp = 0, kCta = 1, kCluster = 2 };

template <typename T>
struct Layout;
template <>
struct Layout<int> {
  static constexpr int kPad = 0x7FFFFFFF;
  __device__ static u64 bits(int x) { return static_cast<u32>(x); }
};
template <>
struct Layout<u64> {
  static constexpr u64 kPad = ~0ull;
  __device__ static u64 bits(u64 x) { return x; }
};

// the launch's planes and widths
template <typename T>
struct Args {
  const T* dots;
  const int* pay;
  const u32* vv;
  const T* cloud;
  T* o_dots;
  int* o_pay;
  u32* o_vv;
  T* o_cloud;
  int d, w, c, r, shift;
  int wd, wc;  // 32-entry words of a dot row and of a cloud row
  int rpr;     // deltas a cluster CTA probes
};

// a dot's vv column as JAX's fold indexes vv (ujson_resident.py:107): the
// column's low 32 bits as int32, min(., r - 1), then a negative index
// counted from the end and clamped to 0 (columns >= 2^31, bit 63 of a
// wide dot, land on r - 1 .. 0 or on 0)
template <typename T>
__device__ __forceinline__ int col_of(T x, int shift, int r) {
  const int c = min(static_cast<int>(static_cast<u32>(Layout<T>::bits(x) >> shift)), r - 1);
  return c < 0 ? max(c + r, 0) : c;
}

template <typename T>
__device__ __forceinline__ u32 seq_of(T x, int shift) {
  return static_cast<u32>(Layout<T>::bits(x) & ((1ull << shift) - 1));
}

// ---- the warp class: a key's deltas in registers ----------------------------

constexpr int kBatch = 4;  // items a warp has in flight at once

// exclusive prefix sum of v over the warp; *total gets the sum
__device__ __forceinline__ int warp_exscan(int v, int* total) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(jt::kFullMask, incl, o);
    if (lane >= o) incl += y;
  }
  *total = __shfl_sync(jt::kFullMask, incl, 31);
  return incl - v;
}

// the kept items of (bits of) a lane's two deltas below x: h = 0, 1
template <typename T, int B>
__device__ __forceinline__ int kept_below(const T (&v)[2][B], const u32 (&bits)[2], T x) {
  int below = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int lb = 0;
#pragma unroll
    for (int b = 0; b < B; ++b) lb += v[h][b] < x;
    below += __popc(bits[h] & ((1u << lb) - 1u));
  }
  return below;
}

// A warp per key, keys_per_cta warps a CTA, each with `stride` bytes of
// the CTA's shared memory (ujson_resident.flat_plan sizes it): the key's
// live dots and cloud entries listed in lane order with their places
// (delta << 8 | slot) and the dots' payload ids, the lists of kept ones,
// and the vv rows. D <= 64, W and C <= B.
template <typename T, int B>
__global__ void __launch_bounds__(kThreads)
    ujson_fold_flat_warp(Args<T> a, long long stride, long long nkeys,
                         int keys_per_cta) {
  extern __shared__ __align__(16) char smem[];
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31);
  const T pad = Layout<T>::kPad;
  const int d = a.d, W = a.w, C = a.c, R = a.r, rs = a.r | 1, cap = a.d * B;
  T* xd = reinterpret_cast<T*>(smem + warp * stride);  // [cap] live dots
  T* xc = xd + cap;                                    // [cap] live clouds
  int* pd = reinterpret_cast<int*>(xc + cap);          // [cap] their places
  int* pc = pd + cap;
  int* yd = pc + cap;                                  // [cap] dots' ids
  unsigned short* kd = reinterpret_cast<unsigned short*>(yd + cap);  // kept
  unsigned short* kc = kd + cap;
  u32* sv = reinterpret_cast<u32*>(kc + cap);  // [d * rs] vv rows
  for (long long k = static_cast<long long>(blockIdx.x) * keys_per_cta + warp;
       k < nkeys; k += static_cast<long long>(gridDim.x) * keys_per_cta) {
    const long long kk = k * d;
    // lane L: deltas L and L + 32 (h = 0, 1), live entries first, with
    // their payload ids
    T dv[2][B], cv[2][B];
    int pv[2][B], nl[2], nc[2];
    u32 km[2] = {0u, 0u}, ckm[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // loads clamp to the last row and slot
      const int j = lane + 32 * h;
      const long long row = kk + min(j, d - 1);
      nl[h] = nc[h] = 0;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const T x = __ldg(a.dots + row * W + min(b, W - 1));
        const int id = __ldg(a.pay + row * W + min(b, W - 1));
        const T y = __ldg(a.cloud + row * C + min(b, C - 1));
        dv[h][b] = j < d && b < W ? x : pad;
        pv[h][b] = j < d && b < W ? id : -1;
        cv[h][b] = j < d && b < C ? y : pad;
        nl[h] += dv[h][b] != pad;
        nc[h] += cv[h][b] != pad;
      }
    }
    __syncwarp();  // the previous key is done with the slice
    // the live items, listed in lane order
    int ndots, ncloud;
    const int od0 = warp_exscan(nl[0] + nl[1], &ndots);
    const int oc0 = warp_exscan(nc[0] + nc[1], &ncloud);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int place = (lane + 32 * h) << 8 | b;
        if (b < nl[h]) {
          const int t = od0 + (h ? nl[0] : 0) + b;
          xd[t] = dv[h][b];
          pd[t] = place;
          yd[t] = pv[h][b];
        }
        if (b < nc[h]) {
          const int t = oc0 + (h ? nc[0] : 0) + b;
          xc[t] = cv[h][b];
          pc[t] = place;
        }
      }
    }
    // the vv rows into shared memory by asynchronous copies (cp.async:
    // every row's copy in flight at once, no register staging); the
    // output vv is their max
    const u32* gv = a.vv + kk * R;
    for (int j = 0; j < d; ++j) {
      for (int q = lane; q < R; q += 32) {
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(sv + j * rs + q));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gv + j * R + q)
                     : "memory");
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();  // the lists and sv are written
    for (int q = lane; q < R; q += 32) {
      u32 m = 0;
      for (int j = 0; j < d; ++j) m = max(m, sv[j * rs + q]);
      a.o_vv[k * R + q] = m;
    }

    // kept dots: every lane answers for its two deltas, a ballot decides;
    // the owner records the bit, lane 0 the kept list. A batch's items
    // are all tested before any is voted on, so their latencies overlap.
    int nkd = 0, nkc = 0;
    for (int t0 = 0; t0 < ndots; t0 += kBatch) {
      bool bad[kBatch];
      int at[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {  // no branch: reads clamp
        const int t = min(t0 + e, ndots - 1);
        const T x = xd[t];
        at[e] = pd[t];
        const int i = at[e] >> 8;
        const int col = col_of(x, a.shift, R);
        const u32 sq = seq_of(x, a.shift);
        bad[e] = false;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = lane + 32 * h;
          bool has = false, inc = false;
#pragma unroll
          for (int b = 0; b < B; ++b) {
            has |= dv[h][b] == x;
            inc |= cv[h][b] == x;
          }
          const bool cover = (sq <= sv[min(j, d - 1) * rs + col]) | inc;
          bad[e] |= (j != i) & (j < d) & (has ? j > i : cover);
        }
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int i = at[e] >> 8, s = at[e] & 255;
        const bool keep = __ballot_sync(jt::kFullMask, bad[e]) == 0 && t0 + e < ndots;
        km[0] |= keep && lane == i ? 1u << s : 0u;
        km[1] |= keep && lane + 32 == i ? 1u << s : 0u;
        if (lane == 0) kd[nkd] = static_cast<unsigned short>(t0 + e);
        nkd += keep;
      }
    }
    // kept cloud entries: no earlier delta holds the entry
    for (int t0 = 0; t0 < ncloud; t0 += kBatch) {
      bool held[kBatch];
      int at[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int t = min(t0 + e, ncloud - 1);
        const T y = xc[t];
        at[e] = pc[t];
        const int i = at[e] >> 8;
        held[e] = false;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bool inc = false;
#pragma unroll
          for (int b = 0; b < B; ++b) inc |= cv[h][b] == y;
          held[e] |= (lane + 32 * h < i) & inc;
        }
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int i = at[e] >> 8, s = at[e] & 255;
        const bool keep = __ballot_sync(jt::kFullMask, held[e]) == 0 && t0 + e < ncloud;
        ckm[0] |= keep && lane == i ? 1u << s : 0u;
        ckm[1] |= keep && lane + 32 == i ? 1u << s : 0u;
        if (lane == 0) kc[nkc] = static_cast<unsigned short>(t0 + e);
        nkc += keep;
      }
    }
    __syncwarp();  // the kept lists are written

    // placement: a kept item's slot is the lanes' kept items below it;
    // lane e writes the batch's item e
    T* od = a.o_dots + kk * W;
    int* op = a.o_pay + kk * W;
    T* oc = a.o_cloud + kk * C;
    for (int t0 = 0; t0 < nkd; t0 += kBatch) {
      int below[kBatch], slot = 0, mine = 0;
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int t = kd[min(t0 + e, nkd - 1)];
        below[e] = kept_below<T, B>(dv, km, xd[t]);
        mine = lane == e ? t : mine;
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int sl = __reduce_add_sync(jt::kFullMask, below[e]);
        slot = lane == e ? sl : slot;
      }
      if (lane < kBatch && t0 + lane < nkd) {
        od[slot] = xd[mine];
        op[slot] = yd[mine];
      }
    }
    for (int t0 = 0; t0 < nkc; t0 += kBatch) {
      int below[kBatch], slot = 0, mine = 0;
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int t = kc[min(t0 + e, nkc - 1)];
        below[e] = kept_below<T, B>(cv, ckm, xc[t]);
        mine = lane == e ? t : mine;
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int sl = __reduce_add_sync(jt::kFullMask, below[e]);
        slot = lane == e ? sl : slot;
      }
      if (lane < kBatch && t0 + lane < nkc) oc[slot] = xc[mine];
    }
    for (int p = nkd + lane; p < d * W; p += 32) {
      od[p] = pad;
      op[p] = -1;
    }
    for (int p = nkc + lane; p < d * C; p += 32) oc[p] = pad;
  }
}

// ---- the CTA and cluster classes: rows in shared or device memory ----------

// One holder's work buffer, carved as the wrapper's flat_work_bytes sizes
// it. CTA class (scr null): the key's dots, clouds and vv, their kept
// bits and per-word prefix counts, the live prefix and kept count of
// every row, and the exclusive scans of the live prefixes, all in shared
// memory. Cluster class: the rows stay in the input planes; the bits,
// counts and per-row totals of every row sit in the cluster's region of
// device scratch, and only this CTA's scans in shared memory.
template <typename T>
struct Work {
  T *dots, *cloud;
  u32 *vv, *kbits, *cbits;
  int *kpre, *cpre, *nla, *nca, *kt, *ct, *off, *coff;
  __device__ Work(char* smem, char* scr, int own, const Args<T>& a) {
    const int held = scr ? 0 : a.d;
    char* p = smem;
    dots = reinterpret_cast<T*>(p);
    p += sizeof(T) * held * a.w;
    cloud = reinterpret_cast<T*>(p);
    p += sizeof(T) * held * a.c;
    vv = reinterpret_cast<u32*>(p);
    p += 4 * held * a.r;
    char* q = scr ? scr : p;
    kbits = reinterpret_cast<u32*>(q);
    kpre = reinterpret_cast<int*>(kbits + a.d * a.wd);
    cbits = reinterpret_cast<u32*>(kpre + a.d * a.wd);
    cpre = reinterpret_cast<int*>(cbits + a.d * a.wc);
    nla = cpre + a.d * a.wc;
    nca = nla + a.d;
    kt = nca + a.d;
    ct = kt + a.d;
    off = scr ? reinterpret_cast<int*>(p) : ct + a.d;
    coff = off + own + 1;
  }
};

template <int K>
__device__ __forceinline__ void key_sync() {
  if constexpr (K == kCluster) cg::this_cluster().sync();
  else __syncthreads();
}

// nbytes (a multiple of 4) from global memory; 16 bytes a thread where
// both ends are 16-byte aligned
__device__ __forceinline__ void copy_in(void* dst, const void* src,
                                        long long nbytes) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(dst) |
                               reinterpret_cast<unsigned long long>(src) |
                               static_cast<unsigned long long>(nbytes);
  if ((a & 15) == 0) {  // four loads in flight a thread
    uint4* d = static_cast<uint4*>(dst);
    const uint4* s = static_cast<const uint4*>(src);
    const long long n = nbytes / 16;
    for (long long i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
      uint4 t[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u * kThreads < n) t[u] = __ldg(s + i0 + u * kThreads);
      }
      asm volatile("" ::: "memory");  // the loads issue before the stores
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u * kThreads < n) d[i0 + u * kThreads] = t[u];
      }
    }
  } else {
    u32* d = static_cast<u32*>(dst);
    const u32* s = static_cast<const u32*>(src);
    for (long long i = threadIdx.x; i < nbytes / 4; i += kThreads) d[i] = __ldg(s + i);
  }
}

// One warp: the live prefix of each of `nrows` rows of `width` (its
// entries before the first pad) into live[], and their exclusive scan
// into off[0, nrows].
template <typename T>
__device__ void live_scan(const T* rows, int nrows, int width, int* live,
                          int* off) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const T pad = Layout<T>::kPad;
  int carry = 0;
  for (int base = 0; base < nrows; base += 32) {
    const int j = base + lane;
    int n = 0;
    if (j < nrows) {
      const T* p = rows + static_cast<long long>(j) * width;
      n = jt::partition_point(width, [&](int q) { return p[q] != pad; });
      live[j] = n;
    }
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(jt::kFullMask, incl, o);
      if (lane >= o) incl += y;
    }
    if (j < nrows) off[j] = carry + incl - n;
    carry += __shfl_sync(jt::kFullMask, incl, 31);
  }
  if (lane == 0) off[nrows] = carry;
}

// the sum of a[0, n), in every lane of the calling warp
__device__ __forceinline__ int warp_sum(const int* a, int n) {
  int s = 0;
  for (int j = static_cast<int>(threadIdx.x & 31); j < n; j += 32) s += a[j];
  return __reduce_add_sync(jt::kFullMask, s);
}

// the kept entries of a row before p (p <= live, the row's live prefix)
__device__ __forceinline__ int kept_before(const u32* bits, const int* pre,
                                           int p, int live, int total) {
  if (p >= live) return total;
  return pre[p >> 5] + __popc(bits[p >> 5] & ((1u << (p & 31)) - 1));
}

// Key k across a CTA (K = kCta: every delta, j0 = 0, j1 = D) or across a
// cluster (K = kCluster: this CTA probes deltas [j0, j1); rank q of nq).
// Every thread of the CTA (cluster) calls it.
template <typename T, int K>
__device__ void fold_key(const Work<T>& w, const Args<T>& a, long long k,
                         int j0, int j1, int q, int nq) {
  const T pad = Layout<T>::kPad;
  const int tid = static_cast<int>(threadIdx.x);
  const int d = a.d, W = a.w, C = a.c, R = a.r, wd = a.wd, wc = a.wc;
  const int own = j1 - j0;
  const long long kd = k * d;
  const T* dots = K == kCluster ? a.dots + kd * W : w.dots;
  const T* cloud = K == kCluster ? a.cloud + kd * C : w.cloud;
  const u32* vv = K == kCluster ? a.vv + kd * R : w.vv;

  // 1. load the rows (CTA class); clear this CTA's kept bits
  if constexpr (K == kCta) {
    copy_in(w.dots, a.dots + kd * W, sizeof(T) * d * W);
    copy_in(w.cloud, a.cloud + kd * C, sizeof(T) * d * C);
    copy_in(w.vv, a.vv + kd * R, 4ll * d * R);
  }
  for (int i = tid; i < own * wd; i += kThreads) w.kbits[j0 * wd + i] = 0;
  for (int i = tid; i < own * wc; i += kThreads) w.cbits[j0 * wc + i] = 0;
  __syncthreads();

  // 2. live prefixes of this CTA's rows and their scans
  if (tid < 32) {
    live_scan(dots + j0 * W, own, W, w.nla + j0, w.off);
    live_scan(cloud + j0 * C, own, C, w.nca + j0, w.coff);
  }
  key_sync<K>();

  // 3. probes: an entry is kept iff no delta covers it without holding
  // it and no later delta holds it; a cloud entry iff no earlier row
  // holds it
  const int nl = w.off[own];
  for (int t = tid; t < nl; t += kThreads) {
    const int jl = jt::partition_point(own + 1, [&](int p) { return w.off[p] <= t; }) - 1;
    const int s = t - w.off[jl];
    const int i = j0 + jl;
    const T x = dots[i * W + s];
    const int col = col_of(x, a.shift, R);
    const u32 sq = seq_of(x, a.shift);
    bool keep = true;
    for (int j = 0; j < d && keep; ++j) {
      if (j == i) continue;
      if (jt::member(dots + j * W, w.nla[j], x)) {
        keep = j < i;
      } else {
        keep = sq > vv[j * R + col] && !jt::member(cloud + j * C, w.nca[j], x);
      }
    }
    if (keep) atomicOr(&w.kbits[i * wd + (s >> 5)], 1u << (s & 31));
  }
  const int ncl = w.coff[own];
  for (int t = tid; t < ncl; t += kThreads) {
    const int jl = jt::partition_point(own + 1, [&](int p) { return w.coff[p] <= t; }) - 1;
    const int u = t - w.coff[jl];
    const int i = j0 + jl;
    const T y = cloud[i * C + u];
    bool first = true;
    for (int j = 0; j < i && first; ++j) first = !jt::member(cloud + j * C, w.nca[j], y);
    if (first) atomicOr(&w.cbits[i * wc + (u >> 5)], 1u << (u & 31));
  }
  __syncthreads();

  // 4. prefix counts of this CTA's rows' kept bits
  for (int i = j0 + tid; i < j1; i += kThreads) {
    int acc = 0;
    for (int p = 0; p < wd; ++p) {
      w.kpre[i * wd + p] = acc;
      acc += __popc(w.kbits[i * wd + p]);
    }
    w.kt[i] = acc;
    acc = 0;
    for (int p = 0; p < wc; ++p) {
      w.cpre[i * wc + p] = acc;
      acc += __popc(w.cbits[i * wc + p]);
    }
    w.ct[i] = acc;
  }
  key_sync<K>();

  // 5. placement: a kept entry's slot is the kept entries below it
  T* od = a.o_dots + kd * W;
  int* op = a.o_pay + kd * W;
  T* oc = a.o_cloud + kd * C;
  for (int t = tid; t < nl; t += kThreads) {
    const int jl = jt::partition_point(own + 1, [&](int p) { return w.off[p] <= t; }) - 1;
    const int s = t - w.off[jl];
    const int i = j0 + jl;
    if (!(w.kbits[i * wd + (s >> 5)] >> (s & 31) & 1u)) continue;
    const T x = dots[i * W + s];
    int slot = 0;
    for (int j = 0; j < d; ++j) {
      const int kj = w.kt[j];
      if (kj == 0) continue;
      const int lj = w.nla[j];
      const int p = j == i ? s : jt::lower_bound(dots + j * W, lj, x);
      slot += kept_before(w.kbits + j * wd, w.kpre + j * wd, p, lj, kj);
    }
    od[slot] = x;
    op[slot] = a.pay[(kd + i) * W + s];
  }
  for (int t = tid; t < ncl; t += kThreads) {
    const int jl = jt::partition_point(own + 1, [&](int p) { return w.coff[p] <= t; }) - 1;
    const int u = t - w.coff[jl];
    const int i = j0 + jl;
    if (!(w.cbits[i * wc + (u >> 5)] >> (u & 31) & 1u)) continue;
    const T y = cloud[i * C + u];
    int slot = 0;
    for (int j = 0; j < d; ++j) {
      const int kj = w.ct[j];
      if (kj == 0) continue;
      const int lj = w.nca[j];
      const int p = j == i ? u : jt::lower_bound(cloud + j * C, lj, y);
      slot += kept_before(w.cbits + j * wc, w.cpre + j * wc, p, lj, kj);
    }
    oc[slot] = y;
  }
  const int kept = warp_sum(w.kt, d), ckept = warp_sum(w.ct, d);
  const int orank = q * kThreads + tid, osize = nq * kThreads;
  for (long long p = kept + orank; p < static_cast<long long>(d) * W; p += osize) {
    od[p] = pad;
    op[p] = -1;
  }
  for (long long p = ckept + orank; p < static_cast<long long>(d) * C; p += osize) {
    oc[p] = pad;
  }
  for (int c = orank; c < R; c += osize) {
    u32 m = 0;
    for (int j = 0; j < d; ++j) m = max(m, vv[j * R + c]);
    a.o_vv[k * R + c] = m;
  }
}

// A CTA per key (grid-stride), its rows in shared memory. Held to 40
// registers, six CTAs an SM, at a few bytes of spill: the probes are
// chains of dependent loads, so residency pays (uncapped, 4,096 keys of
// 12 dots a delta took 1.63 ms narrow; capped, 0.73: PERF.md §6).
template <typename T>
__global__ void __launch_bounds__(kThreads, 6)
    ujson_fold_flat_cta(Args<T> a, long long nkeys) {
  extern __shared__ __align__(16) char smem[];
  const Work<T> w(smem, nullptr, a.d, a);
  for (long long k = blockIdx.x; k < nkeys; k += gridDim.x) {
    __syncthreads();  // the previous key is done with the work buffer
    fold_key<T, kCta>(w, a, k, 0, a.d, 0, 1);
  }
}

// A cluster of CTAs per key (grid-stride over the clusters): CTA q probes
// deltas [q * rpr, (q + 1) * rpr), its flags at cluster * stride bytes
// of device scratch.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ujson_fold_flat_cluster(Args<T> a, char* scratch, long long stride,
                            long long nkeys) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int nq = static_cast<int>(cluster.num_blocks());
  const long long id = blockIdx.x / nq, nclusters = gridDim.x / nq;
  const int j0 = min(a.d, q * a.rpr), j1 = min(a.d, j0 + a.rpr);
  const Work<T> w(smem, scratch + id * stride, a.rpr, a);
  for (long long k = id; k < nkeys; k += nclusters) {
    cluster.sync();  // every CTA is done with the previous key's flags
    fold_key<T, kCluster>(w, a, k, j0, j1, q, nq);
  }
}

template <typename F>
cudaError_t allow_smem(F* fn, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_cluster(const Args<T>& a, void* scratch, long long stride,
                   long long nkeys, long long grid, long long csize,
                   long long smem, cudaStream_t stream) {
  auto fn = ujson_fold_flat_cluster<T>;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
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
  e = cudaLaunchKernelEx(&cfg, fn, a, static_cast<char*>(scratch), stride, nkeys);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* dots, const void* pay, const void* vv,
           const void* cloud, long long d, long long w, long long c,
           long long r, long long shift, void* o_dots, void* o_pay,
           void* o_vv, void* o_cloud, long long kind, long long per_cta,
           long long csize, long long rpr, void* scratch, long long stride,
           long long nkeys, long long grid, long long smem,
           cudaStream_t stream) {
  if (nkeys <= 0) return 0;
  Args<T> a;
  a.dots = static_cast<const T*>(dots);
  a.pay = static_cast<const int*>(pay);
  a.vv = static_cast<const u32*>(vv);
  a.cloud = static_cast<const T*>(cloud);
  a.o_dots = static_cast<T*>(o_dots);
  a.o_pay = static_cast<int*>(o_pay);
  a.o_vv = static_cast<u32*>(o_vv);
  a.o_cloud = static_cast<T*>(o_cloud);
  a.d = static_cast<int>(d);
  a.w = static_cast<int>(w);
  a.c = static_cast<int>(c);
  a.r = static_cast<int>(r);
  a.shift = static_cast<int>(shift);
  a.wd = (a.w + 31) / 32;
  a.wc = (a.c + 31) / 32;
  a.rpr = static_cast<int>(rpr);
  const unsigned blocks = static_cast<unsigned>(grid);
  const size_t bytes = static_cast<size_t>(smem);
  if (kind == kWarp) {
    if (d > 64 || w > 8 || c > 8) return static_cast<int>(cudaErrorInvalidValue);
    auto fn = w <= 4 && c <= 4 ? ujson_fold_flat_warp<T, 4> : ujson_fold_flat_warp<T, 8>;
    cudaError_t e = allow_smem(fn, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fn<<<blocks, static_cast<unsigned>(32 * per_cta), bytes, stream>>>(
        a, stride, nkeys, static_cast<int>(per_cta));
  } else if (kind == kCta) {
    cudaError_t e = allow_smem(ujson_fold_flat_cta<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ujson_fold_flat_cta<T><<<blocks, kThreads, bytes, stream>>>(a, nkeys);
  } else if (kind == kCluster && csize >= 1 && csize <= kClusterMax) {
    return launch_cluster<T>(a, scratch, stride, nkeys, grid, csize, smem, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wide: 1 for the u64 layout, 0 for the narrow int32 one. dots, pay:
// (K, D, W); vv: (K, D, R); cloud: (K, D, C). Outputs: (K, D*W) dots and
// ids, (K, R) vv, (K, D*C) cloud. kind: 0 a warp per key (D <= 64, W and
// C <= 8; per_cta keys a CTA, each with stride bytes of the CTA's smem
// bytes), 1 a CTA per key (smem bytes), 2 a cluster of csize CTAs per
// key, each probing rpr deltas with smem bytes of shared memory, the
// flags at cluster * stride bytes of scratch; grid: CTAs launched (a
// multiple of csize for kind 2). Returns a CUDA error code:
// cudaErrorInvalidConfiguration when the card cannot hold one cluster,
// else cudaGetLastError() after the launch.
extern "C" int jt_ujson_fold_flat(int wide, const void* dots, const void* pay,
                                  const void* vv, const void* cloud,
                                  long long d, long long w, long long c,
                                  long long r, long long shift, void* o_dots,
                                  void* o_pay, void* o_vv, void* o_cloud,
                                  long long kind, long long per_cta,
                                  long long csize, long long rpr,
                                  void* scratch, long long stride,
                                  long long nkeys, long long grid,
                                  long long smem, void* stream) {
  auto fn = wide ? launch<u64> : launch<int>;
  return fn(dots, pay, vv, cloud, d, w, c, r, shift, o_dots, o_pay, o_vv,
            o_cloud, kind, per_cta, csize, rpr, scratch, stride, nkeys, grid,
            smem, static_cast<cudaStream_t>(stream));
}
