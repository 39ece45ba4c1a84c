// Group-scope building blocks of the row kernels (tlog_drain.cu,
// ujson_join.cu): the group that owns one row, with its step barrier and
// its ballot scans, a warp's bitonic sort held in registers, and the
// cluster class's exchange of per-CTA counts.
//
// A row kernel is written once for a group G and instantiated twice:
//   WarpGroup      a warp per row, several rows per CTA, __syncwarp
//                  between steps and no __syncthreads anywhere;
//   CtaGroup<NT>   a CTA per row (rows too wide for a warp's slice of
//                  shared memory): each warp ballots, and one barrier
//                  combines the warps' counts.
// Both expose kSize (threads in the group), rank (this thread's index),
// sync() (every thread of the group waits, and sees the others' shared
// and global writes), count(f), scan(f, &total) and min(v) (CtaGroup also
// exscan(v, &total), a prefix sum of ints). Every thread
// of the group must make the same calls in the same order.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace jt {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kClusterMax = 16;  // the non-portable cluster size an H100 allows

// the lanes below this one, as a bit mask
__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

struct WarpGroup {
  static constexpr int kSize = 32;
  int rank;
  __device__ WarpGroup() : rank(static_cast<int>(threadIdx.x & 31)) {}
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ int count(bool f) const {
    return __popc(__ballot_sync(kFullMask, f));
  }
  // the group's least v (v >= 0)
  __device__ __forceinline__ int min(int v) const {
    return static_cast<int>(__reduce_min_sync(kFullMask, static_cast<unsigned>(v)));
  }
  // exclusive prefix count of f in rank order; *total gets the count.
  // The __syncwarp orders every lane's reads before the call ahead of
  // every lane's writes after it (an in-place compaction relies on it).
  __device__ __forceinline__ int scan(bool f, int* total) const {
    const unsigned b = __ballot_sync(kFullMask, f);
    __syncwarp();
    *total = __popc(b);
    return __popc(b & lanemask_lt());
  }
};

template <int NT>
struct CtaGroup {
  static constexpr int kSize = NT;
  static constexpr int kWarps = NT / 32;
  int rank;
  int* sums;   // 2 * kWarps ints of shared memory
  int parity;  // which half of sums the next scan writes
  __device__ explicit CtaGroup(int* s)
      : rank(static_cast<int>(threadIdx.x)), sums(s), parity(0) {}
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ int count(bool f) const {
    return __syncthreads_count(f);
  }
  // one barrier: a warp's count goes to one half of a double-buffered
  // table, so the half a scan reads is rewritten only two scans (two
  // barriers) later, when every thread has read it
  __device__ __forceinline__ int scan(bool f, int* total) {
    const unsigned b = __ballot_sync(kFullMask, f);
    int* s = sums + parity * kWarps;
    parity ^= 1;
    const int warp = rank >> 5;
    if ((rank & 31) == 0) s[warp] = __popc(b);
    __syncthreads();
    int base = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = s[w];
      base += w < warp ? v : 0;
      tot += v;
    }
    *total = tot;
    return base + __popc(b & lanemask_lt());
  }
  // exclusive prefix sum of v in rank order, on the same table and one
  // barrier; *total gets the sum
  __device__ __forceinline__ int exscan(int v, int* total) {
    const int lane = rank & 31, warp = rank >> 5;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += y;
    }
    int* s = sums + parity * kWarps;
    parity ^= 1;
    if (lane == 31) s[warp] = incl;
    __syncthreads();
    int base = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = s[w];
      base += w < warp ? x : 0;
      tot += x;
    }
    *total = tot;
    return base + incl - v;
  }
  // the group's least v (v >= 0), on the same table and one barrier;
  // it also orders every thread's writes before it ahead of every read
  // after it, as sync() does
  __device__ __forceinline__ int min(int v) {
    const int m = static_cast<int>(__reduce_min_sync(kFullMask, static_cast<unsigned>(v)));
    int* s = sums + parity * kWarps;
    parity ^= 1;
    if ((rank & 31) == 0) s[rank >> 5] = m;
    __syncthreads();
    int out = s[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) out = s[w] < out ? s[w] : out;
    return out;
  }
};

// first index of p(0..n) where pred fails, pred true on a prefix; one
// thread's binary search, its steps selects rather than branches
template <typename Pred>
__device__ __forceinline__ int partition_point(int n, Pred pred) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool p = pred(mid);
    lo = p ? mid + 1 : lo;
    hi = p ? hi : mid;
  }
  return lo;
}

// first index of [lo, hi) where pred fails (pred true on a prefix; hi
// when it holds throughout), searched by the 32 lanes of a warp at once:
// each round probes 32 cut points and keeps the stretch between the last
// that holds and the first that fails, so n entries take log33(n) rounds
// of one probe a lane where partition_point takes log2(n) dependent
// steps. Every lane of the warp must call it with the same lo, hi and
// pred (a CTA's warps may each call it: they reach the same answer).
template <typename Pred>
__device__ __forceinline__ int warp_partition_point(int lo, int hi, Pred pred) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  while (hi - lo > 32) {
    const int n = hi - lo;
    const int c = __popc(__ballot_sync(kFullMask, pred(lo + (lane + 1) * n / 33)));
    const int nlo = c ? lo + c * n / 33 + 1 : lo;
    if (c < 32) hi = lo + (c + 1) * n / 33;
    lo = nlo;
  }
  return lo + __popc(__ballot_sync(kFullMask, lane < hi - lo && pred(lo + lane)));
}

// Ascending bitonic sort of 32 * E values held E to a lane: value e of
// lane l is element e * 32 + l. less is a strict order; xshfl(x, m)
// returns lane (lane ^ m)'s x. Partners closer than 32 are a shuffle
// away, farther ones sit in the same lane's registers. Every lane of
// the warp must call it; the loops unroll, so d stays in registers.
template <int LogE, typename T, typename Less, typename XShfl>
__device__ __forceinline__ void warp_bitonic(T (&d)[1 << LogE], Less less,
                                             XShfl xshfl) {
  constexpr int E = 1 << LogE;
  constexpr int LogN = LogE + 5;
  const int lane = static_cast<int>(threadIdx.x & 31);
#pragma unroll
  for (int lk = 1; lk <= LogN; ++lk) {
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      if (lj >= 5) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int p = e ^ (1 << (lj - 5));
          if (p > e) {  // known at compile time, as is asc here (lk > 5)
            const bool asc = (((e << 5) | lane) >> lk & 1) == 0;
            const T x = d[e], y = d[p];
            const bool swap = asc ? less(y, x) : less(x, y);
            d[e] = swap ? y : x;
            d[p] = swap ? x : y;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const T o = xshfl(d[e], 1 << lj);
          const bool asc = (((e << 5) | lane) >> lk & 1) == 0;
          const bool lower = (lane >> lj & 1) == 0;
          // the lower slot of an ascending pair keeps the smaller value,
          // of a descending pair the larger: both compares, then a select
          // (no branch: the lanes of a warp take different sides)
          const bool o_below = less(o, d[e]), o_above = less(d[e], o);
          d[e] = (lower == asc ? o_below : o_above) ? o : d[e];
        }
      }
    }
  }
}

// Every CTA of a thread-block cluster publishes v; after the cluster
// barrier tab[r] holds CTA r's (tab: kClusterMax entries of shared
// memory). pub holds two slots of shared memory, written in turn (xc),
// so a slot is rewritten only after the next exchange's barrier, which
// every reader of it has passed. The barrier also orders every thread's
// writes before it ahead of every read after it, across the cluster.
// Every thread of the cluster calls it, in step.
template <typename V>
__device__ __forceinline__ void exchange(cooperative_groups::cluster_group& cluster,
                                         V* pub, int& xc, V v, V* tab) {
  V* slot = pub + xc;
  xc ^= 1;
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  if (threadIdx.x < cluster.num_blocks()) {
    tab[threadIdx.x] = *cluster.map_shared_rank(slot, threadIdx.x);
  }
  __syncthreads();
}

}  // namespace jt
