// Block-scope building blocks of the row kernels (ujson_fold_flat.cu, and
// ujson_join.cu's searches; warp_ops.cuh holds the group scans the
// redesigned row kernels use): an exclusive block scan for compactions,
// binary searches over sorted rows, and an ascending bitonic sort of a
// power-of-two buffer. Buffers are generic pointers, so the
// same code runs on shared memory or on per-CTA device scratch.
#pragma once

#include <cuda_runtime.h>

namespace jt {

// exclusive prefix sum of x over a block of NT threads; *total gets the
// block's sum. Every thread must call it (it holds three barriers).
template <int NT>
__device__ int block_scan(int x, int* warp_sums, int* total) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int base = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return base + v - x;
}

// entries of p[0, n) that are < x (p sorted ascending under <)
template <typename T>
__device__ __forceinline__ int lower_bound(const T* p, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// entries of p[0, n) that are <= x
template <typename T>
__device__ __forceinline__ int upper_bound(const T* p, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x < p[mid]) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// is x in the sorted row p[0, n)?
template <typename T>
__device__ __forceinline__ bool member(const T* p, int n, T x) {
  const int i = lower_bound(p, n, x);
  return i < n && p[i] == x;
}

// ascending bitonic sort of n slots (n a power of two) by a strict order
// on slot indices; swap(i, j) exchanges two slots. Every thread of the
// NT-thread block must call it.
template <int NT, typename Less, typename Swap>
__device__ void bitonic(int n, Less less, Swap swap) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += NT) {
        const int p = i ^ j;
        if (p > i && ((i & k) == 0 ? less(p, i) : less(i, p))) swap(i, p);
      }
      __syncthreads();
    }
  }
}

}  // namespace jt
