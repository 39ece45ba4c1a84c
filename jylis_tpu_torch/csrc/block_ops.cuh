// Binary searches over sorted rows, shared by the row kernels
// (ujson_join.cu, ujson_fold_flat.cu; warp_ops.cuh holds the group scans
// and warp searches). Rows are generic pointers, so the same code runs on
// shared memory or on device memory.
#pragma once

#include <cuda_runtime.h>

namespace jt {

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

}  // namespace jt
