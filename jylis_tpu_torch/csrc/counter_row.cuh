// One warp joins one row of u64 counters with its delta row and sums it.
//
// Shared by counter_drain_dense.cu and counter_drain_sparse.cu. The port
// stores each u64 counter as the bit pattern of an int64 tensor element
// (jylis_tpu_torch/ops/planes.py); here it is read back as
// unsigned long long, so max and sum are the unsigned, wrapping ones the
// lattice defines.
#pragma once

#include <cuda_runtime.h>

namespace jt {

using u64 = unsigned long long;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
// grid-stride loops cover the rest; 65536 blocks of 256 threads is many
// waves on 132 SMs, so the cap never starves the card
constexpr long long kMaxBlocks = 1 << 16;

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }

// s[j] = max(s[j], d[j]) over one row of `cols` counters, in place, and
// this lane's wrapping share of the joined row's sum. Each lane takes
// one 16-byte vector (two counters) at a time and lanes take neighbouring
// vectors, so each warp-wide access is one contiguous run. The wrappers
// (ops/planes.py) launch only with `cols` even and every plane 16-byte
// aligned, which makes every row 16-byte aligned too.
__device__ __forceinline__ u64 join_row(u64* __restrict__ s,
                                        const u64* __restrict__ d,
                                        int cols, int lane) {
  ulonglong2* sv = reinterpret_cast<ulonglong2*>(s);
  const ulonglong2* dv = reinterpret_cast<const ulonglong2*>(d);
  u64 acc = 0;
  for (int j = lane; j < (cols >> 1); j += 32) {
    ulonglong2 a = sv[j];
    const ulonglong2 b = dv[j];
    a.x = umax(a.x, b.x);
    a.y = umax(a.y, b.y);
    sv[j] = a;
    acc += a.x + a.y;
  }
  return acc;
}

// wrapping sum over the warp's 32 lanes, the result in every lane
__device__ __forceinline__ u64 warp_sum(u64 v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

inline int blocks_for_warps(long long warps) {
  long long b = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace jt
