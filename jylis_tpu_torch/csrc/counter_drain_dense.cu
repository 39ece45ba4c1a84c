// counter_drain_dense<NP>: the whole-keyspace counter drain.
//
// Replaces jylis_tpu/models/repo_counters.py `_drain_g_dense` (NP = 1,
// GCOUNT) and `_drain_pn_dense` (NP = 2, PNCOUNT, :69-79): XLA's
// planes.join_max over the (K, R) u64 planes followed by read_all's row
// sums. Per polarity p: state_p = max(state_p, delta_p), elementwise and
// unsigned, written in place; then sums[k] = sum_r state_0[k, r]
// (- sum_r state_1[k, r] for PNCOUNT), wrapping mod 2^64.
//
// Bound: bytes. Each polarity reads the state and the delta once and
// writes the state once (3 * K * R * 8 bytes), plus K * 8 bytes of sums;
// there are two integer operations per element. At K = 1M, R = 64,
// PNCOUNT that is about 3.08 GB, 0.92 ms at 3.35 TB/s.
//
// Design for that bound: one warp per row, so the join and the row sum
// happen in one pass and the joined row is never read back; lanes load
// neighbouring 16-byte vectors, so each warp-wide access is a contiguous
// 512-byte run; the sum is a warp shuffle, with no shared memory and no
// second pass. A row of R counters is R / 2 vectors, so below R = 64
// only R / 2 lanes of each warp load (8 of 32 at R = 16). No pipelining
// (cp.async / TMA) yet.
#include "counter_row.cuh"

namespace {

using jt::u64;

template <int NP>
__global__ void __launch_bounds__(jt::kThreads)
    counter_drain_dense(u64* __restrict__ s0, u64* __restrict__ s1,
                        const u64* __restrict__ d0,
                        const u64* __restrict__ d1, u64* __restrict__ sums,
                        long long rows, int cols) {
  const int lane = threadIdx.x & 31;
  const long long nwarps =
      static_cast<long long>(gridDim.x) * jt::kWarpsPerBlock;
  for (long long row =
           static_cast<long long>(blockIdx.x) * jt::kWarpsPerBlock +
           (threadIdx.x >> 5);
       row < rows; row += nwarps) {
    const long long off = row * cols;
    u64 v = jt::join_row(s0 + off, d0 + off, cols, lane);
    if (NP == 2) v -= jt::join_row(s1 + off, d1 + off, cols, lane);
    v = jt::warp_sum(v);
    if (lane == 0) sums[row] = v;
  }
}

template <int NP>
void launch(void* s0, void* s1, const void* d0, const void* d1, void* sums,
            long long rows, int cols, cudaStream_t stream) {
  counter_drain_dense<NP>
      <<<jt::blocks_for_warps(rows), jt::kThreads, 0, stream>>>(
          static_cast<u64*>(s0), static_cast<u64*>(s1),
          static_cast<const u64*>(d0), static_cast<const u64*>(d1),
          static_cast<u64*>(sums), rows, cols);
}

}  // namespace

// np: 1 (GCOUNT) or 2 (PNCOUNT; s1/d1 are the N planes, unused for 1).
// cols must be even and every plane 16-byte aligned (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int jt_counter_drain_dense(int np, void* s0, void* s1,
                                      const void* d0, const void* d1,
                                      void* sums, long long rows, int cols,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (np == 1) {
    launch<1>(s0, s1, d0, d1, sums, rows, cols, st);
  } else if (np == 2) {
    launch<2>(s0, s1, d0, d1, sums, rows, cols, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
