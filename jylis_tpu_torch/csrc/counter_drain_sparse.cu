// counter_drain_sparse<NP>: the batched counter drain at B unique rows.
//
// Replaces jylis_tpu/models/repo_counters.py `_drain_g` (NP = 1, GCOUNT)
// and `_drain_pn` (NP = 2, PNCOUNT, :54-63): XLA's planes.scatter_join
// (gather the batch rows, unsigned max with the (B, R) delta rows,
// scatter back) followed by planes.rowsum64 of the joined rows. For each
// batch slot b with row = key_idx[b] < K: state_p[row] =
// max(state_p[row], delta_p[b]) in place, and sums[b] = the joined row's
// wrapping sum (PNCOUNT: sum(P) - sum(N)).
//
// Pad slots: the repos pad a batch with distinct rows >= K
// (utils/batching.pad_rows). Here a pad slot writes no state and writes
// 0 into sums[b]. JAX clamps an out-of-range gather, so its pad-slot
// sums are row K-1's sum instead; the repos read live slots only
// (sums[i] for i < len(rows)), so the two agree wherever they are read.
// key_idx is compared unsigned against K, so a negative index is a pad
// slot too.
//
// Bound: bytes. Per live slot and polarity, one state row read and
// written and one delta row read (3 * R * 8 bytes), plus the index and
// the sum per slot. At B = 1024, R = 64 the whole batch is ~3 MB, so
// launch latency, not bandwidth, sets the time at the serving shapes.
//
// Design: one warp per batch slot does gather, max, store and the warp
// sum in one pass; the index load is one broadcast per warp, and a pad
// slot costs the warp one load and one store.
#include "counter_row.cuh"

namespace {

using jt::u64;

template <int NP>
__global__ void __launch_bounds__(jt::kThreads)
    counter_drain_sparse(u64* __restrict__ s0, u64* __restrict__ s1,
                         const u64* __restrict__ d0,
                         const u64* __restrict__ d1,
                         const int* __restrict__ key_idx,
                         u64* __restrict__ sums, long long batch,
                         long long rows, int cols) {
  const int lane = threadIdx.x & 31;
  const long long nwarps =
      static_cast<long long>(gridDim.x) * jt::kWarpsPerBlock;
  for (long long b = static_cast<long long>(blockIdx.x) * jt::kWarpsPerBlock +
                     (threadIdx.x >> 5);
       b < batch; b += nwarps) {
    const long long row = static_cast<unsigned int>(key_idx[b]);
    if (row >= rows) {  // pad slot: warp-uniform branch
      if (lane == 0) sums[b] = 0;
      continue;
    }
    const long long so = row * cols;
    const long long dof = b * cols;
    u64 v = jt::join_row(s0 + so, d0 + dof, cols, lane);
    if (NP == 2) v -= jt::join_row(s1 + so, d1 + dof, cols, lane);
    v = jt::warp_sum(v);
    if (lane == 0) sums[b] = v;
  }
}

template <int NP>
void launch(void* s0, void* s1, const void* d0, const void* d1,
            const void* key_idx, void* sums, long long batch, long long rows,
            int cols, cudaStream_t stream) {
  counter_drain_sparse<NP>
      <<<jt::blocks_for_warps(batch), jt::kThreads, 0, stream>>>(
          static_cast<u64*>(s0), static_cast<u64*>(s1),
          static_cast<const u64*>(d0), static_cast<const u64*>(d1),
          static_cast<const int*>(key_idx), static_cast<u64*>(sums), batch,
          rows, cols);
}

}  // namespace

// np: 1 (GCOUNT) or 2 (PNCOUNT; s1/d1 are the N planes, unused for 1).
// cols must be even and every plane 16-byte aligned (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int jt_counter_drain_sparse(int np, void* s0, void* s1,
                                       const void* d0, const void* d1,
                                       const void* key_idx, void* sums,
                                       long long batch, long long rows,
                                       int cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (np == 1) {
    launch<1>(s0, s1, d0, d1, key_idx, sums, batch, rows, cols, st);
  } else if (np == 2) {
    launch<2>(s0, s1, d0, d1, key_idx, sums, batch, rows, cols, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
