// tensor_converge_batch: the TENSOR gathered join at B unique rows.
//
// Replaces jylis_tpu/models/repo_tensor.py `_drain` (:72), the XLA
// program over jylis_tpu/ops/tensor.py `converge_batch` (:121): gather
// the (B, D) cell blocks of the state rows key_idx[b], join each with
// the delta row b by the per-cell select (tensor_cell.cuh, the same
// select as the port of the Pallas kernel, tensor_join_dense.cu), and
// scatter the result back, in place. Rows must be unique (the repo maps
// each (key, contributor) to its own row). A slot whose row is >= N or
// negative (key_idx is compared unsigned) is a pad and writes nothing,
// as JAX's mode="drop" scatter drops it.
//
// Bound: bytes. Per live cell, the state's 4 planes read and written and
// the delta's 4 planes read: 48 bytes, plus 4 bytes of index per slot.
// At B = 131,072 x D = 64 about 403 MB, 0.12 ms at 3.35 TB/s. At most 4
// integer compares, 2 okey maps and 4 selects per cell.
//
// Design: D is a multiple of 4 (the repo's dim_cap is a power of two
// >= 8) and every plane is 16-byte aligned (the wrapper checks both), so
// a row is D / 4 whole uint4 vectors. One thread takes one vector of one
// slot on each of the 8 planes; neighbouring threads take neighbouring
// vectors of a row, so at D = 64 a warp reads two rows' contiguous
// 256-byte runs per plane. The slot's index is loaded by each of its
// D / 4 threads (one cached line). Grid-stride, no shared memory.
#include "tensor_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

__global__ void __launch_bounds__(kThreads)
    tensor_converge_batch(uint4* __restrict__ v, uint4* __restrict__ th,
                          uint4* __restrict__ tl, uint4* __restrict__ r,
                          const int* __restrict__ key_idx,
                          const uint4* __restrict__ dv,
                          const uint4* __restrict__ dth,
                          const uint4* __restrict__ dtl,
                          const uint4* __restrict__ dr, long long batch,
                          long long rows, int vecs) {
  const long long units = batch * vecs;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       u < units; u += stride) {
    const long long slot = u / vecs;
    const long long row = static_cast<unsigned int>(key_idx[slot]);
    if (row >= rows) continue;  // pad slot
    const long long s = row * vecs + (u - slot * vecs);
    uint4 a0 = v[s], a1 = th[s], a2 = tl[s], a3 = r[s];
    jt::join_vec(a0, a1, a2, a3, dv[u], dth[u], dtl[u], dr[u]);
    v[s] = a0;
    th[s] = a1;
    tl[s] = a2;
    r[s] = a3;
  }
}

}  // namespace

// State planes (rows, dim) and delta planes (batch, dim), int32 bit
// patterns; dim % 4 == 0 and every plane 16-byte aligned (the wrapper,
// jylis_tpu_torch/ops/tensor.py, checks). Returns cudaGetLastError()
// after the launch.
extern "C" int jt_tensor_converge_batch(void* v, void* th, void* tl, void* r,
                                        const void* key_idx, const void* dv,
                                        const void* dth, const void* dtl,
                                        const void* dr, long long batch,
                                        long long rows, int dim,
                                        void* stream) {
  if (dim % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vecs = dim / 4;
  long long blocks = (batch * vecs + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  auto u = [](void* p) { return static_cast<uint4*>(p); };
  auto c = [](const void* p) { return static_cast<const uint4*>(p); };
  tensor_converge_batch<<<static_cast<int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      u(v), u(th), u(tl), u(r), static_cast<const int*>(key_idx), c(dv),
      c(dth), c(dtl), c(dr), batch, rows, vecs);
  return static_cast<int>(cudaGetLastError());
}
