// tensor_join_dense: the TENSOR full-keyspace per-coordinate join.
//
// Replaces the Pallas kernel bench.py `_pallas_tensor_join` (body
// `_kernel`, :1749; pallas_call :1773), which runs
// jylis_tpu/ops/tensor.py `_join_row` (:99) over (N*D/128, 128) blocks
// with the state aliased in place; the XLA form is tensor.join_dense
// (:114). Four u32 planes per side: val (f32 bits), ts_hi, ts_lo, rid.
// Cell by cell, B replaces A iff (ts_hi, ts_lo, rid, okey(val)) of B is
// lexicographically strictly greater, compared as unsigned integers;
// okey(u) = (u >> 31) ? ~u : u | 0x80000000 is the order-preserving map
// of f32 bits, so no NaN is ever compared as a float (the select is
// tensor_cell.cuh's, shared with tensor_converge_batch.cu). The state
// planes are updated in place, as the Pallas kernel aliases them.
//
// Bound: bytes. Each cell reads 8 planes and writes 4, 48 bytes; at
// most 4 integer compares, 2 okey maps and 4 selects. At N = 1M, D = 64: ~3.07 GB, 0.92 ms at
// 3.35 TB/s.
//
// Design: not the Pallas (400, 128) block grid. The planes are flat, so
// each thread takes four neighbouring cells as one 16-byte uint4 per
// plane (a warp-wide access is a contiguous 512-byte run), grid-stride;
// cells past the last whole uint4 go through a scalar tail. No
// pipelining (cp.async / TMA) yet.
#include "tensor_cell.cuh"

namespace {

using jt::join_cell;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    tensor_join_dense(unsigned* __restrict__ v, unsigned* __restrict__ th,
                      unsigned* __restrict__ tl, unsigned* __restrict__ r,
                      const unsigned* __restrict__ dv,
                      const unsigned* __restrict__ dth,
                      const unsigned* __restrict__ dtl,
                      const unsigned* __restrict__ dr, long long n) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long tail = 0;
  if (VEC) {
    const long long n4 = n >> 2;
    uint4* v4 = reinterpret_cast<uint4*>(v);
    uint4* th4 = reinterpret_cast<uint4*>(th);
    uint4* tl4 = reinterpret_cast<uint4*>(tl);
    uint4* r4 = reinterpret_cast<uint4*>(r);
    const uint4* dv4 = reinterpret_cast<const uint4*>(dv);
    const uint4* dth4 = reinterpret_cast<const uint4*>(dth);
    const uint4* dtl4 = reinterpret_cast<const uint4*>(dtl);
    const uint4* dr4 = reinterpret_cast<const uint4*>(dr);
    for (long long i = tid; i < n4; i += stride) {
      uint4 a0 = v4[i], a1 = th4[i], a2 = tl4[i], a3 = r4[i];
      const uint4 b0 = dv4[i], b1 = dth4[i], b2 = dtl4[i], b3 = dr4[i];
      jt::join_vec(a0, a1, a2, a3, b0, b1, b2, b3);
      v4[i] = a0;
      th4[i] = a1;
      tl4[i] = a2;
      r4[i] = a3;
    }
    tail = n4 << 2;
  }
  for (long long i = tail + tid; i < n; i += stride) {
    unsigned a0 = v[i], a1 = th[i], a2 = tl[i], a3 = r[i];
    join_cell(a0, a1, a2, a3, dv[i], dth[i], dtl[i], dr[i]);
    v[i] = a0;
    th[i] = a1;
    tl[i] = a2;
    r[i] = a3;
  }
}

}  // namespace

// n: cells per plane (N * D). vec: nonzero when all 8 planes are 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int jt_tensor_join_dense(int vec, void* v, void* th, void* tl,
                                    void* r, const void* dv, const void* dth,
                                    const void* dtl, const void* dr,
                                    long long n, void* stream) {
  const long long units = vec ? (n >> 2) + (n & 3) : n;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  auto u = [](void* p) { return static_cast<unsigned*>(p); };
  auto c = [](const void* p) { return static_cast<const unsigned*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    tensor_join_dense<true><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        u(v), u(th), u(tl), u(r), c(dv), c(dth), c(dtl), c(dr), n);
  } else {
    tensor_join_dense<false><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        u(v), u(th), u(tl), u(r), c(dv), c(dth), c(dtl), c(dr), n);
  }
  return static_cast<int>(cudaGetLastError());
}
