// replica_join: the lattice join of S stacked full states, per column.
//
// Replaces jylis_tpu/parallel/sharded.py `join_replica_axis` (:396-442):
// `_tree_join`, a log-depth fold of a device's own replica rows by the
// u64 max over hi/lo u32 planes, then `_local_then_pmax`, a two-phase
// u32 pmax over the mesh's rep axis (hi first, lo masked to the hi
// winners), broadcast to every row. The port keeps each u64 as the bit
// pattern of an int64 element, so the whole fold is ONE unsigned 64-bit
// max per column: out[c] = max over s of in[s][c] (as unsigned). That is
// the value the JAX fold gives, bit for bit: an order-independent max,
// odd S included (the JAX tree carries the odd leftover along; here no
// row is special). The kernel writes the one joined row; the caller
// gives JAX's (S, K) broadcast as a zero-copy expand of it.
//
// Bound: bytes. Every input element is read once (S * K * 8 bytes) and
// every output element written once (K * 8); one compare per input
// element is far below the integer rate. At S = 64 replicas x
// K = 1,048,576 keys that is 512 MB in and 8 MB out.
//
// Design: one pass. Each thread owns a column; a warp's 32 threads read
// 32 neighbouring columns of one row, so every load is coalesced. The
// row loop issues eight independent loads before it compares, which
// keeps enough loads in flight per thread to cover the memory latency.
// The max starts at 0, the identity of the unsigned max.
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
    replica_join(const u64* __restrict__ in, u64* __restrict__ out,
                 long long s, long long k) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       c < k; c += stride) {
    const u64* p = in + c;
    u64 m = 0;
    long long r = 0;
    for (; r + kUnroll <= s; r += kUnroll) {
      u64 v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) v[j] = __ldg(p + (r + j) * k);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) m = v[j] > m ? v[j] : m;
    }
    for (; r < s; ++r) {
      const u64 v = __ldg(p + r * k);
      m = v > m ? v : m;
    }
    out[c] = m;
  }
}

}  // namespace

// in: (s, k) contiguous and out: (k,), not overlapping; s >= 1 and
// k >= 1 (the wrapper checks). Returns cudaGetLastError() after the
// launch.
extern "C" int jt_replica_join(const void* in, void* out, long long s,
                               long long k, void* stream) {
  long long blocks = (k + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  replica_join<<<static_cast<unsigned int>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(in), static_cast<u64*>(out), s, k);
  return static_cast<int>(cudaGetLastError());
}
