// ujson_fold_flat: the closed-form n-way fold of each key's UJSON delta
// stack.
//
// Replaces jylis_tpu/ops/ujson_resident.py `_fold_flat_one` (:88), which
// XLA runs under `_fold_grid` (:136) for stacks of D <= 64 deltas in
// `fold_join_subset` (:218) and `fold_broadcast_rows` (:256).
//
// Input: a (K, D, W) grid of DocBatch rows (jylis_tpu_torch/ops/
// ujson_device.py): per key, D delta rows of W sorted, pad-filled dots
// (T = int narrow, pad 0x7FFFFFFF; T = unsigned long long wide, pad all
// ones) with int32 payload ids, a (D, R) u32 version vector and (D, C)
// sorted clouds. Per key, over its E = D * W entries in flat (delta, slot)
// order: an entry survives iff it is valid and every delta either
// contains it (binary search in that delta's dots) or does not cover it
// (seq <= vv[min(col, R-1)] or a binary search in that delta's cloud).
// The survivors are sorted ascending, and of equal dots the LAST in flat
// order keeps its payload id (JAX's stable argsort, then dropping each
// entry equal to its right neighbour; ujson_resident.py:119-127); pads
// and -1 ids fill the rest of the E slots. vv = the max over the D rows;
// cloud = the D * C entries sorted and deduplicated, pads after.
//
// Design: one CTA of 256 threads per key (grid-stride). The work buffer
// (the key's dots, clouds and vv, and an (entry, index) sort buffer of
// the next power of two of E) lives in shared memory when it fits, else
// in device scratch per CTA. Steps: load; one thread per entry probes
// the D deltas; a bitonic sort of (dot, flat index) pairs, which makes
// the order stable; a block-scan compaction keeps the last of each run
// and writes it with the payload id of its index; the vv max; a bitonic
// sort of the clouds in place (the probes are done) and a compaction that
// keeps the first of each run.
//
// Bound: bytes (each input read once: E dots and ids, D * C cloud
// entries, D * R vv; each output written once: E dots and ids, D * C
// cloud entries, R vv); operations, per key: E * D * (log2 W + log2 C +
// 3) probes and compares, Ep/2 * s(s+1)/2 compare-exchanges for the
// entry sort (Ep = 2^s >= E) and the same for the cloud sort, and D * R
// for the vv max.
#include <cuda_runtime.h>

#include "block_ops.cuh"

namespace {

using u32 = unsigned int;
using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ujson_fold_flat(const T* dots, const int* pay, const u32* vv,
                    const T* cloud, int d, int wd, int c, int r, int shift,
                    int ep, int cp, T* o_dots, int* o_pay, u32* o_vv,
                    T* o_cloud, char* scratch, long long stride,
                    long long nkeys) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int warp_sums[kWarps];
  const T pad = Layout<T>::kPad;
  const int tid = threadIdx.x;
  const int e = d * wd, ec = d * c;
  char* base = scratch ? scratch + blockIdx.x * stride : smem;
  T* sd = reinterpret_cast<T*>(base);  // [e] the key's dots
  T* sc = sd + e;                      // [cp] its clouds, then sorted
  T* sk = sc + cp;                     // [ep] sort keys
  int* si = reinterpret_cast<int*>(sk + ep);  // [ep] flat indices
  u32* sv = reinterpret_cast<u32*>(si + ep);  // [d * r] vv rows
  const u64 mask = (1ull << shift) - 1;

  for (long long k = blockIdx.x; k < nkeys; k += gridDim.x) {
    __syncthreads();  // the previous key is done with the work buffer
    for (int i = tid; i < e; i += kThreads) sd[i] = dots[k * e + i];
    for (int i = tid; i < cp; i += kThreads) {
      sc[i] = i < ec ? cloud[k * ec + i] : pad;
    }
    for (int i = tid; i < d * r; i += kThreads) sv[i] = vv[k * d * r + i];
    __syncthreads();

    // probes: does every delta contain the entry or not cover it?
    for (int i = tid; i < ep; i += kThreads) {
      T key = pad;
      if (i < e && sd[i] != pad) {
        const T x = sd[i];
        const u64 bx = Layout<T>::bits(x);
        const u64 cl = bx >> shift;
        const int col = cl < static_cast<u64>(r - 1) ? static_cast<int>(cl) : r - 1;
        const u32 sq = static_cast<u32>(bx & mask);
        bool ok = true;
        for (int j = 0; j < d && ok; ++j) {
          const bool cover =
              sq <= sv[j * r + col] || jt::member(sc + j * c, c, x);
          ok = !cover || jt::member(sd + j * wd, wd, x);
        }
        if (ok) key = x;
      }
      sk[i] = key;
      si[i] = i;
    }
    for (int i = tid; i < r; i += kThreads) {
      u32 m = 0;
      for (int j = 0; j < d; ++j) m = sv[j * r + i] > m ? sv[j * r + i] : m;
      o_vv[k * r + i] = m;
    }
    __syncthreads();

    // stable order: sort (dot, flat index) pairs
    jt::bitonic<kThreads>(
        ep,
        [&](int a, int b) {
          return sk[a] < sk[b] || (sk[a] == sk[b] && si[a] < si[b]);
        },
        [&](int a, int b) {
          const T t = sk[a];
          sk[a] = sk[b];
          sk[b] = t;
          const int u = si[a];
          si[a] = si[b];
          si[b] = u;
        });
    // keep the last of each run of equal dots, with its payload id
    int n = 0;
    for (int p0 = 0; p0 < ep; p0 += kThreads) {
      const int p = p0 + tid;
      bool keep = false;
      if (p < ep) {
        keep = sk[p] != pad && (p == ep - 1 || sk[p + 1] != sk[p]);
      }
      int tot;
      const int pos = jt::block_scan<kThreads>(keep ? 1 : 0, warp_sums, &tot);
      if (keep) {
        o_dots[k * e + n + pos] = sk[p];
        o_pay[k * e + n + pos] = pay[k * e + si[p]];
      }
      n += tot;
    }
    for (int p = n + tid; p < e; p += kThreads) {
      o_dots[k * e + p] = pad;
      o_pay[k * e + p] = -1;
    }

    // the clouds: sort in place, keep the first of each run
    jt::bitonic<kThreads>(
        cp, [&](int a, int b) { return sc[a] < sc[b]; },
        [&](int a, int b) {
          const T t = sc[a];
          sc[a] = sc[b];
          sc[b] = t;
        });
    int nc = 0;
    for (int p0 = 0; p0 < cp; p0 += kThreads) {
      const int p = p0 + tid;
      bool keep = false;
      if (p < cp) keep = sc[p] != pad && (p == 0 || sc[p - 1] != sc[p]);
      int tot;
      const int pos = jt::block_scan<kThreads>(keep ? 1 : 0, warp_sums, &tot);
      if (keep) o_cloud[k * ec + nc + pos] = sc[p];
      nc += tot;
    }
    for (int p = nc + tid; p < ec; p += kThreads) o_cloud[k * ec + p] = pad;
  }
}

template <typename T>
int launch(const void* dots, const void* pay, const void* vv,
           const void* cloud, long long d, long long wd, long long c,
           long long r, long long shift, long long ep, long long cp,
           void* o_dots, void* o_pay, void* o_vv, void* o_cloud,
           void* scratch, long long stride, long long nkeys, long long grid,
           long long smem, cudaStream_t stream) {
  if (nkeys <= 0) return 0;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(ujson_fold_flat<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  ujson_fold_flat<T><<<static_cast<unsigned>(grid), kThreads,
                       static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(dots), static_cast<const int*>(pay),
      static_cast<const u32*>(vv), static_cast<const T*>(cloud),
      static_cast<int>(d), static_cast<int>(wd), static_cast<int>(c),
      static_cast<int>(r), static_cast<int>(shift), static_cast<int>(ep),
      static_cast<int>(cp), static_cast<T*>(o_dots),
      static_cast<int*>(o_pay), static_cast<u32*>(o_vv),
      static_cast<T*>(o_cloud), static_cast<char*>(scratch), stride, nkeys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wide: 1 for the u64 layout, 0 for the narrow int32 one. dots, pay:
// (K, D, W); vv: (K, D, R); cloud: (K, D, C). Outputs: (K, D*W) dots and
// ids, (K, R) vv, (K, D*C) cloud. ep, cp: D*W and D*C rounded up to powers
// of two. scratch: null to keep each CTA's work buffer (smem bytes) in
// shared memory, else grid * stride bytes of device memory. Returns
// cudaGetLastError() after the launch.
extern "C" int jt_ujson_fold_flat(int wide, const void* dots, const void* pay,
                                  const void* vv, const void* cloud,
                                  long long d, long long wd, long long c,
                                  long long r, long long shift, long long ep,
                                  long long cp, void* o_dots, void* o_pay,
                                  void* o_vv, void* o_cloud, void* scratch,
                                  long long stride, long long nkeys,
                                  long long grid, long long smem,
                                  void* stream) {
  auto fn = wide ? launch<u64> : launch<int>;
  return fn(dots, pay, vv, cloud, d, wd, c, r, shift, ep, cp, o_dots, o_pay,
            o_vv, o_cloud, scratch, stride, nkeys, grid, smem,
            static_cast<cudaStream_t>(stream));
}
