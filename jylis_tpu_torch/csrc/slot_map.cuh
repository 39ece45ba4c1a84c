// The counter dense drain's slot map, and a C entry's launch on a named
// card.
//
// The slot map is counter_drain_dense.cu's: a keyspace keeps a persistent
// (K,) int32 slot map on its card, -1 at every row between drains
// (jylis_tpu_torch/ops/staging.py SlotMap). A dense drain first scatters
// map[rows[s]] = s for its B staged slots, then walks every row of the
// keyspace, joins the staged delta at map[k] where map[k] >= 0 and resets
// that row's entry to -1, so the map is clean again after the call.
// OnCard is shared with treg_drain.cu.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace jt {

// map[rows[s]] = s for every slot whose row, read unsigned, is below k
__global__ void __launch_bounds__(256)
    scatter_slots(int* __restrict__ map, const int* __restrict__ rows,
                  long long batch, long long k) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       s < batch; s += stride) {
    const unsigned int r = static_cast<unsigned int>(rows[s]);
    if (r < k) map[r] = static_cast<int>(s);
  }
}

inline cudaError_t launch_scatter(int* map, const int* rows, long long batch,
                                  long long k, int sms, cudaStream_t stream) {
  if (batch < 1) return cudaSuccess;
  long long b = (batch + 255) / 256;
  if (b > 8LL * sms) b = 8LL * sms;
  scatter_slots<<<static_cast<int>(b), 256, 0, stream>>>(map, rows, batch, k);
  return cudaGetLastError();
}

// the SMs of each card, asked once (0: not asked yet)
constexpr int kMaxCards = 64;
inline std::atomic<int> g_sms[kMaxCards];

// Makes `device` current for a C entry's launches and puts the caller's
// device back in `done`, so the Python wrapper enters no device context.
// `rc` holds the first error; `sms` the card's SMs.
struct OnCard {
  int prev = -1;
  int device;
  int sms = 0;
  cudaError_t rc;

  explicit OnCard(int dev) : device(dev) {
    rc = cudaGetDevice(&prev);
    if (rc == cudaSuccess && prev != device) rc = cudaSetDevice(device);
    const bool cached = device >= 0 && device < kMaxCards;
    sms = cached ? g_sms[device].load(std::memory_order_relaxed) : 0;
    if (rc == cudaSuccess && sms == 0) {
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
      if (rc == cudaSuccess && cached) {
        g_sms[device].store(sms, std::memory_order_relaxed);
      }
    }
  }

  // the first error of the entry, the device switch back included
  int done(cudaError_t last) {
    if (rc == cudaSuccess) rc = last;
    if (prev >= 0 && prev != device) {
      const cudaError_t back = cudaSetDevice(prev);
      if (rc == cudaSuccess) rc = back;
      prev = device;
    }
    return static_cast<int>(rc);
  }
};

}  // namespace jt
