// counter_drain_dense<NP>: the whole-keyspace counter drain of a staged
// batch, through the keyspace's slot map.
//
// Replaces jylis_tpu/models/repo_counters.py `_drain_g_dense` (NP = 1,
// GCOUNT) and `_drain_pn_dense` (NP = 2, PNCOUNT, :69-79): XLA's
// planes.join_max over the (K, R) u64 planes followed by read_all's row
// sums. The JAX package takes a delta plane as large as the state, zeros
// at every row without a delta; here the batch is compact, as the sparse
// drain's: B slots, rows[s] (B int32, UNIQUE rows in [0, K)) and the delta
// rows d_p[s] (B x R u64 per polarity), staged in one buffer and copied
// to the card in one transfer (ops/staging.py). After the call, per
// polarity, state_p[rows[s]] = max(state_p[rows[s]], d_p[s]), elementwise
// and unsigned, in place; sums[k] = sum_r state_0[k, r] (- sum_r
// state_1[k, r] for PNCOUNT), wrapping mod 2^64, for EVERY row k; and
// out[s] = sums[rows[s]].
//
// The slot map: a persistent (K,) int32 plane the keyspace owns, -1 at
// every row between calls. Two launches on one stream: scatter_slots
// writes map[rows[s]] = s, then the walk reads every row k in row order,
// joins the delta row at slot map[k] into it where map[k] >= 0 (a row
// without a delta is read and never written), writes sums[k] and, at a
// slot, out[slot], and resets map[k] = -1. So the map is clean after
// every call and no memset runs per drain. A duplicate row leaves one of
// its slots unjoined and its out unwritten: the caller's fault, as for
// the sparse drain. A row off [0, K) is skipped by the scatter.
//
// Bound: bytes. The state read once (K * R * 8 * NP), the map read
// (4 * K), the full sums written (8 * K), and per slot the row index, the
// delta row read and the state row written (4 + 2 * R * 8 * NP) and the
// out sum (8). At the node's K = 131,072, R = 16 and B = K / 4 that is
// 27.1 MB for NP = 1; the earlier whole-plane drain read a delta plane
// as large as the state and wrote the whole state back (3 * K * R * 8 *
// NP + 8 * K: 51.4 MB).
//
// Design: a row of R counters is R / 2 16-byte vectors, so a row gets G
// lanes, G the power of two >= R / 2 up to 32: at R = 16 one warp walks
// 4 rows at a time, at R = 64 one. Each group takes two rows per step
// (its row of the warp's first RPW rows and of the next RPW), so every
// lane has at least two independent 16-byte loads in flight (four for
// PNCOUNT), and each warp-wide access is one contiguous run. The group's
// sum is a shuffle within the group; all 32 lanes run the same number of
// steps, so the shuffles are full-warp. A grid of resident blocks strides
// over the rows. No shared memory, no cp.async or TMA.
#include "counter_row.cuh"
#include "slot_map.cuh"

namespace {

using jt::u64;

// the layout ops/planes.py's _CounterDensePlan mirrors with ctypes
struct CounterDensePlan {
  u64* s0;  // P plane (GCOUNT: the only plane), (K, R)
  u64* s1;  // N plane (PNCOUNT; unused for NP = 1)
  int* map;  // (K,) slot map, -1 = no delta
  u64* sums;  // (K,) every row's sum
  long long rows;  // K
  int cols;  // R, even
  int device;  // the card the planes live on
};

__device__ __forceinline__ ulonglong2 umax2(ulonglong2 a, ulonglong2 b) {
  a.x = jt::umax(a.x, b.x);
  a.y = jt::umax(a.y, b.y);
  return a;
}

// wrapping sum over the G lanes of a group (groups aligned to G), in every
// lane of it
template <int G>
__device__ __forceinline__ u64 group_sum(u64 v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <int NP, int G>
__global__ void __launch_bounds__(jt::kThreads)
    counter_drain_dense(const __grid_constant__ CounterDensePlan p,
                        const u64* __restrict__ d0,
                        const u64* __restrict__ d1, u64* __restrict__ out) {
  constexpr int RPW = 32 / G;  // rows a warp takes at a time, per half step
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const long long nwarps =
      static_cast<long long>(gridDim.x) * jt::kWarpsPerBlock;
  const int vecs = p.cols >> 1;
  const long long cols = p.cols;
  for (long long w = static_cast<long long>(blockIdx.x) * jt::kWarpsPerBlock +
                     (threadIdx.x >> 5);
       w * 2 * RPW < p.rows; w += nwarps) {
    const long long r0 = w * 2 * RPW + lane / G;
    const long long r1 = r0 + RPW;
    const bool v0 = r0 < p.rows, v1 = r1 < p.rows;
    const int slot0 = v0 ? p.map[r0] : -1;
    const int slot1 = v1 ? p.map[r1] : -1;
    u64 acc0 = 0, acc1 = 0;
    for (int j = sub; j < vecs; j += G) {
      ulonglong2 a0[NP], a1[NP], b0[NP], b1[NP];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const ulonglong2* s =
            reinterpret_cast<const ulonglong2*>(q ? p.s1 : p.s0);
        const ulonglong2* d = reinterpret_cast<const ulonglong2*>(q ? d1 : d0);
        if (v0) a0[q] = s[(r0 * cols >> 1) + j];
        if (v1) a1[q] = s[(r1 * cols >> 1) + j];
        if (slot0 >= 0) b0[q] = d[(slot0 * cols >> 1) + j];
        if (slot1 >= 0) b1[q] = d[(slot1 * cols >> 1) + j];
      }
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        ulonglong2* s = reinterpret_cast<ulonglong2*>(q ? p.s1 : p.s0);
        if (slot0 >= 0) {
          a0[q] = umax2(a0[q], b0[q]);
          s[(r0 * cols >> 1) + j] = a0[q];
        }
        if (slot1 >= 0) {
          a1[q] = umax2(a1[q], b1[q]);
          s[(r1 * cols >> 1) + j] = a1[q];
        }
        if (v0) acc0 += q ? 0 - (a0[q].x + a0[q].y) : a0[q].x + a0[q].y;
        if (v1) acc1 += q ? 0 - (a1[q].x + a1[q].y) : a1[q].x + a1[q].y;
      }
    }
    acc0 = group_sum<G>(acc0);
    acc1 = group_sum<G>(acc1);
    if (sub == 0) {
      if (v0) {
        p.sums[r0] = acc0;
        if (slot0 >= 0) {
          out[slot0] = acc0;
          p.map[r0] = -1;
        }
      }
      if (v1) {
        p.sums[r1] = acc1;
        if (slot1 >= 0) {
          out[slot1] = acc1;
          p.map[r1] = -1;
        }
      }
    }
  }
}

// resident blocks of one instantiation on one SM, asked once
template <int NP, int G>
int blocks_per_sm() {
  static const int n = [] {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, counter_drain_dense<NP, G>, jt::kThreads, 0) != cudaSuccess ||
        b < 1) {
      cudaGetLastError();  // a failed query is not the launch's error
      b = 1;
    }
    return b;
  }();
  return n;
}

template <int NP, int G>
void walk(const CounterDensePlan& p, const void* d0, const void* d1,
          void* out, int sms, cudaStream_t stream) {
  constexpr int RPW = 32 / G;
  const long long warps = (p.rows + 2 * RPW - 1) / (2 * RPW);
  long long blocks = (warps + jt::kWarpsPerBlock - 1) / jt::kWarpsPerBlock;
  const long long resident =
      static_cast<long long>(sms) * blocks_per_sm<NP, G>();
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  counter_drain_dense<NP, G>
      <<<static_cast<int>(blocks), jt::kThreads, 0, stream>>>(
          p, static_cast<const u64*>(d0), static_cast<const u64*>(d1),
          static_cast<u64*>(out));
}

template <int NP>
void launch_np(const CounterDensePlan& p, const void* d0, const void* d1,
              void* out, int sms, cudaStream_t st) {
  const int vecs = p.cols >> 1;
  if (vecs <= 1) {
    walk<NP, 1>(p, d0, d1, out, sms, st);
  } else if (vecs <= 2) {
    walk<NP, 2>(p, d0, d1, out, sms, st);
  } else if (vecs <= 4) {
    walk<NP, 4>(p, d0, d1, out, sms, st);
  } else if (vecs <= 8) {
    walk<NP, 8>(p, d0, d1, out, sms, st);
  } else if (vecs <= 16) {
    walk<NP, 16>(p, d0, d1, out, sms, st);
  } else {
    walk<NP, 32>(p, d0, d1, out, sms, st);
  }
}

}  // namespace

// np: 1 (GCOUNT) or 2 (PNCOUNT; d1 and the plan's s1 unused for 1).
// plan: the keyspace's CounterDensePlan (cols even and >= 2, every plane
// and delta region 16-byte aligned, the map clean; the wrapper checks).
// rows, d0, d1: the staged batch of `batch` slots; out: (batch,) sums.
// Sets the plan's card as the current device for the two launches on
// `stream` and restores the caller's. Returns the first nonzero
// cudaError_t, else cudaGetLastError() after the walk.
extern "C" int jt_counter_drain_dense(int np, const void* plan,
                                      const void* rows, const void* d0,
                                      const void* d1, void* out,
                                      long long batch, void* stream) {
  const CounterDensePlan* p = static_cast<const CounterDensePlan*>(plan);
  if ((np != 1 && np != 2) || p->cols < 2 || (p->cols & 1) || p->rows < 1 ||
      p->rows > 0x7FFFFFFFLL || batch < 0 || batch > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  jt::OnCard card(p->device);
  if (card.rc != cudaSuccess) return card.done(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = jt::launch_scatter(
      p->map, static_cast<const int*>(rows), batch, p->rows, card.sms, st);
  if (rc != cudaSuccess) return card.done(rc);
  if (np == 1) {
    launch_np<1>(*p, d0, d1, out, card.sms, st);
  } else {
    launch_np<2>(*p, d0, d1, out, card.sms, st);
  }
  return card.done(cudaGetLastError());
}
