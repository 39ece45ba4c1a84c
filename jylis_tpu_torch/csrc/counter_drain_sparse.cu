// counter_drain_sparse<NP>: the batched counter drain at B unique rows,
// over the shards of a keyspace that live on one card.
//
// Replaces jylis_tpu/models/repo_counters.py `_drain_g` (NP = 1, GCOUNT)
// and `_drain_pn` (NP = 2, PNCOUNT, :54-63): XLA's planes.scatter_join
// (gather the batch rows, unsigned max with the (B, R) delta rows,
// scatter back) followed by planes.rowsum64 of the joined rows, and with
// them the per-shard drains of jylis_tpu/parallel/sharded.py
// (drain_sharded_g / _pn, :212-268). For each batch slot b of GLOBAL row
// g = rows[b]: shard = g / rows_per_shard, local = g % rows_per_shard;
// when the shard is one of the table's, state_p[local] =
// max(state_p[local], delta_p[b]) in place in that shard's planes, and
// sums[b] = the joined row's wrapping sum (PNCOUNT: sum(P) - sum(N)).
//
// The shard table: the base pointers of the shards on this card (at most
// kMaxShards), the card's first shard and rows_per_shard, passed by value
// as a kernel parameter. A single device is the table of one shard with
// rows_per_shard = K. A slot whose shard is not in the table (another
// card's, or a row >= K: the routed callers' pads) writes nothing, so
// the host never un-routes: each result lands at its slot's own index.
// rows is read unsigned, so a negative row is off the table too.
//
// The batch: rows (B int32), then the P rows (B x R u64) and the N rows.
// On the serving path they are the three 16-byte aligned regions of one
// staged buffer copied to the card in one transfer (ops/staging.py).
//
// Bound: bytes. Per live slot and polarity, one state row read and
// written and one delta row read (3 * R * 8 bytes), plus the row index
// and the sum. At B = 1024, R = 64 the whole batch is ~3 MB, so launch
// latency and the staged copy, not the kernel's bandwidth, set the time
// of a call at the serving shapes.
//
// Design: one warp per batch slot does gather, max, store and the warp
// sum in one pass; the row load, the shard split (one 32-bit divide) and
// the table lookup are warp-uniform, and a slot off the table costs the
// warp one load.
#include "counter_row.cuh"

namespace {

using jt::u64;

constexpr int kMaxShards = 8;

// the layout ops/planes.py's _CounterTable mirrors with ctypes
struct CounterTable {
  u64* p[kMaxShards];  // P planes (GCOUNT: the only plane)
  u64* n[kMaxShards];  // N planes (PNCOUNT; unused for NP = 1)
  long long rows_per_shard;
  int first;  // global index of the table's first shard
  int count;  // shards in the table
};

template <int NP>
__global__ void __launch_bounds__(jt::kThreads)
    counter_drain_sparse(const __grid_constant__ CounterTable tab,
                         const int* __restrict__ rows,
                         const u64* __restrict__ d0,
                         const u64* __restrict__ d1,
                         u64* __restrict__ sums, long long batch, int cols) {
  const int lane = threadIdx.x & 31;
  const unsigned int rps = static_cast<unsigned int>(tab.rows_per_shard);
  const long long nwarps =
      static_cast<long long>(gridDim.x) * jt::kWarpsPerBlock;
  for (long long b = static_cast<long long>(blockIdx.x) * jt::kWarpsPerBlock +
                     (threadIdx.x >> 5);
       b < batch; b += nwarps) {
    const unsigned int g = static_cast<unsigned int>(rows[b]);
    const unsigned int shard = g / rps;
    const long long e = static_cast<long long>(shard) - tab.first;
    if (e < 0 || e >= tab.count) continue;  // warp-uniform: not this card's
    const long long so = static_cast<long long>(g - shard * rps) * cols;
    const long long dof = b * cols;
    u64 v = jt::join_row(tab.p[e] + so, d0 + dof, cols, lane);
    if (NP == 2) v -= jt::join_row(tab.n[e] + so, d1 + dof, cols, lane);
    v = jt::warp_sum(v);
    if (lane == 0) sums[b] = v;
  }
}

template <int NP>
void launch(const CounterTable& tab, const void* rows, const void* d0,
            const void* d1, void* sums, long long batch, int cols,
            cudaStream_t stream) {
  counter_drain_sparse<NP>
      <<<jt::blocks_for_warps(batch), jt::kThreads, 0, stream>>>(
          tab, static_cast<const int*>(rows), static_cast<const u64*>(d0),
          static_cast<const u64*>(d1), static_cast<u64*>(sums), batch, cols);
}

}  // namespace

// np: 1 (GCOUNT) or 2 (PNCOUNT; d1 and the table's n planes are unused
// for 1). table: the card's CounterTable, copied into the launch. cols must
// be even and every plane and delta region 16-byte aligned, 1 <= count <=
// kMaxShards and 1 <= rows_per_shard < 2^32 (the wrapper checks). batch 0
// launches nothing. Returns cudaGetLastError() after the launch.
extern "C" int jt_counter_drain_sparse(int np, const void* table,
                                       const void* rows, const void* d0,
                                       const void* d1, void* sums,
                                       long long batch, int cols,
                                       void* stream) {
  const CounterTable* tab = static_cast<const CounterTable*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tab->count < 1 || tab->count > kMaxShards ||
      tab->rows_per_shard < 1 || tab->rows_per_shard > 0xFFFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch < 1) return static_cast<int>(cudaGetLastError());
  if (np == 1) {
    launch<1>(*tab, rows, d0, d1, sums, batch, cols, st);
  } else if (np == 2) {
    launch<2>(*tab, rows, d0, d1, sums, batch, cols, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
