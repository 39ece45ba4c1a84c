// treg_drain_dense / treg_drain_sparse: the TREG last-writer-wins drains.
//
// Replace jylis_tpu/models/repo_treg.py `_drain_dense` (:63) and `_drain`
// (:57), XLA programs over jylis_tpu/ops/treg.py `converge_dense` (:111)
// and `converge_batch` (:82), whose select is `_b_wins` (:62), and with
// the sparse one the per-shard drain of jylis_tpu/parallel/sharded.py
// (drain_sharded_treg, :295). The port keeps a register as three planes
// (jylis_tpu_torch/ops/treg.py): ts and rank as int64 bit patterns of
// u64, read here as unsigned long long, and vid as a signed int32 (-1 =
// unset). Pair B beats pair A iff
//   b.ts > a.ts, or ts equal and (b.rank > a.rank, or rank equal and
//   a.vid < 0 <= b.vid),
// with ts and rank compared unsigned. The tie flag marks ts and rank
// equal, both set and the vids different: two values that share their
// 8-byte prefix, which the repo settles on the host with full strings.
//
// Dense: for every key k, join (dts, drank, dvid)[k] into the state in
// place and write tie[k]. The repo reads the state planes themselves as
// the drain's outputs, so nothing else is written.
// Sparse: over the shards of a keyspace that live on one card, given as
// a table (their planes' base pointers, the card's first shard and
// rows_per_shard) passed by value as a kernel parameter; a single device
// is the table of one shard of K rows. For B slots at UNIQUE global rows
// rows[s]: shard = row / rows_per_shard, local = row % rows_per_shard;
// when the shard is in the table, gather, select, scatter the winner in
// that shard, and write tie[s], out_ts[s] and out_vid[s] (the row's
// winner) at the slot's own index. A slot whose shard is not in the
// table (another card's, or a row >= K: the routed callers' pads; rows is
// read unsigned, so negative rows too) writes nothing. On the serving
// path the batch [rows | ts | rank | vid] is one staged buffer copied to
// the card in one transfer, and the outputs one packed buffer copied
// back in one (ops/staging.py).
//
// Bound: bytes. Dense, per key: 20 bytes of state read, 20 of delta, at
// most 20 of state written, 1 of tie = 61 B; at K = 1,048,576 about 64 MB,
// 0.019 ms at 3.35 TB/s. Sparse, per slot: 4 (row) + 20 (delta) +
// 20 (gather) + 20 (scatter, where B wins) + 1 (tie) + 12 (out_ts,
// out_vid) = 77 B. About 10 integer operations per key. The sparse
// gathers and scatters touch one random 32-byte sector per plane, so the
// structure-of-arrays layout's own floor is 3 sectors (96 B) per slot
// gathered and 3 per winner scattered, beside the streamed batch.
//
// Design: one thread per key (dense) or slot (sparse), grid-stride; each
// plane is read with 8- or 4-byte loads by neighbouring threads, so every
// warp-wide access to the streamed planes is one contiguous run. The
// state is written only where B wins. No shared memory: every byte is
// touched once.
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

struct Reg {
  u64 ts, rank;
  int vid;
};

// jylis_tpu/ops/treg.py `_b_wins`: true where B strictly beats A; *tie as
// above
__device__ __forceinline__ bool b_wins(const Reg& a, const Reg& b,
                                       bool* tie) {
  const bool ts_eq = a.ts == b.ts;
  const bool rank_eq = a.rank == b.rank;
  *tie = ts_eq && rank_eq && a.vid >= 0 && b.vid >= 0 && a.vid != b.vid;
  return b.ts > a.ts ||
         (ts_eq && (b.rank > a.rank || (rank_eq && a.vid < 0 && b.vid >= 0)));
}

__global__ void __launch_bounds__(kThreads)
    treg_drain_dense(u64* __restrict__ ts, u64* __restrict__ rank,
                     int* __restrict__ vid, const u64* __restrict__ dts,
                     const u64* __restrict__ drank,
                     const int* __restrict__ dvid,
                     unsigned char* __restrict__ tie, long long k) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < k; i += stride) {
    const Reg a{ts[i], rank[i], vid[i]};
    const Reg b{dts[i], drank[i], dvid[i]};
    bool t;
    if (b_wins(a, b, &t)) {
      ts[i] = b.ts;
      rank[i] = b.rank;
      vid[i] = b.vid;
    }
    tie[i] = t;
  }
}

constexpr int kMaxShards = 8;

// the layout ops/treg.py's _TregTable mirrors with ctypes
struct TregTable {
  u64* ts[kMaxShards];
  u64* rank[kMaxShards];
  int* vid[kMaxShards];
  long long rows_per_shard;
  int first;  // global index of the table's first shard
  int count;  // shards in the table
};

__global__ void __launch_bounds__(kThreads)
    treg_drain_sparse(const __grid_constant__ TregTable tab,
                      const int* __restrict__ rows,
                      const u64* __restrict__ dts,
                      const u64* __restrict__ drank,
                      const int* __restrict__ dvid,
                      unsigned char* __restrict__ tie,
                      u64* __restrict__ out_ts, int* __restrict__ out_vid,
                      long long batch) {
  const unsigned int rps = static_cast<unsigned int>(tab.rows_per_shard);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       s < batch; s += stride) {
    const unsigned int g = static_cast<unsigned int>(rows[s]);
    const unsigned int shard = g / rps;
    const long long e = static_cast<long long>(shard) - tab.first;
    if (e < 0 || e >= tab.count) continue;  // not this card's slot
    const unsigned int row = g - shard * rps;
    u64* __restrict__ ts = tab.ts[e];
    u64* __restrict__ rank = tab.rank[e];
    int* __restrict__ vid = tab.vid[e];
    Reg a{ts[row], rank[row], vid[row]};
    const Reg b{dts[s], drank[s], dvid[s]};
    bool t;
    if (b_wins(a, b, &t)) {
      ts[row] = b.ts;
      rank[row] = b.rank;
      vid[row] = b.vid;
      a = b;
    }
    tie[s] = t;
    out_ts[s] = a.ts;
    out_vid[s] = a.vid;
  }
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// k: keys per plane. tie: (K,) bytes, 0 or 1. Returns cudaGetLastError()
// after the launch.
extern "C" int jt_treg_drain_dense(void* ts, void* rank, void* vid,
                                   const void* dts, const void* drank,
                                   const void* dvid, void* tie, long long k,
                                   void* stream) {
  treg_drain_dense<<<blocks_for(k), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<u64*>(ts), static_cast<u64*>(rank), static_cast<int*>(vid),
      static_cast<const u64*>(dts), static_cast<const u64*>(drank),
      static_cast<const int*>(dvid), static_cast<unsigned char*>(tie), k);
  return static_cast<int>(cudaGetLastError());
}

// table: the card's TregTable, copied into the launch (1 <= count <=
// kMaxShards, 1 <= rows_per_shard < 2^32; the wrapper checks). batch:
// slots B; tie, out_ts, out_vid: (B,), written only at the table's slots.
// batch 0 launches nothing. Returns cudaGetLastError() after the launch.
extern "C" int jt_treg_drain_sparse(const void* table, const void* rows,
                                    const void* dts, const void* drank,
                                    const void* dvid, void* tie, void* out_ts,
                                    void* out_vid, long long batch,
                                    void* stream) {
  const TregTable* tab = static_cast<const TregTable*>(table);
  if (tab->count < 1 || tab->count > kMaxShards ||
      tab->rows_per_shard < 1 || tab->rows_per_shard > 0xFFFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch < 1) return static_cast<int>(cudaGetLastError());
  treg_drain_sparse<<<blocks_for(batch), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      *tab, static_cast<const int*>(rows), static_cast<const u64*>(dts),
      static_cast<const u64*>(drank), static_cast<const int*>(dvid),
      static_cast<unsigned char*>(tie), static_cast<u64*>(out_ts),
      static_cast<int*>(out_vid), batch);
  return static_cast<int>(cudaGetLastError());
}
