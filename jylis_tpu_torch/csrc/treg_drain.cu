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
// Dense: the batch is compact, as the sparse drain's: B slots at UNIQUE
// rows rows[s] in [0, K) with their (dts, drank, dvid)[s], staged in one
// buffer. Every key k gets a tie flag tie[k]: 0 where it has no slot (the
// JAX package's delta planes carry the identity (0, 0, -1) there, which
// never wins or ties), so the state and the flags change only at the
// batch's rows. The drain is therefore two launches: one clears the
// (K,) flags, then one pass over the slots in the batch's order joins
// each slot's delta into its row in place, writes tie_out[s], out_ts[s]
// and out_vid[s] (the row's winner) and sets tie[row] where it ties. A
// duplicate row races two slots on one register: the caller's fault, as
// for the sparse drain. A slot whose row, read unsigned, is not below K
// writes nothing.
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
// Bound: bytes. Dense: the K tie flags written; per slot 4 (row) + 20
// (delta) + 20 (gather) + 13 (outputs) and 20 of state written where B
// wins: at K = 1,048,576 and B = K / 4, 17.9 MB when a third of the
// slots win (21.2 MB when all do), 0.0053-0.0063 ms at 3.35 TB/s (a walk
// over every key would read the 20 bytes of every key's state besides;
// the earlier whole-plane drain read a delta plane per key: 61 B a key,
// 64 MB). Sparse, per slot: 4 (row) + 20 (delta) + 20 (gather) + 20
// (scatter, where B wins) + 1 (tie) + 12 (out_ts, out_vid) = 77 B. About
// 10 integer operations per key. Both gather and scatter one random
// 32-byte sector per plane, so the structure-of-arrays layout's own
// floor is 3 sectors (96 B) per slot gathered and 3 per winner
// scattered, beside the streamed batch.
//
// Design: the clear, 16 bytes a thread over a grid of resident blocks;
// the slots, dense and sparse, one thread a slot, grid-stride. The state
// is written only where B wins. No shared memory: every byte is touched
// once.
#include <cuda_runtime.h>

#include "slot_map.cuh"

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

// the layout ops/treg.py's _TregDensePlan mirrors with ctypes
struct TregDensePlan {
  u64* ts;
  u64* rank;
  int* vid;
  unsigned char* tie;  // (K,) every key's tie flag, 16-byte aligned
  long long k;
  int device;  // the card the planes live on
};

// tie[0, k) = 0: 16 bytes a thread, the last k % 16 by thread 0
__global__ void __launch_bounds__(kThreads)
    treg_dense_clear(unsigned char* __restrict__ tie, long long k) {
  const long long n16 = k >> 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < n16; i += stride) {
    reinterpret_cast<uint4*>(tie)[i] = make_uint4(0, 0, 0, 0);
  }
  if (first == 0) {
    for (long long i = n16 << 4; i < k; ++i) tie[i] = 0;
  }
}

// one thread a slot: the LWW join at rows[s], in place, the slot's
// outputs, and the key's tie flag where it ties (clear before)
__global__ void __launch_bounds__(kThreads)
    treg_drain_dense(const __grid_constant__ TregDensePlan p,
                     const int* __restrict__ rows,
                     const u64* __restrict__ dts,
                     const u64* __restrict__ drank,
                     const int* __restrict__ dvid,
                     unsigned char* __restrict__ tie_out,
                     u64* __restrict__ out_ts, int* __restrict__ out_vid,
                     long long batch) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       s < batch; s += stride) {
    const unsigned int row = static_cast<unsigned int>(rows[s]);
    if (row >= p.k) continue;
    Reg a{p.ts[row], p.rank[row], p.vid[row]};
    const Reg b{dts[s], drank[s], dvid[s]};
    bool t;
    if (b_wins(a, b, &t)) {
      p.ts[row] = b.ts;
      p.rank[row] = b.rank;
      p.vid[row] = b.vid;
      a = b;
    }
    tie_out[s] = t;
    out_ts[s] = a.ts;
    out_vid[s] = a.vid;
    if (t) p.tie[row] = 1;
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

// plan: the keyspace's TregDensePlan (tie 16-byte aligned; the wrapper
// checks). rows, dts, drank, dvid: the staged batch of `batch` slots;
// tie_out, out_ts, out_vid: (batch,) outputs at the slots. Sets the
// plan's card as the current device for the two launches on `stream`
// and restores the caller's. Returns the first nonzero cudaError_t, else
// cudaGetLastError() after the slots' launch.
extern "C" int jt_treg_drain_dense(const void* plan, const void* rows,
                                   const void* dts, const void* drank,
                                   const void* dvid, void* tie_out,
                                   void* out_ts, void* out_vid,
                                   long long batch, void* stream) {
  const TregDensePlan* p = static_cast<const TregDensePlan*>(plan);
  if (p->k < 1 || p->k > 0x7FFFFFFFLL || batch < 0 ||
      batch > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  jt::OnCard card(p->device);
  if (card.rc != cudaSuccess) return card.done(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long clear = ((p->k >> 4) + kThreads - 1) / kThreads;
  if (clear > 4LL * card.sms) clear = 4LL * card.sms;
  if (clear < 1) clear = 1;
  treg_dense_clear<<<static_cast<int>(clear), kThreads, 0, st>>>(p->tie,
                                                                 p->k);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || batch < 1) return card.done(rc);
  treg_drain_dense<<<blocks_for(batch), kThreads, 0, st>>>(
      *p, static_cast<const int*>(rows), static_cast<const u64*>(dts),
      static_cast<const u64*>(drank), static_cast<const int*>(dvid),
      static_cast<unsigned char*>(tie_out), static_cast<u64*>(out_ts),
      static_cast<int*>(out_vid), batch);
  return card.done(cudaGetLastError());
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
