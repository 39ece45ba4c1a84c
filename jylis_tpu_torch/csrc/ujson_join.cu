// ujson_join: the row-wise ORSWOT join of two UJSON document batches, with
// an optional context-compaction + fit epilogue.
//
// Replaces jylis_tpu/ops/ujson_device.py `_join_row` (:109, with `_member`
// :78, `_covered` :85 and `_sortmerge` :101) as XLA runs it for
// `join_batch` (:143), the fold levels of `_fold_body` (:183:
// `fold_deltas`, `fold_segments`, `fold_and_broadcast`), and the joins of
// jylis_tpu/ops/ujson_resident.py `fold_join_subset` (:218) and
// `fold_broadcast_rows` (:256) with their epilogue `_finish` (:203:
// `_compact_ctx_row` :150 and `_fit` :189).
//
// A row is a DocBatch row (jylis_tpu_torch/ops/ujson_device.py): dots and
// cloud sorted ascending and pad-filled (T = int in the narrow layout, pad
// 0x7FFFFFFF; T = unsigned long long in the wide one, pad all ones), int32
// payload ids (-1 pad) and a u32 version vector of R columns. A dot is
// (col << shift) | seq. Per output slot s, a = a_rows[a_idx ? a_idx[s] :
// s] and b = b_rows[s * b_step] (b_step 0 broadcasts one row):
//   keep an a-dot iff b holds it or b's context does not cover it; add a
//   b-dot iff a does not hold it and a's context does not cover it
//   (coverage: seq <= vv[min(col, R-1)] or the dot is in the cloud);
//   sorted: the kept and added dots merged ascending, payload ids riding
//   along, then pads; unsorted: the masked a row then the masked b row
//   (ujson_device.py:130-133); vv = max; cloud = the union, sorted and
//   deduplicated. Output widths La + Lb and Ca + Cb.
// With the epilogue (finish), `_compact_ctx_row` runs on the merged vv and
// cloud: a valid cloud dot drops when seq <= vv[col]; a kept one absorbs
// into vv when seq == vv[col] + rank + 1 in u32 arithmetic, rank counting
// the kept dots before it in its column's segment (segments start at
// valid dots, dropped ones included); vv[col] += absorbed count (u32).
// The planes are then fit (sliced or padded) to (Lo, Co) and written at
// row a_idx[s] (or s) of the output planes, which may be the a planes
// themselves: a CTA reads its whole row before it writes any of it. With
// `occupied`, rows not occupied get the identity row instead.
//
// Design. A join is a few dozen dependent steps over a row that is
// often a handful of dots (the early levels of a fold tree join
// thousands of such rows), so what bounds it is latency and
// synchronisation, not bytes. A launch's rows share their widths, and
// the wrapper (ops/ujson_device.py `join_plan`, ops/row_plan.py) picks a
// class for them: a warp per row, up to 8 rows a CTA, each warp owning a
// slice of shared memory, with only __syncwarp between steps
// (ujson_join_warp); a CTA of 256 threads per row for rows past a warp's
// slice, or launches of too few rows to fill the card a warp each
// (ujson_join_cta); and the same with its work buffer in device scratch
// per CTA, for rows past shared memory. The slot's steps are written once for both groups
// (warp_ops.cuh): compactions are ballot scans, __ballot_sync + __popc
// in a warp and one barrier to combine the warps in a CTA. The work
// buffer holds the two rows, the merged
// cloud and the flags. Steps, each ended by the group's sync: load (the
// output may alias a's row: a group reads its whole row before it writes
// any of it); keep/add flags by binary searches (membership in the other
// row, coverage by a vv lookup plus a search in the other cloud) and the
// vv max; the clouds merged by co-rank (each entry's position is its
// index plus a search in the other cloud, a before b on ties) and
// adjacent repeats dropped by a compaction in place; the kept a-dots and
// added b-dots compacted in place the same way (both stay sorted); the
// sorted dots written by co-rank (kept and added are disjoint, so a
// lower-bound search places each); the epilogue's exclusive scan of the
// kept flags, a segment start by binary search for (col << shift), the
// absorbed counts by shared-memory atomics, the surviving cloud
// compacted straight into the output. The warp kernel is held to 64
// registers (4 CTAs of 256 threads an SM): its rows are small and many,
// so rows in flight matter more than registers. Crossovers (the
// wrapper's WARP_ROW_BYTES and WARP_MIN_ROWS: fewer rows fill the card
// better a CTA each), measured on an H100 by
// scripts/row_kernel_profile.py --sweep: PERF.md §6.
//
// Bound: bytes (the rows are read once and written once); operations: a
// log2 search per dot and per cloud entry into the other side, a few
// compares per entry, scans per chunk of 256. The source counts
//   reads  La + Lb dots and payload ids, Ca + Cb cloud entries, 2R vv;
//   writes Lo dots and ids, Co cloud entries, R vv
// and per row (La + Lb)(log2 L + log2 C + 4) + (Ca + Cb)(log2 C + 6)
// operations, L and C the larger of the two widths.
#include <cuda_runtime.h>

#include "block_ops.cuh"
#include "warp_ops.cuh"

namespace {

using u32 = unsigned int;
using u64 = unsigned long long;

constexpr int kThreads = 256;

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

// a dot's column as JAX's join and context compaction decode it (column
// masks: ujson_device.py `_covered`, ujson_resident.py `_compact_ctx_row`):
// the column's low 32 bits as int32, min(., r - 1). A negative column (a
// wide column >= 2^31, bit 63 set) matches no column: vv_at reads 0 and
// nothing absorbs into it.
template <typename T>
__device__ __forceinline__ int col_of(T x, int shift, int r) {
  return min(static_cast<int>(static_cast<u32>(Layout<T>::bits(x) >> shift)), r - 1);
}

__device__ __forceinline__ u32 vv_at(const u32* vv, int col) {
  return col < 0 ? 0u : vv[col];
}

template <typename T>
__device__ __forceinline__ u32 seq_of(T x, int shift) {
  return static_cast<u32>(Layout<T>::bits(x) & ((1ull << shift) - 1));
}

template <typename T>
__device__ __forceinline__ bool covered(const u32* vv, const T* cloud, int c,
                                        T x, int shift, int r) {
  return seq_of(x, shift) <= vv_at(vv, col_of(x, shift, r)) || jt::member(cloud, c, x);
}

// the per-CTA work buffer, carved the same way the wrapper sizes it
template <typename T>
struct Work {
  T *ad, *bd, *ac, *bc, *mc;
  int *ap, *bp, *kb;
  u32 *va, *vb, *vo, *cnt;
  unsigned char* fl;
  __device__ Work(char* base, int la, int lb, int ca, int cb, int r) {
    T* t = reinterpret_cast<T*>(base);
    ad = t;
    bd = ad + la;
    ac = bd + lb;
    bc = ac + ca;
    mc = bc + cb;
    int* i = reinterpret_cast<int*>(mc + ca + cb);
    ap = i;
    bp = ap + la;
    kb = bp + lb;
    va = reinterpret_cast<u32*>(kb + ca + cb);
    vb = va + r;
    vo = vb + r;
    cnt = vo + r;
    fl = reinterpret_cast<unsigned char*>(cnt + r);
  }
};

// One output slot s of the join, across the group g that owns it; w is
// the group's work buffer. Every thread of the group calls it.
template <typename T, class G>
__device__ void join_slot(G& g, const Work<T>& w, long long s, const T* a_dots,
                          const int* a_pay, const u32* a_vv, const T* a_cloud,
                          const int* a_idx, int la, int ca, const T* b_dots,
                          const int* b_pay, const u32* b_vv, const T* b_cloud,
                          long long b_step, int lb, int cb, int r, int shift,
                          T* o_dots, int* o_pay, u32* o_vv, T* o_cloud, int lo,
                          int co, int sorted, int finish,
                          const unsigned char* occupied) {
  constexpr int N = G::kSize;
  const T pad = Layout<T>::kPad;
  const int tid = g.rank;
  const int cm = ca + cb;
  const long long ra = a_idx ? static_cast<long long>(a_idx[s]) : s;
  const long long rb = s * b_step;
  T* od = o_dots + ra * lo;
  int* op = o_pay + ra * lo;
  u32* ov = o_vv + ra * r;
  T* oc = o_cloud + ra * co;
  if (occupied && !occupied[ra]) {  // a free row: the identity document
    for (int i = tid; i < lo; i += N) {
      od[i] = pad;
      op[i] = -1;
    }
    for (int i = tid; i < co; i += N) oc[i] = pad;
    for (int i = tid; i < r; i += N) ov[i] = 0;
    return;
  }

  // load both rows (the output may alias a's row: nothing is written
  // before the sync below)
  for (int i = tid; i < la; i += N) {
    w.ad[i] = a_dots[ra * la + i];
    w.ap[i] = a_pay[ra * la + i];
  }
  for (int i = tid; i < lb; i += N) {
    w.bd[i] = b_dots[rb * lb + i];
    w.bp[i] = b_pay[rb * lb + i];
  }
  for (int i = tid; i < ca; i += N) w.ac[i] = a_cloud[ra * ca + i];
  for (int i = tid; i < cb; i += N) w.bc[i] = b_cloud[rb * cb + i];
  for (int i = tid; i < r; i += N) {
    w.va[i] = a_vv[ra * r + i];
    w.vb[i] = b_vv[rb * r + i];
    w.cnt[i] = 0;
  }
  g.sync();

  // keep / add flags, the vv max, the clouds merged by co-rank
  for (int i = tid; i < la; i += N) {
    const T x = w.ad[i];
    w.fl[i] = x != pad && (jt::member(w.bd, lb, x) ||
                           !covered(w.vb, w.bc, cb, x, shift, r));
  }
  for (int j = tid; j < lb; j += N) {
    const T x = w.bd[j];
    w.fl[la + j] = x != pad && !jt::member(w.ad, la, x) &&
                   !covered(w.va, w.ac, ca, x, shift, r);
  }
  for (int i = tid; i < r; i += N) {
    w.vo[i] = w.va[i] > w.vb[i] ? w.va[i] : w.vb[i];
  }
  for (int i = tid; i < ca; i += N) {
    w.mc[i + jt::lower_bound(w.bc, cb, w.ac[i])] = w.ac[i];
  }
  for (int j = tid; j < cb; j += N) {
    w.mc[j + jt::upper_bound(w.ac, ca, w.bc[j])] = w.bc[j];
  }
  g.sync();

  // drop the merged cloud's pads and repeats, compacting in place: a
  // chunk reads before its scan's sync and writes after it, at or below
  // each source index; the left neighbour of a chunk's first entry was
  // read by the chunk before (`last`), never after a write
  int nc = 0;
  T last = pad;
  for (int p0 = 0; p0 < cm; p0 += N) {
    const int p = p0 + tid;
    bool keep = false;
    T x = pad;
    if (p < cm) {
      x = w.mc[p];
      const T prev = tid ? w.mc[p - 1] : last;
      keep = x != pad && (p == 0 || prev != x);
    }
    if (p0 + N - 1 < cm) last = w.mc[p0 + N - 1];
    int tot;
    const int pos = g.scan(keep, &tot);
    if (keep) w.mc[nc + pos] = x;
    nc += tot;
  }

  // the dots
  int na = la, nb = lb;
  if (sorted) {
    na = nb = 0;
    for (int i0 = 0; i0 < la; i0 += N) {
      const int i = i0 + tid;
      const bool keep = i < la && w.fl[i];
      T x = pad;
      int py = -1;
      if (keep) {
        x = w.ad[i];
        py = w.ap[i];
      }
      int tot;
      const int pos = g.scan(keep, &tot);
      if (keep) {
        w.ad[na + pos] = x;
        w.ap[na + pos] = py;
      }
      na += tot;
    }
    for (int j0 = 0; j0 < lb; j0 += N) {
      const int j = j0 + tid;
      const bool keep = j < lb && w.fl[la + j];
      T x = pad;
      int py = -1;
      if (keep) {
        x = w.bd[j];
        py = w.bp[j];
      }
      int tot;
      const int pos = g.scan(keep, &tot);
      if (keep) {
        w.bd[nb + pos] = x;
        w.bp[nb + pos] = py;
      }
      nb += tot;
    }
    g.sync();
    for (int i = tid; i < na; i += N) {
      const int p = i + jt::lower_bound(w.bd, nb, w.ad[i]);
      if (p < lo) {
        od[p] = w.ad[i];
        op[p] = w.ap[i];
      }
    }
    for (int j = tid; j < nb; j += N) {
      const int p = j + jt::lower_bound(w.ad, na, w.bd[j]);
      if (p < lo) {
        od[p] = w.bd[j];
        op[p] = w.bp[j];
      }
    }
    for (int p = na + nb + tid; p < lo; p += N) {
      od[p] = pad;
      op[p] = -1;
    }
  } else {  // the masked rows side by side (no epilogue on this path)
    for (int i = tid; i < la; i += N) {
      od[i] = w.fl[i] ? w.ad[i] : pad;
      op[i] = w.fl[i] ? w.ap[i] : -1;
    }
    for (int j = tid; j < lb; j += N) {
      od[la + j] = w.fl[la + j] ? w.bd[j] : pad;
      op[la + j] = w.fl[la + j] ? w.bp[j] : -1;
    }
  }

  if (!finish) {
    for (int p = tid; p < co; p += N) oc[p] = p < nc ? w.mc[p] : pad;
    for (int i = tid; i < r; i += N) ov[i] = w.vo[i];
    return;
  }

  // the epilogue: _compact_ctx_row on (vo, mc[0, nc)), then the fit.
  // kb[p]: kept entries before p (an exclusive scan of the kept flags)
  int kt = 0;
  for (int p0 = 0; p0 < nc; p0 += N) {
    const int p = p0 + tid;
    bool keep = false;
    if (p < nc) {
      const T x = w.mc[p];
      keep = seq_of(x, shift) > vv_at(w.vo, col_of(x, shift, r));
    }
    int tot;
    const int pos = g.scan(keep, &tot);
    if (p < nc) w.kb[p] = kt + pos;
    kt += tot;
  }
  g.sync();
  // absorbed dots count into cnt; survivors (kept, not absorbed) are
  // compacted into the output cloud
  int ns = 0;
  for (int p0 = 0; p0 < nc; p0 += N) {
    const int p = p0 + tid;
    bool surv = false;
    T x = pad;
    if (p < nc) {
      x = w.mc[p];
      const int c = col_of(x, shift, r);
      const u32 sq = seq_of(x, shift);
      const u32 vc = vv_at(w.vo, c);
      if (sq > vc) {
        // the column's segment starts at the first entry whose decoded
        // column is c: a search for (c << shift), c as its u32 field (a
        // negative column is its field's alone)
        const T lo_x = static_cast<T>(static_cast<u64>(static_cast<u32>(c)) << shift);
        const int start = jt::lower_bound(w.mc, nc, lo_x);
        const u32 rank = static_cast<u32>(w.kb[p] - w.kb[start]);
        if (sq == vc + rank + 1u) {
          if (c >= 0) atomicAdd(&w.cnt[c], 1u);  // absorbed (nowhere, if negative)
        } else {
          surv = true;
        }
      }
    }
    int tot;
    const int pos = g.scan(surv, &tot);
    if (surv && ns + pos < co) oc[ns + pos] = x;
    ns += tot;
  }
  for (int p = ns + tid; p < co; p += N) oc[p] = pad;
  g.sync();
  for (int i = tid; i < r; i += N) ov[i] = w.vo[i] + w.cnt[i];
}

#define JT_JOIN_PARAMS                                                      \
  const T *a_dots, const int *a_pay, const u32 *a_vv, const T *a_cloud,     \
      const int *a_idx, int la, int ca, const T *b_dots, const int *b_pay,  \
      const u32 *b_vv, const T *b_cloud, long long b_step, int lb, int cb,  \
      int r, int shift, T *o_dots, int *o_pay, u32 *o_vv, T *o_cloud,       \
      int lo, int co, int sorted, int finish,                               \
      const unsigned char *occupied
#define JT_JOIN_ARGS                                                        \
  a_dots, a_pay, a_vv, a_cloud, a_idx, la, ca, b_dots, b_pay, b_vv,         \
      b_cloud, b_step, lb, cb, r, shift, o_dots, o_pay, o_vv, o_cloud, lo,  \
      co, sorted, finish, occupied

// A warp per slot, rows_per_cta warps a CTA, each with `stride` bytes of
// the CTA's shared memory.
template <typename T>
__global__ void __launch_bounds__(256, 4)
    ujson_join_warp(JT_JOIN_PARAMS, long long stride, long long nrows,
                    int rows_per_cta) {
  extern __shared__ __align__(16) char smem[];
  jt::WarpGroup g;
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const Work<T> w(smem + warp * stride, la, lb, ca, cb, r);
  for (long long s = static_cast<long long>(blockIdx.x) * rows_per_cta + warp;
       s < nrows; s += static_cast<long long>(gridDim.x) * rows_per_cta) {
    __syncwarp();  // the previous slot is done with the slice
    join_slot<T>(g, w, s, JT_JOIN_ARGS);
  }
}

// A CTA per slot (grid-stride); its work buffer in shared memory, or at
// blockIdx.x * stride of device scratch when scratch is not null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ujson_join_cta(JT_JOIN_PARAMS, char* scratch, long long stride,
                   long long nrows) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int sums[2 * kThreads / 32];
  jt::CtaGroup<kThreads> g(sums);
  const Work<T> w(scratch ? scratch + blockIdx.x * stride : smem, la, lb, ca,
                  cb, r);
  for (long long s = blockIdx.x; s < nrows; s += gridDim.x) {
    __syncthreads();  // the previous slot is done with the work buffer
    join_slot<T>(g, w, s, JT_JOIN_ARGS);
  }
}

template <typename F>
void allow_smem(F* fn, long long smem) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
}

template <typename T>
int launch(const void* a_dots, const void* a_pay, const void* a_vv,
           const void* a_cloud, const void* a_idx, long long la, long long ca,
           const void* b_dots, const void* b_pay, const void* b_vv,
           const void* b_cloud, long long b_step, long long lb, long long cb,
           long long r, long long shift, void* o_dots, void* o_pay,
           void* o_vv, void* o_cloud, long long lo, long long co,
           long long sorted, long long finish, const void* occupied,
           long long kind, long long rows_per_cta, void* scratch,
           long long stride, long long nrows, long long grid, long long smem,
           cudaStream_t stream) {
  if (nrows <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>(grid);
  const size_t bytes = static_cast<size_t>(smem);
#define JT_JOIN_CALL_ARGS                                                   \
  static_cast<const T*>(a_dots), static_cast<const int*>(a_pay),            \
      static_cast<const u32*>(a_vv), static_cast<const T*>(a_cloud),        \
      static_cast<const int*>(a_idx), static_cast<int>(la),                 \
      static_cast<int>(ca), static_cast<const T*>(b_dots),                  \
      static_cast<const int*>(b_pay), static_cast<const u32*>(b_vv),        \
      static_cast<const T*>(b_cloud), b_step, static_cast<int>(lb),         \
      static_cast<int>(cb), static_cast<int>(r), static_cast<int>(shift),   \
      static_cast<T*>(o_dots), static_cast<int*>(o_pay),                    \
      static_cast<u32*>(o_vv), static_cast<T*>(o_cloud),                    \
      static_cast<int>(lo), static_cast<int>(co), static_cast<int>(sorted), \
      static_cast<int>(finish), static_cast<const unsigned char*>(occupied)
  if (kind == 0) {
    allow_smem(ujson_join_warp<T>, smem);
    ujson_join_warp<T><<<blocks, static_cast<unsigned>(32 * rows_per_cta),
                         bytes, stream>>>(JT_JOIN_CALL_ARGS, stride, nrows,
                                          static_cast<int>(rows_per_cta));
  } else {
    allow_smem(ujson_join_cta<T>, smem);
    ujson_join_cta<T><<<blocks, kThreads, bytes, stream>>>(
        JT_JOIN_CALL_ARGS, static_cast<char*>(scratch), stride, nrows);
  }
#undef JT_JOIN_CALL_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wide: 1 for the u64 layout (dots and cloud as 8-byte words), 0 for the
// narrow int32 one. a_*: (Na, La) dots and ids, (Na, R) vv, (Na, Ca) cloud;
// a_idx: (nrows,) int32 rows of a and of the output, or null for row s.
// b_*: rows s * b_step. o_*: (., Lo) dots and ids, (., R) vv, (., Co)
// cloud; without finish, Lo = La + Lb and Co = Ca + Cb. occupied: a byte
// per output row, or null. kind: 0 a warp per row (rows_per_cta warps a
// CTA, each with stride bytes of its smem bytes of shared memory), 1 a
// CTA per row, its work buffer in shared memory (smem bytes) when scratch
// is null, else at blockIdx.x * stride bytes of grid * stride bytes of
// device scratch. Returns cudaGetLastError() after the launch.
extern "C" int jt_ujson_join(
    int wide, const void* a_dots, const void* a_pay, const void* a_vv,
    const void* a_cloud, const void* a_idx, long long la, long long ca,
    const void* b_dots, const void* b_pay, const void* b_vv,
    const void* b_cloud, long long b_step, long long lb, long long cb,
    long long r, long long shift, void* o_dots, void* o_pay, void* o_vv,
    void* o_cloud, long long lo, long long co, long long sorted,
    long long finish, const void* occupied, long long kind,
    long long rows_per_cta, void* scratch, long long stride, long long nrows,
    long long grid, long long smem, void* stream) {
  auto fn = wide ? launch<u64> : launch<int>;
  return fn(a_dots, a_pay, a_vv, a_cloud, a_idx, la, ca, b_dots, b_pay, b_vv,
            b_cloud, b_step, lb, cb, r, shift, o_dots, o_pay, o_vv, o_cloud,
            lo, co, sorted, finish, occupied, kind, rows_per_cta, scratch,
            stride, nrows, grid, smem, static_cast<cudaStream_t>(stream));
}
