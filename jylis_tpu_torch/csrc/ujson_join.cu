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
// (ujson_join_cta); and a thread-block cluster per row for rows past a
// CTA's shared memory (ujson_join_cluster, below). The slot's steps are
// written once for the warp and the CTA (warp_ops.cuh): compactions are
// ballot scans, __ballot_sync + __popc in a warp and one barrier to
// combine the warps in a CTA. The work buffer holds the two rows, the
// merged cloud and the flags. Steps, each ended by the group's sync: load
// (the output may alias a's row: a group reads its whole row before it
// writes any of it); keep/add flags by binary searches (membership in
// the other row, coverage by a vv lookup plus a search in the other
// cloud) and the vv max; the clouds merged by co-rank (each entry's
// position is its index plus a search in the other cloud, a before b on
// ties) and adjacent repeats dropped by a compaction in place; the kept
// a-dots and added b-dots compacted in place the same way (both stay
// sorted); the sorted dots written by co-rank (kept and added are
// disjoint, so a lower-bound search places each); the epilogue's
// exclusive scan of the kept flags, a segment start by binary search for
// (col << shift), the absorbed counts by shared-memory atomics, the
// surviving cloud compacted straight into the output. The warp kernel is
// held to 64 registers (4 CTAs of 256 threads an SM): its rows are small
// and many, so rows in flight matter more than registers. Crossovers
// (the wrapper's WARP_ROW_BYTES and WARP_MIN_ROWS: fewer rows fill the
// card better a CTA each), measured on an H100 by
// scripts/row_kernel_profile.py --sweep: PERF.md §6.
//
// The cluster class (rows past shared memory: the broadcast of a folded
// row 65,536 wide, the last levels of a long fold tree). n CTAs per row
// (a power of two, up to 16; cudaLaunchKernelEx); rows are sorted with
// their pads last, so each row's live prefix is found by a binary search
// for the pad and only live entries are merged. CTA q owns a merge-path
// partition: output positions [q * M / n, (q + 1) * M / n) of the merge
// of a's and b's live dots (M of them; a before b on ties), each thread a
// stretch of up to 32 of them, found by a co-rank search into the two
// rows. Walking the merge in order, a dot's twin in the other row is its
// neighbour there (a-dot at (i, j): b[j]; b-dot: a[i - 1]), so membership
// costs one compare; coverage is a vv lookup and a search of the other
// cloud. The kept dots (with their payload ids) are staged in the CTA's
// shared memory in merged order; the clouds the same way, an entry
// dropped when it equals the entry before it in the merge (across a
// partition edge too: the co-rank gives that entry). One cluster-wide
// exclusive scan (each CTA publishes its two counts, cluster.sync(),
// every CTA reads the others' through distributed shared memory,
// cluster.map_shared_rank) places every CTA's window in the output; that
// barrier also ends every read of a's row, so `out` may be `a`. The
// epilogue runs on the staged cloud windows: the kept counts scanned
// across the cluster, a segment's start found by a search over the
// windows (the CTA's own, or the cluster's when its window opens inside
// the segment), its kept count read where it lies, absorbed counts by
// shared-memory atomics, summed across the CTAs into vv, survivors
// written at a third cluster scan's offsets. b's row is read once per
// cluster, each CTA its window of it (the broadcast reads one row for
// every slot). A row too wide for 16 CTAs' shared memory keeps the
// windows in device scratch, one region a cluster; the steps are the
// same.
//
// Bound: bytes (the rows are read once and written once); operations: a
// log2 search per dot and per cloud entry into the other side, a few
// compares per entry, scans per chunk of 256. The source counts
//   reads  La + Lb dots and payload ids, Ca + Cb cloud entries, 2R vv;
//   writes Lo dots and ids, Co cloud entries, R vv
// and per row (La + Lb)(log2 L + log2 C + 4) + (Ca + Cb)(log2 C + 6)
// operations, L and C the larger of the two widths.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_ops.cuh"
#include "warp_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using u32 = unsigned int;
using u64 = unsigned long long;

constexpr int kThreads = 256;
using jt::kClusterMax;
constexpr int kRun = 32;         // merged positions a cluster thread walks at once

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

// A CTA per slot (grid-stride); its work buffer in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ujson_join_cta(JT_JOIN_PARAMS, long long nrows) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int sums[2 * kThreads / 32];
  jt::CtaGroup<kThreads> g(sums);
  const Work<T> w(smem, la, lb, ca, cb, r);
  for (long long s = blockIdx.x; s < nrows; s += gridDim.x) {
    __syncthreads();  // the previous slot is done with the work buffer
    join_slot<T>(g, w, s, JT_JOIN_ARGS);
  }
}

// ---- the cluster class --------------------------------------------------

// entries of the merge of sorted a[0, na) and b[0, nb) among its first d
// that come from a (merge path; a before b on ties)
template <typename T>
__device__ __forceinline__ int co_rank(const T* a, int na, const T* b, int nb, int d) {
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool in = !(b[d - 1 - mid] < a[mid]);  // a[mid] <= b[d - 1 - mid]
    lo = in ? mid + 1 : lo;
    hi = in ? hi : mid;
  }
  return lo;
}

// the entries of a sorted row before its first pad
template <typename T>
__device__ __forceinline__ int live(const T* p, int n) {
  return jt::partition_point(n, [&](int i) { return p[i] != Layout<T>::kPad; });
}

// A CTA's share of the row's work buffer, carved as the wrapper sizes it
// (ujson_device.py `join_share`): windows of pd merged dots and pc merged
// cloud entries, then the row's vv columns.
template <typename T>
struct Share {
  T *dw, *cw;
  int *dp, *kbw;
  unsigned *fl;
  u32 *va, *vb, *vo, *cnt;
  __device__ Share(char* base, int pd, int pc, int r) {
    dw = reinterpret_cast<T*>(base);
    cw = dw + pd;
    dp = reinterpret_cast<int*>(cw + pc);
    kbw = dp + pd;
    fl = reinterpret_cast<unsigned*>(kbw + pc);
    va = fl + (pc + 31) / 32;
    vb = va + r;
    vo = vb + r;
    cnt = vo + r;
  }
};

// A cluster of n CTAs per slot (grid-stride over the clusters): CTA q's
// share in its shared memory, or (InScratch) at blockIdx.x * stride bytes
// of device scratch. A CTA reaches its own share as such (shared memory:
// the compiler emits shared-memory accesses), the others' through peers.
template <typename T, bool InScratch>
__global__ void __launch_bounds__(kThreads)
    ujson_join_cluster(JT_JOIN_PARAMS, char* scratch, long long stride,
                       long long nrows, int pd, int pc) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int sums[2 * kThreads / 32];
  __shared__ char* peers[kClusterMax];
  __shared__ int2 tab[kClusterMax];
  __shared__ int2 pub[2];
  __shared__ int cbase_of[kClusterMax + 1], kbase_of[kClusterMax];
  cg::cluster_group cluster = cg::this_cluster();
  jt::CtaGroup<kThreads> g(sums);
  const int q = static_cast<int>(cluster.block_rank());
  const int n = static_cast<int>(cluster.num_blocks());
  const long long cid = blockIdx.x / n, nclusters = gridDim.x / n;
  const int tid = g.rank, crank = q * kThreads + tid, csize = n * kThreads;
  const T pad = Layout<T>::kPad;
  if (tid < n) {
    peers[tid] = InScratch ? scratch + (cid * n + tid) * stride
                           : cluster.map_shared_rank(smem, tid);
  }
  char* const mine = InScratch ? scratch + blockIdx.x * stride : smem;
  int xc = 0;

  for (long long s = cid; s < nrows; s += nclusters) {
    cluster.sync();  // every CTA is done with the previous slot's windows
    const Share<T> w(mine, pd, pc, r);
    const long long ra = a_idx ? static_cast<long long>(a_idx[s]) : s;
    const long long rb = s * b_step;
    T* od = o_dots + ra * lo;
    int* op = o_pay + ra * lo;
    u32* ov = o_vv + ra * r;
    T* oc = o_cloud + ra * co;
    if (occupied && !occupied[ra]) {  // a free row: the identity document
      for (int i = crank; i < lo; i += csize) {
        od[i] = pad;
        op[i] = -1;
      }
      for (int i = crank; i < co; i += csize) oc[i] = pad;
      for (int i = crank; i < r; i += csize) ov[i] = 0;
      continue;
    }
    const T* ad = a_dots + ra * la;
    const int* ap = a_pay + ra * la;
    const T* ac = a_cloud + ra * ca;
    const T* bd = b_dots + rb * lb;
    const int* bp = b_pay + rb * lb;
    const T* bc = b_cloud + rb * cb;
    const int nla = live(ad, la), nlb = live(bd, lb);
    const int nca = live(ac, ca), ncb = live(bc, cb);
    for (int i = tid; i < r; i += kThreads) {
      const u32 x = a_vv[ra * r + i], y = b_vv[rb * r + i];
      w.va[i] = x;
      w.vb[i] = y;
      w.vo[i] = x > y ? x : y;
      w.cnt[i] = 0;
    }
    for (int i = tid; i < (pc + 31) / 32; i += kThreads) w.fl[i] = 0;
    __syncthreads();

    // the dots: this CTA's window of the merge of the live rows, each
    // thread kRun positions of it at a time; a flag a position, then the
    // kept ones staged (sorted) or written in place (unsorted)
    const int md = nla + nlb;
    const int d0 = static_cast<int>(static_cast<long long>(md) * q / n);
    const int d1 = static_cast<int>(static_cast<long long>(md) * (q + 1) / n);
    int dcnt = 0;
    for (int r0 = d0; r0 < d1; r0 += kThreads * kRun) {
      const int p0 = min(r0 + tid * kRun, d1), p1 = min(p0 + kRun, d1);
      const int i0 = co_rank(ad, nla, bd, nlb, p0);
      unsigned mask = 0;
      for (int p = p0, i = i0, j = p0 - i0; p < p1; ++p) {
        const bool ta = i < nla && (j >= nlb || !(bd[j] < ad[i]));
        bool f;
        if (ta) {
          const T x = ad[i];
          f = (j < nlb && bd[j] == x) || !covered(w.vb, bc, ncb, x, shift, r);
          if (!sorted) {
            od[i] = f ? x : pad;
            op[i] = f ? ap[i] : -1;
          }
          ++i;
        } else {
          const T x = bd[j];
          f = !(i > 0 && ad[i - 1] == x) && !covered(w.va, ac, nca, x, shift, r);
          if (!sorted) {
            od[la + j] = f ? x : pad;
            op[la + j] = f ? bp[j] : -1;
          }
          ++j;
        }
        mask |= static_cast<unsigned>(f) << (p - p0);
      }
      int tot;
      const int at = dcnt + g.exscan(__popc(mask), &tot);
      if (sorted) {
        for (int p = p0, i = i0, j = p0 - i0, k = 0; p < p1; ++p) {
          const bool ta = i < nla && (j >= nlb || !(bd[j] < ad[i]));
          if (mask >> (p - p0) & 1u) {
            w.dw[at + k] = ta ? ad[i] : bd[j];
            w.dp[at + k] = ta ? ap[i] : bp[j];
            ++k;
          }
          i += ta;
          j += !ta;
        }
      }
      dcnt += tot;
    }
    // the clouds: this CTA's window of their merge, an entry dropped when
    // it equals the one before it in the merge
    const int mc = nca + ncb;
    const int c0 = static_cast<int>(static_cast<long long>(mc) * q / n);
    const int c1 = static_cast<int>(static_cast<long long>(mc) * (q + 1) / n);
    int ccnt = 0;
    for (int r0 = c0; r0 < c1; r0 += kThreads * kRun) {
      const int p0 = min(r0 + tid * kRun, c1), p1 = min(p0 + kRun, c1);
      const int i0 = co_rank(ac, nca, bc, ncb, p0);
      unsigned mask = 0;
      T prev = pad;
      {
        const int i = i0, j = p0 - i0;  // the entry at p0 - 1: the larger
        if (i > 0 && (j == 0 || !(ac[i - 1] < bc[j - 1]))) prev = ac[i - 1];
        else if (j > 0) prev = bc[j - 1];
      }
      for (int p = p0, i = i0, j = p0 - i0; p < p1; ++p) {
        const bool ta = i < nca && (j >= ncb || !(bc[j] < ac[i]));
        const T x = ta ? ac[i] : bc[j];
        mask |= static_cast<unsigned>(p == 0 || x != prev) << (p - p0);
        prev = x;
        i += ta;
        j += !ta;
      }
      int tot;
      const int at = ccnt + g.exscan(__popc(mask), &tot);
      for (int p = p0, i = i0, j = p0 - i0, k = 0; p < p1; ++p) {
        const bool ta = i < nca && (j >= ncb || !(bc[j] < ac[i]));
        if (mask >> (p - p0) & 1u) w.cw[at + k++] = ta ? ac[i] : bc[j];
        i += ta;
        j += !ta;
      }
      ccnt += tot;
    }
    if (!sorted) {  // the unsorted rows' pads (no epilogue on this path)
      for (int p = nla + crank; p < la; p += csize) {
        od[p] = pad;
        op[p] = -1;
      }
      for (int p = nlb + crank; p < lb; p += csize) {
        od[la + p] = pad;
        op[la + p] = -1;
      }
    }
    // every CTA's windows placed (and every read of a's row done)
    jt::exchange(cluster, pub, xc, make_int2(dcnt, ccnt), tab);
    int dbase = 0, nd = 0, cbase = 0, nc = 0;
    for (int k = 0; k < n; ++k) {
      dbase += k < q ? tab[k].x : 0;
      nd += tab[k].x;
      cbase += k < q ? tab[k].y : 0;
      if (tid == 0) cbase_of[k] = nc;  // (read after the next exchange)
      nc += tab[k].y;
    }
    if (tid == 0) cbase_of[n] = nc;
    if (sorted) {
      for (int i = tid; i < dcnt; i += kThreads) {
        const int p = dbase + i;
        if (p < lo) {
          od[p] = w.dw[i];
          op[p] = w.dp[i];
        }
      }
      for (int p = nd + crank; p < lo; p += csize) {
        od[p] = pad;
        op[p] = -1;
      }
    }
    if (!finish) {
      for (int i = tid; i < ccnt; i += kThreads) oc[cbase + i] = w.cw[i];
      for (int p = nc + crank; p < co; p += csize) oc[p] = pad;
      for (int i = crank; i < r; i += csize) ov[i] = w.vo[i];
      continue;
    }

    // the epilogue: _compact_ctx_row on (vo, the merged cloud), then the
    // fit. kbw[i]: kept entries of this window before i
    int kt = 0;
    for (int i0 = 0; i0 < ccnt; i0 += kThreads) {
      const int i = i0 + tid;
      bool keep = false;
      if (i < ccnt) {
        const T x = w.cw[i];
        keep = seq_of(x, shift) > vv_at(w.vo, col_of(x, shift, r));
      }
      int tot;
      const int pos = g.scan(keep, &tot);
      if (i < ccnt) w.kbw[i] = kt + pos;
      kt += tot;
    }
    jt::exchange(cluster, pub, xc, make_int2(kt, 0), tab);
    if (tid == 0) {
      int acc = 0;
      for (int k = 0; k < n; ++k) {
        kbase_of[k] = acc;
        acc += tab[k].x;
      }
    }
    __syncthreads();
    // the merged cloud's entry p and the kept entries before it, wherever
    // they lie in the cluster
    const size_t cw_off = reinterpret_cast<char*>(w.cw) - mine;
    const size_t kb_off = reinterpret_cast<char*>(w.kbw) - mine;
    const auto owner = [&](int p) {
      return jt::partition_point(n, [&](int k) { return cbase_of[k + 1] <= p; });
    };
    const auto cloud_at = [&](int p) {
      const int k = owner(p);
      return reinterpret_cast<const T*>(peers[k] + cw_off)[p - cbase_of[k]];
    };
    const auto kb_at = [&](int p) {
      const int k = owner(p);
      return kbase_of[k] + reinterpret_cast<const int*>(peers[k] + kb_off)[p - cbase_of[k]];
    };
    // absorbed dots count into cnt; survivors (kept, not absorbed) flagged
    int sc = 0;
    for (int i0 = 0; i0 < ccnt; i0 += kThreads) {
      const int i = i0 + tid;
      bool surv = false;
      if (i < ccnt) {
        const T x = w.cw[i];
        const int c = col_of(x, shift, r);
        const u32 sq = seq_of(x, shift);
        const u32 vc = vv_at(w.vo, c);
        if (sq > vc) {
          // the column's segment starts at the first entry whose decoded
          // column is c: a search for (c << shift), in this window unless
          // the window opens inside the segment
          const T lo_x = static_cast<T>(static_cast<u64>(static_cast<u32>(c)) << shift);
          int start;
          if (w.cw[0] < lo_x) {
            start = cbase + jt::lower_bound(w.cw, i, lo_x);
          } else {
            start = jt::partition_point(cbase, [&](int p) { return cloud_at(p) < lo_x; });
          }
          const int kb_start = start >= cbase ? kbase_of[q] + w.kbw[start - cbase]
                                              : kb_at(start);
          const u32 rank = static_cast<u32>(kbase_of[q] + w.kbw[i] - kb_start);
          if (sq == vc + rank + 1u) {
            if (c >= 0) atomicAdd(&w.cnt[c], 1u);  // absorbed (nowhere, if negative)
          } else {
            surv = true;
          }
        }
        if (surv) atomicOr(&w.fl[i >> 5], 1u << (i & 31));
      }
      sc += g.count(surv);
    }
    jt::exchange(cluster, pub, xc, make_int2(sc, 0), tab);
    int sbase = 0, ns = 0;
    for (int k = 0; k < n; ++k) {
      sbase += k < q ? tab[k].x : 0;
      ns += tab[k].x;
    }
    for (int i0 = 0; i0 < ccnt; i0 += kThreads) {
      const int i = i0 + tid;
      const bool surv = i < ccnt && (w.fl[i >> 5] >> (i & 31) & 1u);
      int tot;
      const int pos = g.scan(surv, &tot);
      if (surv && sbase + pos < co) oc[sbase + pos] = w.cw[i];
      sbase += tot;
    }
    for (int p = ns + crank; p < co; p += csize) oc[p] = pad;
    const size_t cnt_off = reinterpret_cast<char*>(w.cnt) - mine;
    for (int i = crank; i < r; i += csize) {
      u32 add = 0;
      for (int k = 0; k < n; ++k) add += reinterpret_cast<const u32*>(peers[k] + cnt_off)[i];
      ov[i] = w.vo[i] + add;
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

template <typename F>
cudaError_t allow_smem(F* fn, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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
           long long csize, long long pd, long long pc, cudaStream_t stream) {
  if (nrows <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>(grid);
  const size_t bytes = static_cast<size_t>(smem);
  cudaError_t e = cudaSuccess;
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
    e = allow_smem(ujson_join_warp<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ujson_join_warp<T><<<blocks, static_cast<unsigned>(32 * rows_per_cta),
                         bytes, stream>>>(JT_JOIN_CALL_ARGS, stride, nrows,
                                          static_cast<int>(rows_per_cta));
  } else if (kind == 1) {
    e = allow_smem(ujson_join_cta<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ujson_join_cta<T><<<blocks, kThreads, bytes, stream>>>(JT_JOIN_CALL_ARGS, nrows);
  } else if (kind == 2 && csize >= 2 && csize <= kClusterMax && grid % csize == 0) {
    auto fn = scratch ? ujson_join_cluster<T, true> : ujson_join_cluster<T, false>;
    e = allow_smem(fn, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (csize > 8) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(csize);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // a cluster's CTAs must be resident together: refuse a launch the card
    // cannot place one cluster of
    int fits = 0;
    e = cudaOccupancyMaxActiveClusters(&fits, fn, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (fits < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    e = cudaLaunchKernelEx(&cfg, fn, JT_JOIN_CALL_ARGS, static_cast<char*>(scratch),
                           stride, nrows, static_cast<int>(pd), static_cast<int>(pc));
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    return static_cast<int>(cudaErrorInvalidConfiguration);
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
// CTA per row, its work buffer in shared memory (smem bytes), 2 a
// cluster of csize CTAs per row (2..16), each CTA's share of pd merged
// dots and pc merged cloud entries in smem bytes of shared memory, or,
// when scratch is not null, at blockIdx.x * stride bytes of grid * stride
// bytes of device scratch. Returns a CUDA error code:
// cudaErrorInvalidConfiguration for a class it does not take or a
// cluster the card cannot place, else cudaGetLastError() after the
// launch.
extern "C" int jt_ujson_join(
    int wide, const void* a_dots, const void* a_pay, const void* a_vv,
    const void* a_cloud, const void* a_idx, long long la, long long ca,
    const void* b_dots, const void* b_pay, const void* b_vv,
    const void* b_cloud, long long b_step, long long lb, long long cb,
    long long r, long long shift, void* o_dots, void* o_pay, void* o_vv,
    void* o_cloud, long long lo, long long co, long long sorted,
    long long finish, const void* occupied, long long kind,
    long long rows_per_cta, void* scratch, long long stride, long long nrows,
    long long grid, long long smem, long long csize, long long pd,
    long long pc, void* stream) {
  auto fn = wide ? launch<u64> : launch<int>;
  return fn(a_dots, a_pay, a_vv, a_cloud, a_idx, la, ca, b_dots, b_pay, b_vv,
            b_cloud, b_step, lb, cb, r, shift, o_dots, o_pay, o_vv, o_cloud,
            lo, co, sorted, finish, occupied, kind, rows_per_cta, scratch,
            stride, nrows, grid, smem, csize, pd, pc,
            static_cast<cudaStream_t>(stream));
}
