// The TENSOR per-cell select, shared by tensor_join_dense.cu (the port of
// the Pallas kernel) and tensor_converge_batch.cu (the gathered join).
//
// jylis_tpu/ops/tensor.py `_b_wins` / `_join_row`: cell B replaces cell A
// iff (ts_hi, ts_lo, rid, okey(val)) of B is lexicographically strictly
// greater, every component compared as an unsigned integer. okey(u) =
// (u >> 31) ? ~u : u | 0x80000000 is the order-preserving map of f32
// bits, so no NaN is ever compared as a float. The port keeps the four
// planes as int32 tensors of u32 bit patterns; here they are unsigned.
#pragma once

#include <cuda_runtime.h>

namespace jt {

__device__ __forceinline__ unsigned okey(unsigned u) {
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

// B's cell replaces A's: strict lexicographic (ts_hi, ts_lo, rid, okey)
__device__ __forceinline__ void join_cell(unsigned& av, unsigned& ath,
                                          unsigned& atl, unsigned& ar,
                                          unsigned bv, unsigned bth,
                                          unsigned btl, unsigned br) {
  bool wins;
  if (bth != ath) wins = bth > ath;
  else if (btl != atl) wins = btl > atl;
  else if (br != ar) wins = br > ar;
  else wins = okey(bv) > okey(av);
  if (wins) {
    av = bv;
    ath = bth;
    atl = btl;
    ar = br;
  }
}

// join_cell over the four neighbouring cells of one 16-byte vector per
// plane: (a0, a1, a2, a3) = (val, ts_hi, ts_lo, rid), in place
__device__ __forceinline__ void join_vec(uint4& a0, uint4& a1, uint4& a2,
                                         uint4& a3, const uint4& b0,
                                         const uint4& b1, const uint4& b2,
                                         const uint4& b3) {
  join_cell(a0.x, a1.x, a2.x, a3.x, b0.x, b1.x, b2.x, b3.x);
  join_cell(a0.y, a1.y, a2.y, a3.y, b0.y, b1.y, b2.y, b3.y);
  join_cell(a0.z, a1.z, a2.z, a3.z, b0.z, b1.z, b2.z, b3.z);
  join_cell(a0.w, a1.w, a2.w, a3.w, b0.w, b1.w, b2.w, b3.w);
}

}  // namespace jt
