// Shared by the position-masked flash kernels (forward and backward): the
// global-position arithmetic of a local block made of two offset segments,
//   pos(idx) = off0 + idx          if idx <  seg
//            = off1 + (idx - seg)  otherwise,
// and what a (query tile, key tile) pair needs under the masks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fdsd {

// The position masks of one launch: the two offsets of each side (int32[2]
// in device memory), the segment boundaries, valid_len (when has_valid) and
// causal by position.
struct PosArgs {
  const int* q_off;
  const int* k_off;
  int seg_q, seg_k, valid_len, has_valid, causal;
};

__device__ __forceinline__ int pos_of(int idx, int off0, int off1, int seg) {
  return idx < seg ? off0 + idx : off1 + (idx - seg);
}

// Least and largest position over local indices [start, start + len) cut to
// [0, actual); start < actual.
__device__ __forceinline__ void pos_bounds(int start, int len, int off0,
                                           int off1, int seg, int actual,
                                           int& lo, int& hi) {
  const int end = min(start + len, actual) - 1;
  const bool has0 = start < seg, has1 = end >= seg;
  const int lo0 = off0 + start, hi0 = off0 + min(end, seg - 1);
  const int lo1 = off1 + max(start, seg) - seg, hi1 = off1 + (end - seg);
  lo = (has0 && has1) ? min(lo0, lo1) : (has0 ? lo0 : lo1);
  hi = (has0 && has1) ? max(hi0, hi1) : (has0 ? hi0 : hi1);
}

// What a (query tile, key tile) pair needs, from the position bounds of the
// two tiles: 0 nothing in it is visible (skip it), 1 everything is, 2 some
// logits are masked. Producer and consumers of a warp-specialised kernel
// call it with the same arguments, so they walk the same tiles.
__device__ __forceinline__ int pos_pair(const PosArgs& a, int q_lo, int q_hi,
                                        int k_lo, int k_hi) {
  if ((a.has_valid && k_lo >= a.valid_len) || (a.causal && k_lo > q_hi))
    return 0;
  return (a.has_valid && k_hi >= a.valid_len) || (a.causal && k_hi > q_lo)
             ? 2 : 1;
}

}  // namespace fdsd
