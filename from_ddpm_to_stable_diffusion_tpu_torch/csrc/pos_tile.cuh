// Shared by the position-masked flash kernels (forward and backward): the
// global-position arithmetic of a local block made of two offset segments,
//   pos(idx) = off0 + idx          if idx <  seg
//            = off1 + (idx - seg)  otherwise,
// and the staging of a strided (len x D) bf16 matrix into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fdsd {

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

// Rows [r0, r0 + ROWS) of a strided (len x D) bf16 matrix into a row-major
// shared tile of row stride D + 8, rows past len as zeros; NT threads.
template <int D, int ROWS, int NT = 128>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int r0,
                                          int len, int tid) {
  constexpr int kVecs = D / 8, kStride = D + 8;
  for (int i = tid; i < ROWS * kVecs; i += NT) {
    const int r = i / kVecs, c = i % kVecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < len)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kStride + c * 8) = val;
  }
}

}  // namespace fdsd
