// Shared by the flash forward and backward kernels (K1, K3, K4): what their
// causal, additive-bias and segment-id forms read besides q, k and v.
//
// bias: fp32 or bf16, read at b*bs[0] + h*bs[1] + row*bs[2] + col*bs[3]
//   (element strides; 0 on an axis the bias is broadcast over), added to the
//   scaled logit in fp32.
// q_ids (B, Lq), kv_ids (B, Lk): int32 segment ids; a query sees a key only
//   when the two ids are equal.
// q_bounds (B, n_q, 2), kv_bounds (B, n_k, 2): [min, max] id of each tile, at
//   the launching kernel's own tile sizes; two tiles whose id ranges are
//   disjoint hold no visible pair and are skipped.
// lo, hi (B, n_self): for each tile of the axis the grid runs over, the first
//   and last tile of the other axis whose id range overlaps: the bounds of
//   the block's loop.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fdsd {

struct MaskArgs {
  const void* bias;
  long long bs[4];
  int bias_bf16;
  const int* q_ids;
  const int* kv_ids;
  const int* q_bounds;
  const int* kv_bounds;
  const int* lo;
  const int* hi;
};

// MaskArgs from a C entry's pointers (null where a form is not asked for);
// bias_strides: the bias's 4 element strides.
inline MaskArgs make_mask_args(const void* bias, const long long* bias_strides,
                               int bias_bf16, const void* q_ids,
                               const void* kv_ids, const void* q_bounds,
                               const void* kv_bounds, const void* lo,
                               const void* hi) {
  MaskArgs m;
  m.bias = bias;
  for (int i = 0; i < 4; ++i) m.bs[i] = bias_strides[i];
  m.bias_bf16 = bias_bf16;
  m.q_ids = static_cast<const int*>(q_ids);
  m.kv_ids = static_cast<const int*>(kv_ids);
  m.q_bounds = static_cast<const int*>(q_bounds);
  m.kv_bounds = static_cast<const int*>(kv_bounds);
  m.lo = static_cast<const int*>(lo);
  m.hi = static_cast<const int*>(hi);
  return m;
}

__device__ __forceinline__ float load_bias(const MaskArgs& m, long long base,
                                           int row, int col) {
  const long long off = base + row * m.bs[2] + col * m.bs[3];
  return m.bias_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(m.bias)[off])
             : static_cast<const float*>(m.bias)[off];
}

// Do the id ranges [a[0], a[1]] and [b[0], b[1]] overlap?
__device__ __forceinline__ bool seg_overlap(const int* a, const int* b) {
  return a[0] <= b[1] && b[0] <= a[1];
}

}  // namespace fdsd
