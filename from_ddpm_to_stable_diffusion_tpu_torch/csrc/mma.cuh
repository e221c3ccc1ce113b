// Warp-level tensor-core helpers shared by the flash-attention kernels:
// mma.sync m16n8k16 (bf16 -> fp32), its fragment loads from shared memory,
// and bf16 packing. With g = lane / 4 and t = lane % 4 the fragments are
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):       c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fdsd {

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A(16x16, row) * B(16x8, col); bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[i] holds, of matrix i,
// the elements (g, 2t..2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r,
                                            const __nv_bfloat16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed: r[i] holds (2t..2t+1, g) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

}  // namespace fdsd
