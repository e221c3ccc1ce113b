// Hopper (sm_90a) building blocks in raw PTX, for kernels built on TMA and
// wgmma: mbarriers, the 4-D TMA tile load, shared-memory matrix descriptors,
// wgmma m64nNk16 (bf16 in, fp32 accumulators) in SS and RS form with its
// fence / commit / wait, and setmaxnreg. Raw PTX rather than CuTe keeps the
// build to one plain-C translation unit per kernel file.
//
// Shared-memory operand layouts (the wgmma "canonical" layouts, written by
// TMA with the matching swizzle): a tile of R rows x DP bf16 columns is kept
// as DP / W column chunks, each R rows of W elements (2W bytes, the swizzle
// width: W = 64 with 128-byte swizzle, W = 16 with 32-byte swizzle), chunk
// after chunk. Eight rows of one chunk are one swizzle atom (8 x 2W bytes).
//  K-major operand (the reduction axis along the row, Q and K of S = Q K^T):
//    the k-step kk (16 columns) starts at chunk kk*16/W, byte (kk*16 % W)*2
//    of the row; SBO = one atom (8 rows), LBO unused.
//  MN-major operand (the reduction axis down the rows, V of O = P V, read
//    as it lies, B transposed): the k-step kk starts at row 16*kk;
//    SBO = one atom (8 rows), LBO = one chunk (the next W output columns).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fdsd {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// --------------------------------------------------------------------- TMA
// One box of a 4-D tensor map into shared memory at `dst`; completion is
// counted in bytes on `bar`. Coordinates innermost first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// 16 bytes global -> shared without registers; the bytes past `src_bytes`
// (0 to 16) are zero-filled and not read.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// One arrival on `bar`, made when every cp.async this thread issued before
// it has landed (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// Fetches a tensor map (in kernel parameter space) ahead of its first use.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type (1: 128-byte swizzle, 3: 32-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers around an asynchronous wgmma, so that the
// compiler moves no read or write of them across the issue or the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
#define FDSD_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FDSD_F8(i) FDSD_F4(i), FDSD_F4(i + 4)
#define FDSD_F24 FDSD_F8(0), FDSD_F8(8), FDSD_F8(16)
#define FDSD_F32 FDSD_F24, FDSD_F8(24)
#define FDSD_F40 FDSD_F32, FDSD_F8(32)
#define FDSD_F64 FDSD_F40, FDSD_F8(40), FDSD_F8(48), FDSD_F8(56)
#define FDSD_R24                                                            \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23}"
#define FDSD_R32 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"
#define FDSD_R40 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37," \
  "%38,%39}"
#define FDSD_R64 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37," \
  "%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55," \
  "%56,%57,%58,%59,%60,%61,%62,%63}"

// D(64 x 128) (+)= A(64 x 16) B(16 x 128)^T-as-stored: A and B both K-major
// in shared memory. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FDSD_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FDSD_F64
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x N) (+)= A(64 x 16) B(16 x N): A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory (read
// transposed). scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 48 || N == 64 || N == 80 || N == 128, "wgmma_rs: N");
  if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 " FDSD_R24
        ", {%24,%25,%26,%27}, %28, p, 1, 1, 1;\n}\n"
        : FDSD_F24
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FDSD_R32
        ", {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
        : FDSD_F32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  } else if constexpr (N == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " FDSD_R40
        ", {%40,%41,%42,%43}, %44, p, 1, 1, 1;\n}\n"
        : FDSD_F40
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FDSD_R64
        ", {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
        : FDSD_F64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
}

#undef FDSD_F4
#undef FDSD_F8
#undef FDSD_F24
#undef FDSD_F32
#undef FDSD_F40
#undef FDSD_F64
#undef FDSD_R24
#undef FDSD_R32
#undef FDSD_R40
#undef FDSD_R64

// ------------------------------------------------------------- setmaxnreg
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace sm90
}  // namespace fdsd
