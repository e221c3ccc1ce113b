// Hopper (sm_90a) building blocks in raw PTX, for kernels built on TMA and
// wgmma: mbarriers, named barriers, the 4-D TMA tile load and its host-side
// tensor map (bf16 or fp32), the 1-D bulk copy, shared-memory matrix
// descriptors, wgmma m64nNk16 (bf16 in, fp32 accumulators) in SS and RS form
// and m64nNk8 in TF32 (fp32 operands rounded to TF32, both K-major), with its
// fence / commit / wait, the rounding to TF32, the proxy fence that hands
// shared memory written by threads to wgmma, setmaxnreg, and the producer's
// staging of a bias tile. Raw PTX rather than CuTe keeps the build to one
// plain-C translation unit per kernel file.
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
// A tile that threads write themselves for wgmma to read (K-major, 128-byte
// swizzle) puts the 16-byte unit u of row r at unit u ^ (r % 8) of the row,
// as TMA would, and is handed over with fence_proxy_async.
// TF32 operands (4-byte elements) take the same layouts in bytes: a k-step
// of 8 elements is 32 bytes, W = 32 columns fill a 128-byte swizzle row and
// W = 8 a 32-byte one; PTX allows TF32 operands K-major only.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mask.cuh"

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

// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads, a multiple
// of 32: syncs the consumer warpgroups without the producer.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Makes this thread's shared-memory stores visible to the async proxy
// (wgmma operands read through a descriptor); before the barrier that hands
// the tile over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// `bytes` (a multiple of 16) of global memory at `src` into shared memory at
// `dst`, both 16-byte aligned, as one bulk copy; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
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
#define FDSD_F16 FDSD_F8(0), FDSD_F8(8)
#define FDSD_F20 FDSD_F16, FDSD_F4(16)
#define FDSD_F24 FDSD_F8(0), FDSD_F8(8), FDSD_F8(16)
#define FDSD_F32 FDSD_F24, FDSD_F8(24)
#define FDSD_F36 FDSD_F32, FDSD_F4(32)
#define FDSD_F40 FDSD_F32, FDSD_F8(32)
#define FDSD_F64 FDSD_F40, FDSD_F8(40), FDSD_F8(48), FDSD_F8(56)
#define FDSD_F80 FDSD_F64, FDSD_F8(64), FDSD_F8(72)
#define FDSD_F128                                                          \
  FDSD_F64, FDSD_F8(64), FDSD_F8(72), FDSD_F8(80), FDSD_F8(88), FDSD_F8(96), \
      FDSD_F8(104), FDSD_F8(112), FDSD_F8(120)
#define FDSD_R8 "{%0,%1,%2,%3,%4,%5,%6,%7}"
#define FDSD_R16 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}"
#define FDSD_R20 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19}"
#define FDSD_R24                                                            \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23}"
#define FDSD_R32 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"
#define FDSD_R36 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35}"
#define FDSD_R40 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37," \
  "%38,%39}"
#define FDSD_R64 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37," \
  "%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55," \
  "%56,%57,%58,%59,%60,%61,%62,%63}"
#define FDSD_R80 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37," \
  "%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55," \
  "%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73," \
  "%74,%75,%76,%77,%78,%79}"
#define FDSD_R128 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37," \
  "%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55," \
  "%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73," \
  "%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91," \
  "%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107," \
  "%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121," \
  "%122,%123,%124,%125,%126,%127}"

// D(64 x N) (+)= A(64 x 16) B(16 x N): A K-major in shared memory; B
// K-major (TRANS_B = 0: N rows with the reduction along the row, as K of
// S = Q K^T) or MN-major (TRANS_B = 1: rows of the reduction, as V of
// O = P V, read as it lies). scale_d = 0 overwrites D.
template <int N, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 256, "wgmma_ss: N");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " FDSD_R16
        ", %16, %17, p, 1, 1, 0, %19;\n}\n"
        : FDSD_F16
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FDSD_R32
        ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : FDSD_F32
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FDSD_R64
        ", %64, %65, p, 1, 1, 0, %67;\n}\n"
        : FDSD_F64
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " FDSD_R128
        ", %128, %129, p, 1, 1, 0, %131;\n}\n"
        : FDSD_F128
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
}

// D(64 x N) (+)= A(64 x 16) B(16 x N): A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory (read
// transposed). scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 48 || N == 64 || N == 80 || N == 128 || N == 160,
                "wgmma_rs: N");
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
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FDSD_R64
        ", {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
        : FDSD_F64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 " FDSD_R80
        ", {%80,%81,%82,%83}, %84, p, 1, 1, 1;\n}\n"
        : FDSD_F80
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
}

// x rounded to TF32 (nearest, ties away): the fp32 bit pattern with the low
// 13 mantissa bits zero, exactly what the tensor cores read of it.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// D(64 x N) (+)= A(64 x 8) B(8 x N) in TF32: A and B K-major in shared
// memory (every element already a TF32 value). scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2],
                                              uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_tf32_ss: N");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " FDSD_R8
        ", %8, %9, p, 1, 1;\n}\n"
        : FDSD_F8(0)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " FDSD_R16
        ", %16, %17, p, 1, 1;\n}\n"
        : FDSD_F16
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " FDSD_R32
        ", %32, %33, p, 1, 1;\n}\n"
        : FDSD_F32
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// D(64 x N) (+)= A(64 x 8) B(8 x N) in TF32: A from registers (each warp's
// 16 rows: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) with
// g = lane / 4, t = lane % 4), B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  static_assert(N == 40 || N == 48 || N == 64 || N == 72 || N == 80 ||
                    N == 128,
                "wgmma_tf32_rs: N");
// SHAPE, the accumulators' list and constraints, then the operand numbers
// of the setp (scale_d) and of a[0..3] and desc_b, as one string each.
#define FDSD_TF32_RS(SHAPE, R, F, P, OPS)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32.tf32.tf32 " R      \
               ", " OPS ", p, 1, 1;\n}\n"                                     \
               : F                                                           \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),    \
                 "r"(scale_d))
  if constexpr (N == 40) {
    FDSD_TF32_RS("m64n40k8", FDSD_R20, FDSD_F20, "%25",
                 "{%20,%21,%22,%23}, %24");
  } else if constexpr (N == 48) {
    FDSD_TF32_RS("m64n48k8", FDSD_R24, FDSD_F24, "%29",
                 "{%24,%25,%26,%27}, %28");
  } else if constexpr (N == 64) {
    FDSD_TF32_RS("m64n64k8", FDSD_R32, FDSD_F32, "%37",
                 "{%32,%33,%34,%35}, %36");
  } else if constexpr (N == 72) {
    FDSD_TF32_RS("m64n72k8", FDSD_R36, FDSD_F36, "%41",
                 "{%36,%37,%38,%39}, %40");
  } else if constexpr (N == 80) {
    FDSD_TF32_RS("m64n80k8", FDSD_R40, FDSD_F40, "%45",
                 "{%40,%41,%42,%43}, %44");
  } else {
    FDSD_TF32_RS("m64n128k8", FDSD_R64, FDSD_F64, "%69",
                 "{%64,%65,%66,%67}, %68");
  }
#undef FDSD_TF32_RS
}

#undef FDSD_F4
#undef FDSD_F8
#undef FDSD_F16
#undef FDSD_F20
#undef FDSD_F24
#undef FDSD_F32
#undef FDSD_F36
#undef FDSD_F40
#undef FDSD_F64
#undef FDSD_F80
#undef FDSD_F128
#undef FDSD_R8
#undef FDSD_R16
#undef FDSD_R20
#undef FDSD_R24
#undef FDSD_R32
#undef FDSD_R36
#undef FDSD_R40
#undef FDSD_R64
#undef FDSD_R80
#undef FDSD_R128

// ------------------------------------------------------------- setmaxnreg
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Two fp32 values rounded to bf16 and packed into one 32-bit register (lo in
// the low half): a pair of an A fragment of the RS form.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ----------------------------------------------------------- bias staging
// A (ROWS queries x COLS keys) bias tile in shared memory, in the bias's own
// dtype T: row r, column c at r * COLS + (c ^ 8 * (r % 8)). The swizzle keeps
// each 16-byte vector whole and spreads the reads of a quad over the banks.
template <int COLS>
__device__ __forceinline__ int bias_at(int r, int c) {
  return r * COLS + (c ^ ((r & 7) << 3));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A producer warpgroup's 128 threads copy the bias tile (rows q0.., keys
// k0..; zeros past Lq and Lk) into shared memory, each ending with one
// arrival on `full`. Where the key axis is contiguous and rows start on 16
// bytes: 16-byte cp.async copies (zero-filled past the ends), which hold no
// registers, so a thread keeps all of its share of the tile in flight; else
// one element at a time (thread tid: column tid % COLS of every
// (128 / COLS)-th row from tid / COLS).
template <int ROWS, int COLS, typename T>
__device__ __forceinline__ void stage_bias(T* tile, const MaskArgs& m,
                                           long long base, int q0, int k0,
                                           int Lq, int Lk, int tid,
                                           uint32_t full) {
  static_assert(COLS == 64 || COLS == 128, "128 producer threads");
  constexpr int V = 16 / sizeof(T), kVecs = COLS / V, kRows = 128 / kVecs;
  const T* bias = static_cast<const T*>(m.bias);
  const bool vec =
      m.bs[3] == 1 && m.bs[2] % V == 0 &&
      reinterpret_cast<uintptr_t>(bias + base + q0 * m.bs[2] + k0) % 16 == 0;
  if (vec) {
    // the producer holds 40 registers: a short unroll and running pointers
    const int rr = tid / kVecs, c0 = (tid % kVecs) * V;
    const int bytes = max(0, min(V, Lk - k0 - c0)) * sizeof(T);
    const T* src = bias + base + (q0 + rr) * m.bs[2] + k0 + c0;
    const long long step = kRows * m.bs[2];
#pragma unroll 2
    for (int r = rr; r < ROWS; r += kRows, src += step)
      cp_async_16(smem_u32(tile + bias_at<COLS>(r, c0)),
                  q0 + r < Lq && bytes > 0 ? src : bias,
                  q0 + r < Lq ? bytes : 0);
    cp_async_mbar_arrive(full);  // when this thread's copies have landed
    return;
  }
  const int c = tid % COLS, col = k0 + c;
#pragma unroll 2
  for (int r = tid / COLS; r < ROWS; r += 128 / COLS)
    tile[bias_at<COLS>(r, c)] =
        q0 + r < Lq && col < Lk ? bias[base + (q0 + r) * m.bs[2] +
                                       col * m.bs[3]]
                                : T(0.f);
  mbar_arrive(full);
}

// ------------------------------------------------- tensor maps (host side)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (D, L, H, B) tensor map of a bf16 (or, with `type` FLOAT32, fp32)
// operand over its (batch, head, seq) element strides (head dim contiguous),
// box W columns x `rows` rows; rows past L and columns past D read as zeros.
inline cudaError_t make_map(
    CUtensorMap* map, const void* ptr, int d, int L, int H, int B,
    const long long* st, int W, int rows, CUtensorMapSwizzle swizzle,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t size = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const long long elem[3] = {st[2], st[1], st[0]};  // seq, head, batch
  cuuint64_t strides[3];
  cuuint64_t extent = dims[0] * size;  // bytes spanned by the dims below
  for (int i = 0; i < 3; ++i) {
    // a dim of size 1 is never stepped: give it a dense stride
    strides[i] = dims[i + 1] == 1 ? extent
                                  : static_cast<cuuint64_t>(elem[i]) * size;
    extent = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(W),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Sets the kernel's dynamic shared memory and launches it on `stream`.
template <typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, int blocks, int threads, int smem,
                          cudaStream_t stream, const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace fdsd
