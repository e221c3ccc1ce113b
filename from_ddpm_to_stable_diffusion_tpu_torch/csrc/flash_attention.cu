// Flash-attention forward at head dim 512 for Hopper (sm_90a) on TMA and
// wgmma, bf16 in, fp32 softmax, out bf16 + lse fp32: K1 for the VAE's
// one-head mid attention (SD1 decoder and encoder, (B, 1, 4096, 512); SD3
// decoder, (1, 1, 16384, 512)). The other head dims and every mask form are
// the kernel of flash_attention_sm90.cu.
//
// Replaces, at d = 512, the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_wide
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel
// (no mask), computing what they compute (out in bf16, lse = m + log l in
// fp32) with the TPU's sequential key-block grid axis as a loop in the block.
//
// What bounds it on the H100: operations (4096 keys: ~2,000 flop per byte),
// so the tensor cores' issue rate. The mma.sync kernel it replaces reached
// ~3 % of that bound: K and V were loaded synchronously, V was transposed
// element by element, and S went through fp32 shared memory with four block
// barriers per key tile.
//
// Design. A 64 x 512 fp32 output accumulator is 256 registers a thread for
// one warpgroup, more than a thread may hold, so one block of three
// warpgroups per (b*h, 64 queries, key split):
//  - a producer warpgroup gives up its registers (setmaxnreg 40); one thread
//    issues TMA: the Q tile once (64 KB), then K and V tiles of 64 keys
//    (64 KB each), each on its own single-stage full / empty mbarrier pair,
//    so that the next tile's K loads while this tile's P V runs and its V
//    while the next S and softmax run. 227 KB of shared memory hold one Q
//    and one K and V tile of 64 keys (a second stage of both would not fit).
//    Boxes are 64 columns with 128-byte swizzle, eight chunks per row.
//  - two consumer warpgroups (setmaxnreg 232), each owning 256 of the 512
//    output columns (128 fp32 registers of O), split S = Q K^T by keys: each
//    computes S for its 32 of the tile's 64 keys over the full d (wgmma
//    m64n32k16, SS form, both operands K-major as TMA wrote them). They
//    exchange the row maxima through shared memory under a named barrier of
//    the 256 consumer threads, so both apply the same running max; each
//    writes its half of P in bf16 into a (64 x 64) shared tile in the
//    128-byte swizzled K-major layout wgmma reads, fences it to the async
//    proxy, and after a second named barrier runs O[:, its columns] += P V
//    as m64n256k16 with P and V (MN-major, read as it lies) from shared
//    memory. Each keeps its own part of the row sums under the common max;
//    the two parts are added once, at the end.
//  - the key tail is masked on the last tile only (TMA's zeros are logits of
//    0, not masked ones).
//  - key split: with fewer 64-query blocks than SMs (SD1's 4096 queries give
//    64) the host splits the key tiles over up to four blocks per query
//    tile; each writes O / l in fp32 and its lse into a workspace, and
//    merge_d512_kernel combines them by their lse into out and lse. A row
//    with no key in a split gets lse = -1e30 there and weight 0.

#include "sm90.cuh"

namespace {

namespace s9 = fdsd::sm90;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int DP = 512, W = 64, kChunks = DP / W;
constexpr int kBQ = 64, kBK = 64, kHalf = kBK / 2;  // keys of S per consumer
constexpr int kMaxSplits = 4;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr uint32_t kAtom = 8 * W * 2;  // 8 rows of a chunk
constexpr int kQChunk = kBQ * W * 2, kKChunk = kBK * W * 2;
constexpr int kQBytes = kBQ * DP * 2, kKBytes = kBK * DP * 2;
constexpr int kKOff = kQBytes, kVOff = kKOff + kKBytes;
constexpr int kPOff = kVOff + kKBytes;  // P, 64 x 64 bf16: one chunk
constexpr int kStatOff = kPOff + kBQ * kBK * 2;  // row max, row sum: 2 x 2
constexpr int kBarOff = kStatOff + 4 * kBQ * 4;
constexpr int kBars = 5;  // Q full; K full, empty; V full, empty
constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
static_assert(kSmemBytes <= 232448, "shared memory");
static_assert(kBK == W, "P is one swizzled chunk");

struct Params {
  __nv_bfloat16* out;
  float* lse;
  float* work;  // splits > 1: O / l (splits, rows, 512), then lse (splits, rows)
  int H, Lq, Lk, n_qt, splits, kt_per_split;
  long long rows;   // B * H * Lq
  long long os[3];  // out's (batch, head, seq) element strides
  float scale;
};

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_d512_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  unsigned char* p_tile = smem + kPOff;
  // [max of consumer 0 | max of consumer 1 | sum 0 | sum 1], kBQ rows each
  float* stat = reinterpret_cast<float*>(smem + kStatOff);
  const uint32_t q_s = base, k_s = base + kKOff, v_s = base + kVOff;
  const uint32_t p_s = base + kPOff;
  const uint32_t q_full = base + kBarOff, k_full = q_full + 8;
  const uint32_t k_empty = k_full + 8, v_full = k_empty + 8;
  const uint32_t v_empty = v_full + 8;

  const int tid = threadIdx.x;
  const int split = blockIdx.x % p.splits;
  const int tile = blockIdx.x / p.splits;
  const int bh = tile / p.n_qt, qt = tile % p.n_qt;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kBQ;
  const int n_kt = (p.Lk + kBK - 1) / kBK;
  const int kt_begin = split * p.kt_per_split;
  const int kt_end = min(n_kt, kt_begin + p.kt_per_split);

  if (tid == 0) {
    s9::mbar_init(q_full, 1);
    s9::mbar_init(k_full, 1);
    s9::mbar_init(k_empty, kConsumers);
    s9::mbar_init(v_full, 1);
    s9::mbar_init(v_empty, kConsumers);
    s9::mbar_init_fence();
  } else if (tid == 32) {  // fetch the descriptors while barriers are set up
    s9::prefetch_tensormap(&tq);
    s9::prefetch_tensormap(&tk);
    s9::prefetch_tensormap(&tv);
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      s9::mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < kChunks; ++c)
        s9::tma_load_4d(q_s + c * kQChunk, &tq, q_full, c * W, q0, h, b);
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * kBK;
        s9::mbar_wait(k_empty, phase ^ 1);
        s9::mbar_expect_tx(k_full, kKBytes);
        for (int c = 0; c < kChunks; ++c)
          s9::tma_load_4d(k_s + c * kKChunk, &tk, k_full, c * W, k0, h, b);
        s9::mbar_wait(v_empty, phase ^ 1);
        s9::mbar_expect_tx(v_full, kKBytes);
        for (int c = 0; c < kChunks; ++c)
          s9::tma_load_4d(v_s + c * kKChunk, &tv, v_full, c * W, k0, h, b);
        phase ^= 1;
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    s9::reg_alloc<kConsumerRegs>();
    const int cw = (tid - 128) / 128;  // keys 32*cw.. of S, columns 256*cw..
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl0 = 16 * warp + g, rl1 = rl0 + 8;  // tile rows
    const float c = p.scale * kLog2e;  // exp(x * scale) = exp2(x * c)
    float m0 = kNegInf, m1 = kNegInf;  // running row max (logit units)
    float l0 = 0.f, l1 = 0.f;  // this thread's share of its half's row sums
    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float s[kHalf / 2];
    float* my_max = stat + cw * kBQ;
    const float* other_max = stat + (1 - cw) * kBQ;

    s9::mbar_wait(q_full, 0);  // also when no tile is visited: TMA is done
    uint32_t phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int k0 = kt * kBK;
      s9::mbar_wait(k_full, phase);

      // S = Q K^T for keys 32*cw .. 32*cw + 31 of the tile: raw logits.
      s9::fence_regs(s);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t chunk = kk * 16 / W, off = (kk * 16 % W) * 2;
        s9::wgmma_ss<kHalf>(
            s, s9::smem_desc(q_s + chunk * kQChunk + off, 16, kAtom, 1),
            s9::smem_desc(k_s + chunk * kKChunk + cw * kHalf * W * 2 + off, 16,
                          kAtom, 1),
            kk > 0);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(s);
      s9::mbar_arrive(k_empty);  // this group's reads of K are done

      if (k0 + kBK > p.Lk) {  // the key tail, on the last tile only
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + kHalf * cw + 8 * j + 2 * t + (e & 1) >= p.Lk)
              s[4 * j + e] = kNegInf;
      }

      // The row max over both halves of the tile, through shared memory.
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      if (t == 0) {
        my_max[rl0] = mx0;
        my_max[rl1] = mx1;
      }
      s9::named_barrier_sync(1, kConsumers);
      const float mn0 = fmaxf(m0, fmaxf(mx0, other_max[rl0]));
      const float mn1 = fmaxf(m1, fmaxf(mx1, other_max[rl1]));
      const float al0 = s9::exp2_approx((m0 - mn0) * c);
      const float al1 = s9::exp2_approx((m1 - mn1) * c);
      m0 = mn0;
      m1 = mn1;
      const float sub0 = mn0 * c, sub1 = mn1 * c;

      // P = exp(scale * (S - m)) in bf16 into this group's half of the P
      // tile: row r, keys 8u .. 8u + 7 at unit u ^ (r % 8) of the row.
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pr[e] = s9::exp2_approx(fmaf(s[4 * j + e], c, -(e < 2 ? sub0 : sub1)));
        sum0 += pr[0] + pr[1];
        sum1 += pr[2] + pr[3];
        const int u = cw * (kHalf / 8) + j;
        *reinterpret_cast<__nv_bfloat162*>(
            p_tile + rl0 * 128 + ((u ^ (rl0 & 7)) << 4) + 4 * t) =
            __floats2bfloat162_rn(pr[0], pr[1]);
        *reinterpret_cast<__nv_bfloat162*>(
            p_tile + rl1 * 128 + ((u ^ (rl1 & 7)) << 4) + 4 * t) =
            __floats2bfloat162_rn(pr[2], pr[3]);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
      s9::fence_proxy_async();  // P's stores, visible to wgmma
      s9::named_barrier_sync(2, kConsumers);
      s9::mbar_wait(v_full, phase);

      // O[:, 256*cw ..] += P V: P K-major, V MN-major; the k-step kk is keys
      // 16kk .. 16kk + 15.
      s9::fence_regs(o);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        s9::wgmma_ss<256, 1>(
            o, s9::smem_desc(p_s + kk * 32, 16, kAtom, 1),
            s9::smem_desc(v_s + 4 * cw * kKChunk + kk * 16 * W * 2, kKChunk,
                          kAtom, 1),
            1);
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(o);
      s9::mbar_arrive(v_empty);  // V and, for the next tile, P are free
      phase ^= 1;
    }

    // Epilogue: the row sums of both halves; O / l and lse = m + log l.
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (t == 0) {
      stat[(2 + cw) * kBQ + rl0] = l0;
      stat[(2 + cw) * kBQ + rl1] = l1;
    }
    s9::named_barrier_sync(1, kConsumers);
    l0 += stat[(3 - cw) * kBQ + rl0];
    l1 += stat[(3 - cw) * kBQ + rl1];
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    const float lse0 = l0 == 0.f ? kNegInf : m0 * p.scale + logf(l0);
    const float lse1 = l1 == 0.f ? kNegInf : m1 * p.scale + logf(l1);
    const int r0 = q0 + rl0, r1 = q0 + rl1;
    const long long row0 = static_cast<long long>(bh) * p.Lq + r0;
    if (p.splits == 1) {
      __nv_bfloat16* ob = p.out + b * p.os[0] + h * p.os[1] + 256 * cw;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * t;
        if (r0 < p.Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + r0 * p.os[2] + col) =
              __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (r1 < p.Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + r1 * p.os[2] + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      if (cw == 0 && t == 0) {
        if (r0 < p.Lq) p.lse[row0] = lse0;
        if (r1 < p.Lq) p.lse[row0 + 8] = lse1;
      }
    } else {
      float* wo = p.work + (split * p.rows + row0) * DP + 256 * cw;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * t;
        if (r0 < p.Lq)
          *reinterpret_cast<float2*>(wo + col) =
              make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (r1 < p.Lq)
          *reinterpret_cast<float2*>(wo + 8 * DP + col) =
              make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      if (cw == 0 && t == 0) {
        float* wl = p.work + p.splits * p.rows * DP + split * p.rows;
        if (r0 < p.Lq) wl[row0] = lse0;
        if (r1 < p.Lq) wl[row0 + 8] = lse1;
      }
    }
  }
}

// The key splits of one row, merged by their lse: out = sum_s w_s O_s with
// w_s = exp(lse_s - lse), lse = log sum_s exp(lse_s). One block of 64
// threads per row, 8 columns a thread.
__global__ void __launch_bounds__(64)
merge_d512_kernel(const float* __restrict__ work,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int H, int Lq, int splits, long long rows, long long os0,
                  long long os1, long long os2) {
  const long long row = blockIdx.x;
  const int bh = static_cast<int>(row / Lq), r = static_cast<int>(row % Lq);
  const int b = bh / H, h = bh % H;
  const float* wl = work + splits * rows * DP;
  float ls[kMaxSplits], mx = kNegInf;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    ls[s] = s < splits ? wl[s * rows + row] : kNegInf;
    mx = fmaxf(mx, ls[s]);
  }
  float w[kMaxSplits], tot = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    w[s] = ls[s] <= kNegInf ? 0.f : expf(ls[s] - mx);  // selected, not exp'd
    tot += w[s];
  }
  const float inv = tot == 0.f ? 0.f : 1.f / tot;
  const int col = 8 * threadIdx.x;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s >= splits) break;
    const float4* src =
        reinterpret_cast<const float4*>(work + (s * rows + row) * DP + col);
    const float4 a = src[0], c = src[1];
    const float ws = w[s] * inv;
    acc[0] += ws * a.x;
    acc[1] += ws * a.y;
    acc[2] += ws * a.z;
    acc[3] += ws * a.w;
    acc[4] += ws * c.x;
    acc[5] += ws * c.y;
    acc[6] += ws * c.z;
    acc[7] += ws * c.w;
  }
  __nv_bfloat16* ob = out + b * os0 + h * os1 + r * os2 + col;
#pragma unroll
  for (int i = 0; i < 8; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(ob + i) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  if (threadIdx.x == 0) lse[row] = tot == 0.f ? kNegInf : mx + logf(tot);
}

}  // namespace

// strides: the 12 (batch, head, seq) element strides of q, k, v and out (the
// head-dim stride is 1); lse is (B, H, Lq) contiguous fp32. splits (1 to 4)
// key splits per query tile; with more than one, `work` is fp32 scratch of
// splits * B * H * Lq * 513 values. Returns cudaErrorInvalidValue for a
// split count outside that range or without its scratch.
extern "C" int fdsd_flash_fwd_d512(const void* q, const void* k, const void* v,
                                   void* out, void* lse, void* work, int B,
                                   int H, int Lq, int Lk,
                                   const long long* strides, float scale,
                                   int splits, void* stream) {
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.work = static_cast<float*>(work);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.n_qt = (Lq + kBQ - 1) / kBQ;
  p.splits = splits;
  const int n_kt = (Lk + kBK - 1) / kBK;
  p.kt_per_split = (n_kt + splits - 1) / splits;
  p.rows = static_cast<long long>(B) * H * Lq;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.scale = scale;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv;
  cudaError_t err = s9::make_map(&tq, q, DP, Lq, H, B, strides, W, kBQ, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tk, k, DP, Lk, H, B, strides + 3, W, kBK, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tv, v, DP, Lk, H, B, strides + 6, W, kBK, sw);
  if (err == cudaSuccess)
    err = s9::launch_kernel(flash_fwd_d512_kernel, B * H * p.n_qt * splits,
                            kThreads, kSmemBytes, s, tq, tk, tv, p);
  if (err == cudaSuccess && splits > 1) {
    merge_d512_kernel<<<static_cast<unsigned>(p.rows), DP / 8, 0, s>>>(
        p.work, p.out, p.lse, H, Lq, splits, p.rows, p.os[0], p.os[1],
        p.os[2]);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
