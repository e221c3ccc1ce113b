// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_wide
//     (single pass over the whole K/V of one (b, h); SD1 UNet at 64^2,
//     q/k/v (2B, 8, 4096, 40); tiny-SD UNet at 64^2, (B, 1, 4096, 128))
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel
//     (blocked online softmax; SD1 UNet at 32^2, (2B, 8, 1024, 80), the
//     VAE decoder's one-head mid attention, (B, 1, 4096, 512), and the
//     tiny-SD UNet at 32^2, (B, 1 or 2, 1024, 128))
// It computes what both compute (out in the input dtype, lse = m + log l in
// fp32), not their block structure: the TPU's sequential key-block grid axis
// becomes a loop inside the block, and one code path serves all head dims.
//
// What bounds it on the H100: at the path's shapes attention is compute
// bound (4096 keys: ~2,000 flop per byte of q, k, v and out), so the limits
// are tensor-core issue rate and the softmax's exponentials. This first version
// is the simple correct form: mma.sync m16n8k16 (bf16 -> fp32) with the
// logit tile S staged through shared memory, one block per (b*h, 64 queries)
// (32 at d=512). The head dim is zero-padded to a multiple of 16 in shared
// memory only (d=40 -> 48); device memory is never padded. d=128 keeps the
// 16 x 128 output tile of a warp in 64 fp32 accumulators and uses ~80 KB of
// dynamic shared memory. d=512 keeps its
// output accumulator split over 8 warps (4 column slices x 2 row groups) so
// that no thread holds more than 64 fp32 accumulators, and uses ~187 KB of
// dynamic shared memory. Small q tiles keep the grid large enough for 132
// SMs at CFG batch 1 (2*8*4096/64 = 1024 blocks at 64^2). Only the padded
// head dims of the SD1 and tiny-SD paths are instantiated (48, 80, 128,
// 512) and 64 (the SigLIP tower and the TinyVLM decoder, 12 heads of 64 over
// 576 and 584 tokens; T5-XXL, 64 heads of 64 over 512 tokens); others return
// cudaErrorInvalidValue.
//
// The masks of _fwd_kernel are template parameters beside the head dim, so
// the no-mask instantiations stay the code they were: CAUSAL (col <= row from
// index 0 on both sides; key tiles above the diagonal are not visited),
// HAS_BIAS (an additive bias read through its strides, added in fp32 after
// the scale) and HAS_SEG (segment ids: same-id pairs only; the loop runs over
// the key tiles [lo, hi] whose id range overlaps the query tile's, and skips
// a tile inside that range whose ids are disjoint). They compose, and are
// instantiated at head dims 64 and 128. In these forms a masked logit is
// *selected* to probability 0 (not exp(-1e30 - max)), so a row that sees no
// key gives out = 0 and lse = -1e30 where the Pallas online body gives the
// mean of the visited v.
// Later work: wgmma + TMA, softmax in registers, K/V double buffering.

#include "mask.cuh"
#include "mma.cuh"

namespace {

using fdsd::ld32;
using fdsd::load_bias;
using fdsd::MaskArgs;
using fdsd::mma16816;
using fdsd::seg_overlap;

constexpr float kNegInf = -1e30f;

// DP: head dim padded to 16; BQ x BK: query x key tile; WM row groups of 16
// queries x WN column slices = warps of the block.
template <int DP, int BQ, int BK, int WM, int WN>
struct Cfg {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kRowStride = DP + 8;  // bf16, Q and K rows
  static constexpr int kVtStride = BK + 8;   // bf16, V^T rows (one per dim)
  static constexpr int kPStride = BK + 8;    // bf16, P rows
  static constexpr int kSStride = BK + 4;    // fp32, S rows
  static constexpr int kSmemBytes =
      (BQ * kSStride + 3 * BQ) * 4 +
      (BQ * kRowStride + BK * kRowStride + DP * kVtStride + BQ * kPStride) * 2;
  static_assert(BQ == WM * 16, "one row group of 16 queries per WM");
  static_assert((BK / 8) % WN == 0 && (DP / 8) % WN == 0, "even warp split");
  static_assert(kThreads % BQ == 0 && 32 % (kThreads / BQ) == 0,
                "a row's softmax threads sit in one warp");
};

template <int DP, int BQ, int BK, int WM, int WN, bool CAUSAL, bool HAS_BIAS,
          bool HAS_SEG>
__global__ void __launch_bounds__(WM * WN * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int H, int Lq, int Lk, int d,
                 long long qsb, long long qsh, long long qsl,
                 long long ksb, long long ksh, long long ksl,
                 long long vsb, long long vsh, long long vsl,
                 long long osb, long long osh, long long osl, float scale,
                 const MaskArgs m) {
  using C = Cfg<DP, BQ, BK, WM, WN>;
  // any masked form: a masked logit is selected to probability 0
  constexpr bool kSelect = CAUSAL || HAS_BIAS || HAS_SEG;
  constexpr int NT = C::kThreads;
  constexpr int kVecs = DP / 8;            // 16-byte vectors per padded row
  constexpr int kSTiles = BK / 8 / WN;     // key n-tiles per warp (S)
  constexpr int kOTiles = DP / 8 / WN;     // head-dim n-tiles per warp (O)
  constexpr int TPR = NT / BQ;             // softmax threads per row
  constexpr int CPT = BK / TPR;            // softmax columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_s = reinterpret_cast<float*>(smem);
  float* m_s = s_s + BQ * C::kSStride;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(a_s + BQ);
  __nv_bfloat16* k_s = q_s + BQ * C::kRowStride;
  __nv_bfloat16* vt_s = k_s + BK * C::kRowStride;
  __nv_bfloat16* p_s = vt_s + DP * C::kVtStride;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int row0 = wm * 16;
  const int nvec = d / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  for (int i = tid; i < BQ * kVecs; i += NT) {
    const int r = i / kVecs, c = i % kVecs;
    uint4 val = zero;
    if (q0 + r < Lq && c < nvec)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * qsl + c * 8);
    *reinterpret_cast<uint4*>(q_s + r * C::kRowStride + c * 8) = val;
  }
  for (int i = tid; i < BQ; i += NT) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  float o[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // The key tiles this block visits: all of them; below the diagonal when
  // causal; the range whose segment ids overlap this query tile's.
  const int n_kt = (Lk + BK - 1) / BK;
  int kt_begin = 0, kt_end = n_kt;
  if (CAUSAL) kt_end = min(n_kt, (q0 + BQ - 1) / BK + 1);
  const int* q_bound = nullptr;
  const int* k_bounds = nullptr;
  int qid0 = -1, qid1 = -1;  // segment ids of this thread's two query rows
  if (HAS_SEG) {
    const int tile = b * gridDim.y + blockIdx.y;
    kt_begin = max(kt_begin, m.lo[tile]);
    kt_end = min(kt_end, m.hi[tile] + 1);
    q_bound = m.q_bounds + 2 * tile;
    k_bounds = m.kv_bounds + 2 * b * n_kt;
    const int* ids = m.q_ids + static_cast<long long>(b) * Lq;
    if (q0 + row0 + g < Lq) qid0 = ids[q0 + row0 + g];
    if (q0 + row0 + g + 8 < Lq) qid1 = ids[q0 + row0 + g + 8];
  }
  const int* kv_ids = HAS_SEG ? m.kv_ids + static_cast<long long>(b) * Lk
                              : nullptr;
  const long long bias_base = HAS_BIAS ? b * m.bs[0] + h * m.bs[1] : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    if (HAS_SEG && !seg_overlap(q_bound, k_bounds + 2 * kt)) continue;
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of k_s, vt_s, p_s are done
    for (int i = tid; i < BK * kVecs; i += NT) {
      const int r = i / kVecs, c = i % kVecs;
      uint4 kv = zero, vv = zero;
      if (k0 + r < Lk && c < nvec) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * ksl + c * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * vsl + c * 8);
      }
      *reinterpret_cast<uint4*>(k_s + r * C::kRowStride + c * 8) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(c * 8 + e) * C::kVtStride + r] = ve[e];
    }
    __syncthreads();

    // S = scale * Q K^T for this warp's 16 rows x kSTiles*8 keys.
    float sacc[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const __nv_bfloat16* qa = q_s + (row0 + g) * C::kRowStride + kk + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * C::kRowStride),
                             ld32(qa + 8), ld32(qa + 8 * C::kRowStride + 8)};
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        const int n0 = (wn * kSTiles + j) * 8;
        const __nv_bfloat16* kp = k_s + (n0 + g) * C::kRowStride + kk + 2 * t;
        const uint32_t bb[2] = {ld32(kp), ld32(kp + 8)};
        mma16816(sacc[j], a, bb);
      }
    }
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      const int col = (wn * kSTiles + j) * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + g + (e >= 2 ? 8 : 0);
        const int cc = col + (e & 1);
        float val = sacc[j][e] * scale;
        bool visible = k0 + cc < Lk;
        if (HAS_BIAS && visible && q0 + r < Lq)
          val += load_bias(m, bias_base, q0 + r, k0 + cc);
        if (CAUSAL) visible = visible && k0 + cc <= q0 + r;
        if (HAS_SEG && visible)
          visible = kv_ids[k0 + cc] == (e >= 2 ? qid1 : qid0);
        s_s[r * C::kSStride + cc] = visible ? val : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: TPR neighbouring lanes share one row.
    {
      const int r = tid / TPR, part = tid % TPR;
      const float* srow = s_s + r * C::kSStride + part * CPT;
      const float m_old = m_s[r];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CPT; ++c) mx = fmaxf(mx, srow[c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      __nv_bfloat16* prow = p_s + r * C::kPStride + part * CPT;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = (kSelect && srow[c] <= kNegInf)
                            ? 0.f
                            : __expf(srow[c] - m_new);
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();  // every lane of the row has read m_s[r]
      if (part == 0) {
        const float alpha = __expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = alpha * O + P V for this warp's 16 rows x kOTiles*8 dims.
    const float al0 = a_s[row0 + g], al1 = a_s[row0 + g + 8];
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      o[j][0] *= al0;
      o[j][1] *= al0;
      o[j][2] *= al1;
      o[j][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const __nv_bfloat16* pa = p_s + (row0 + g) * C::kPStride + kk + 2 * t;
      const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * C::kPStride),
                             ld32(pa + 8), ld32(pa + 8 * C::kPStride + 8)};
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        const int n0 = (wn * kOTiles + j) * 8;
        const __nv_bfloat16* vp = vt_s + (n0 + g) * C::kVtStride + kk + 2 * t;
        const uint32_t bb[2] = {ld32(vp), ld32(vp + 8)};
        mma16816(o[j], a, bb);
      }
    }
  }

  // l_s / m_s were last written before the final softmax barrier; a masked
  // form may have visited no tile at all.
  if (kSelect) __syncthreads();
  const int r0 = q0 + row0 + g, r1 = r0 + 8;
  const float l0 = l_s[row0 + g], l1 = l_s[row0 + g + 8];
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  __nv_bfloat16* ob = out + b * osb + h * osh;
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int col = (wn * kOTiles + j) * 8 + 2 * t;
    if (col < d) {
      if (r0 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * osl + col) =
            __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
      if (r1 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * osl + col) =
            __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
    }
  }
  if (wn == 0 && t == 0) {
    float* lb = lse + (long long)blockIdx.x * Lq;
    if (r0 < Lq) lb[r0] = m_s[row0 + g] + logf(l0 == 0.f ? 1.f : l0);
    if (r1 < Lq) lb[r1] = m_s[row0 + g + 8] + logf(l1 == 0.f ? 1.f : l1);
  }
}

template <int DP, int BQ, int BK, int WM, int WN, bool CAUSAL = false,
          bool HAS_BIAS = false, bool HAS_SEG = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int Lq, int Lk, int d,
                   const long long* st, float scale, const MaskArgs& m,
                   cudaStream_t stream) {
  using C = Cfg<DP, BQ, BK, WM, WN>;
  auto kernel = flash_fwd_kernel<DP, BQ, BK, WM, WN, CAUSAL, HAS_BIAS, HAS_SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Lq, Lk, d, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale, m);
  return cudaGetLastError();
}

// The masked forms at one head dim; code = 4*causal + 2*has_bias + has_seg.
template <int DP>
cudaError_t launch_masked(int code, const void* q, const void* k,
                          const void* v, void* out, void* lse, int B, int H,
                          int Lq, int Lk, int d, const long long* st,
                          float scale, const MaskArgs& m, cudaStream_t s) {
  switch (code) {
#define FDSD_FORM(CODE, C, BI, SE)                                          \
  case CODE:                                                                \
    return launch<DP, 64, 64, 4, 1, C, BI, SE>(q, k, v, out, lse, B, H, Lq, \
                                               Lk, d, st, scale, m, s);
    FDSD_FORM(1, false, false, true)
    FDSD_FORM(2, false, true, false)
    FDSD_FORM(3, false, true, true)
    FDSD_FORM(4, true, false, false)
    FDSD_FORM(5, true, false, true)
    FDSD_FORM(6, true, true, false)
    FDSD_FORM(7, true, true, true)
#undef FDSD_FORM
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 16 element strides, (batch, head, seq) for q, k, v, out, then
// (batch, head, row, col) for the bias; the head-dim stride is 1. lse is
// (B, H, Lq) contiguous fp32. bias (fp32, or bf16 when bias_bf16) and the six
// segment arrays of mask.cuh are null when the form is not asked for; the
// masked forms take head dims 64 and 128.
extern "C" int fdsd_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, const void* bias,
                              const void* q_ids, const void* kv_ids,
                              const void* q_bounds, const void* kv_bounds,
                              const void* lo, const void* hi, int B, int H,
                              int Lq, int Lk, int d, const long long* strides,
                              float scale, int causal, int bias_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (d + 15) / 16 * 16;
  const MaskArgs m = fdsd::make_mask_args(bias, strides + 12, bias_bf16,
                                          q_ids, kv_ids, q_bounds, kv_bounds,
                                          lo, hi);
  const int code = 4 * (causal != 0) + 2 * (bias != nullptr) +
                   (q_ids != nullptr);
  if (code != 0) {
    if (d == 64)
      return static_cast<int>(launch_masked<64>(code, q, k, v, out, lse, B, H,
                                                Lq, Lk, d, strides, scale, m,
                                                s));
    if (d == 128)
      return static_cast<int>(launch_masked<128>(code, q, k, v, out, lse, B,
                                                 H, Lq, Lk, d, strides, scale,
                                                 m, s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (dp) {
#define FDSD_SMALL_D(DP)                                                    \
  case DP:                                                                  \
    err = launch<DP, 64, 64, 4, 1>(q, k, v, out, lse, B, H, Lq, Lk, d,      \
                                   strides, scale, m, s);                   \
    break;
    FDSD_SMALL_D(48)  // SD1 UNet at 64^2: d = 40
    FDSD_SMALL_D(64)  // SigLIP tower: d = 64
    FDSD_SMALL_D(80)  // SD1 UNet at 32^2: d = 80
    FDSD_SMALL_D(128)  // tiny-SD UNet: d = 128
#undef FDSD_SMALL_D
    case 512:  // SD1 VAE mid attention
      err = launch<512, 32, 64, 2, 4>(q, k, v, out, lse, B, H, Lq, Lk, d,
                                      strides, scale, m, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
