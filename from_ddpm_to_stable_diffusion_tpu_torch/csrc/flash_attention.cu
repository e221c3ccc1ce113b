// Flash-attention forward at head dim 512 for Hopper (sm_90a), bf16 in,
// fp32 softmax: K1 for the VAE's one-head mid attention (SD1 decoder and
// encoder, (B, 1, 4096, 512); SD3 decoder, (1, 1, 16384, 512)). The other
// head dims and every mask form run on the TMA / wgmma kernel of
// flash_attention_sm90.cu, whose C entry fdsd_flash_fwd hands d = 512 here.
//
// Replaces, at d = 512, the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_wide
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel
// (no mask), computing what they compute (out in bf16, lse = m + log l in
// fp32) with the TPU's sequential key-block grid axis as a loop in the block.
//
// What bounds it on the H100: operations (4096 keys: ~2,000 flop per byte),
// so tensor-core issue rate and the exponentials. This form stays on
// mma.sync m16n8k16 with the logit tile S staged through shared memory, one
// block of 8 warps per (b*h, 32 queries): the output accumulator is split
// over 4 column slices x 2 row groups so that no thread holds more than 64
// fp32 accumulators, ~187 KB of dynamic shared memory. It reaches ~3 % of
// its bound; a 64 x 512 fp32 accumulator split across warpgroups is the
// wgmma design it still needs.

#include "mma.cuh"

namespace {

using fdsd::ld32;
using fdsd::mma16816;

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

template <int DP, int BQ, int BK, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int H, int Lq, int Lk, int d,
                 long long qsb, long long qsh, long long qsl,
                 long long ksb, long long ksh, long long ksl,
                 long long vsb, long long vsh, long long vsl,
                 long long osb, long long osh, long long osl, float scale) {
  using C = Cfg<DP, BQ, BK, WM, WN>;
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

  const int n_kt = (Lk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
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
        s_s[r * C::kSStride + cc] =
            k0 + cc < Lk ? sacc[j][e] * scale : kNegInf;
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
        const float p = __expf(srow[c] - m_new);
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

}  // namespace

namespace fdsd {

// strides: the 12 (batch, head, seq) element strides of q, k, v and out.
cudaError_t flash_fwd_d512(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int H, int Lq, int Lk,
                           const long long* st, float scale,
                           cudaStream_t stream) {
  constexpr int DP = 512, BQ = 32, BK = 64, WM = 2, WN = 4;
  using C = Cfg<DP, BQ, BK, WM, WN>;
  auto kernel = flash_fwd_kernel<DP, BQ, BK, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Lq, Lk, 512, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

}  // namespace fdsd
