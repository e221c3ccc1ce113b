// Flash-attention backward dq (K3) for Hopper (sm_90a): bf16 in and out,
// fp32 softmax reconstruction and accumulators. flash_bwd_dq_kernel replaces
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel
// in every form of its: ragged Lq and Lk, and as template parameters beside
// the head dim (so the no-mask instantiations stay the code they were)
// CAUSAL (col <= row from index 0 on both sides), HAS_BIAS (an additive bias
// read through its strides, added in fp32 after the scale) and HAS_SEG
// (segment ids: same-id pairs only). Key tiles with no visible pair are not
// visited: the loop stops at the diagonal when causal, and with segment ids
// runs over the key tiles [lo, hi] whose id range overlaps this block's and
// skips a disjoint tile inside it. With a bias that needs a gradient it also
// writes dbias = dS, fp32 (B, H, Lq, Lk): every tile exactly once, zeros
// where the tile is skipped, so the caller reduces it over the bias's
// broadcast axes without a memset. It recomputes the probabilities under the
// forward's saved lse, P = exp(scale*QK^T + bias - lse), selected to 0 where
// the mask hides the key (never multiplied: a row that saw no key has
// lse = -1e30), with delta = rowsum(dO * out) computed beforehand (fp32, by
// the caller): dS = P * (dO V^T - delta), dQ = scale * dS K. The TPU's
// sequential key-block grid axis becomes a loop inside the block. dk and dv
// (K4) are the TMA / wgmma kernel of flash_attention_bwd_sm90.cu.
//
// What bounds it on the H100: at the tiny-SD shapes (B*H = 32, L = 4096,
// d = 128) it does 3 L^2*d products per (b, h), thousands of flop per byte
// of q, k, v and dO: compute bound, so the limits are tensor-core issue rate
// and the exponentials. This first version is the simple correct form:
// mma.sync m16n8k16 (bf16 -> fp32), operands staged through shared memory,
// and K, which the dS K product needs along the other axis, kept as a
// transposed copy in shared memory (no ldmatrix), loaded row-fastest so that
// the transposed 2-byte stores of a warp fall on consecutive addresses.
//
// Register budget, the design's main constraint at d = 128: one block per
// (b*h, 64 queries), 4 warps of 16 query rows; 32-key tiles keep S and dP at
// 16 fp32 registers each beside the 64 of the 16 x 128 dQ accumulator. dS
// goes from the accumulators straight into the A operand of the dS K product.
// Head dims 128 (tiny-SD) and 64 (SigLIP tower, TinyVLM decoder, T5) are
// instantiated, each in the eight forms; others return cudaErrorInvalidValue.
// Later work: wgmma + TMA as K4 has, ldmatrix.trans instead of the
// transposed copy, one fused kernel with atomics for dq.

#include "mask.cuh"
#include "mma.cuh"

namespace {

using fdsd::ld32;
using fdsd::load_bias;
using fdsd::MaskArgs;
using fdsd::mma16816;
using fdsd::pack_bf16;
using fdsd::seg_overlap;

constexpr float kNegInf = -1e30f;
constexpr float kPadLse = 1e30f;  // padded query rows: P = exp(s - 1e30) = 0

// A fragment (rows r0..r0+15, k kk..kk+15) of a row-major bf16 tile.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* s,
                                       int stride, int r0, int kk, int g,
                                       int t) {
  const __nv_bfloat16* p = s + (r0 + g) * stride + kk + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// B fragment (k kk..kk+15, n n0..n0+7) from a tile stored with one row per
// n and k contiguous.
__device__ __forceinline__ void load_b(uint32_t* b, const __nv_bfloat16* s,
                                       int stride, int n0, int kk, int g,
                                       int t) {
  const __nv_bfloat16* p = s + (n0 + g) * stride + kk + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// Copies rows [r0, r0+R) of a (len x d) strided bf16 matrix into a
// row-major smem tile (zero beyond len and d) and, if tr is set, its
// transpose (one smem row per head dim). With a transposed copy the row
// index runs fastest across threads, so that a warp's transposed stores hit
// consecutive addresses; without one the 16-byte vectors of a row do, so
// that a warp's global loads are contiguous.
template <int R, int DP, int NT>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src,
                                          long long sl, int r0, int len,
                                          int d, __nv_bfloat16* rows,
                                          int rstride, __nv_bfloat16* tr,
                                          int tstride) {
  constexpr int kVecs = DP / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < R * kVecs; i += NT) {
    const int r = tr != nullptr ? i % R : i / kVecs;
    const int c = tr != nullptr ? i / R : i % kVecs;
    uint4 val = zero;
    if (r0 + r < len && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * sl + c * 8);
    *reinterpret_cast<uint4*>(rows + r * rstride + c * 8) = val;
    if (tr != nullptr) {
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) tr[(c * 8 + e) * tstride + r] = e8[e];
    }
  }
}

// ---------------------------------------------------------------- K3: dq
template <int DP, int BQ, int BK>
struct DqCfg {
  static constexpr int kWarps = BQ / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRow = DP + 8;  // bf16 row stride: Q, dO, K, V
  static constexpr int kKt = BK + 8;   // bf16 row stride: K^T
  static constexpr int kSmemBytes =
      (2 * BQ * kRow + 2 * BK * kRow + DP * kKt) * 2;
};

template <int DP, int BQ, int BK, bool CAUSAL, bool HAS_BIAS, bool HAS_SEG>
__global__ void __launch_bounds__(DqCfg<DP, BQ, BK>::kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
                    int d, long long qsb, long long qsh, long long qsl,
                    long long ksb, long long ksh, long long ksl,
                    long long vsb, long long vsh, long long vsl,
                    long long gsb, long long gsh, long long gsl,
                    long long dsb, long long dsh, long long dsl, float scale,
                    float* __restrict__ dbias, const MaskArgs m) {
  using C = DqCfg<DP, BQ, BK>;
  constexpr int NT = C::kThreads;
  constexpr int kSTiles = BK / 8;  // key n-tiles of S and dP per warp
  constexpr int kDTiles = DP / 8;  // head-dim n-tiles of dQ per warp

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* g_s = q_s + BQ * C::kRow;
  __nv_bfloat16* k_s = g_s + BQ * C::kRow;
  __nv_bfloat16* v_s = k_s + BK * C::kRow;
  __nv_bfloat16* kt_s = v_s + BK * C::kRow;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int r0 = q0 + row0 + g, r1 = r0 + 8;

  load_tile<BQ, DP, NT>(q + b * qsb + h * qsh, qsl, q0, Lq, d, q_s, C::kRow,
                        nullptr, 0);
  load_tile<BQ, DP, NT>(dout + b * gsb + h * gsh, gsl, q0, Lq, d, g_s,
                        C::kRow, nullptr, 0);
  const float* lse_b = lse + (long long)blockIdx.x * Lq;
  const float* dl_b = delta + (long long)blockIdx.x * Lq;
  const float lse0 = r0 < Lq ? lse_b[r0] : kPadLse;
  const float lse1 = r1 < Lq ? lse_b[r1] : kPadLse;
  const float dl0 = r0 < Lq ? dl_b[r0] : 0.f;
  const float dl1 = r1 < Lq ? dl_b[r1] : 0.f;

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;
  // The key tiles with a visible pair: all of them; up to the diagonal when
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
    if (r0 < Lq) qid0 = ids[r0];
    if (r1 < Lq) qid1 = ids[r1];
  }
  const int* kv_ids = HAS_SEG ? m.kv_ids + static_cast<long long>(b) * Lk
                              : nullptr;
  const long long bias_base = HAS_BIAS ? b * m.bs[0] + h * m.bs[1] : 0;
  // dbias: every tile of this block's rows is written, skipped ones as zeros.
  const bool write_db = HAS_BIAS && dbias != nullptr;
  float* db = write_db
                  ? dbias + static_cast<long long>(blockIdx.x) * Lq * Lk
                  : nullptr;
  const int kt_first = write_db ? 0 : kt_begin;
  const int kt_last = write_db ? n_kt : kt_end;

  for (int kt = kt_first; kt < kt_last; ++kt) {
    const int k0 = kt * BK;
    bool run = kt >= kt_begin && kt < kt_end;
    if (HAS_SEG && run) run = seg_overlap(q_bound, k_bounds + 2 * kt);
    if (!run) {
      if (write_db)
        for (int i = threadIdx.x; i < BQ * BK; i += NT) {
          const int r = q0 + i / BK, c = k0 + i % BK;
          if (r < Lq && c < Lk) db[static_cast<long long>(r) * Lk + c] = 0.f;
        }
      continue;
    }
    __syncthreads();  // the previous tile's readers of k_s, v_s, kt_s are done
    load_tile<BK, DP, NT>(kb, ksl, k0, Lk, d, k_s, C::kRow, kt_s, C::kKt);
    load_tile<BK, DP, NT>(vb, vsl, k0, Lk, d, v_s, C::kRow, nullptr, 0);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BK keys.
    float s[kSTiles][4], dp[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t aq[4], ag[4];
      load_a(aq, q_s, C::kRow, row0, kk, g, t);
      load_a(ag, g_s, C::kRow, row0, kk, g, t);
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        uint32_t bk[2], bv[2];
        load_b(bk, k_s, C::kRow, j * 8, kk, g, t);
        load_b(bv, v_s, C::kRow, j * 8, kk, g, t);
        mma16816(s[j], aq, bk);
        mma16816(dp[j], ag, bv);
      }
    }
    // dS = P * (dP - delta), P = exp(scale * S + bias - lse), zero past Lk
    // and where the mask hides the key.
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const float l = e < 2 ? lse0 : lse1;
        const float dl = e < 2 ? dl0 : dl1;
        float sv = s[j][e] * scale;
        bool visible = col < Lk;
        if (HAS_BIAS && visible && row < Lq) {
          sv += load_bias(m, bias_base, row, col);
          visible = sv > kNegInf;
        }
        if (CAUSAL) visible = visible && col <= row;
        if (HAS_SEG && visible) visible = kv_ids[col] == (e < 2 ? qid0 : qid1);
        const float p = visible ? __expf(sv - l) : 0.f;
        s[j][e] = p * (dp[j][e] - dl);
        if (HAS_BIAS && write_db && row < Lq && col < Lk)
          db[static_cast<long long>(row) * Lk + col] = s[j][e];
      }
    }
    // dQ += dS K: dS is the A operand straight from the accumulators.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        uint32_t bb[2];
        load_b(bb, kt_s, C::kKt, j * 8, kk * 16, g, t);
        mma16816(acc[j], a, bb);
      }
    }
  }

  __nv_bfloat16* ob = dq + b * dsb + h * dsh;
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    const int col = j * 8 + 2 * t;
    if (col < d) {
      if (r0 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * dsl + col) =
            __floats2bfloat162_rn(acc[j][0] * scale, acc[j][1] * scale);
      if (r1 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * dsl + col) =
            __floats2bfloat162_rn(acc[j][2] * scale, acc[j][3] * scale);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DP, bool CAUSAL, bool HAS_BIAS, bool HAS_SEG>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dq, void* dbias, int B, int H, int Lq, int Lk,
                      int d, const long long* st, float scale,
                      const MaskArgs& m, cudaStream_t stream) {
  constexpr int BQ = 64, BK = 32;
  using C = DqCfg<DP, BQ, BK>;
  auto kernel = flash_bwd_dq_kernel<DP, BQ, BK, CAUSAL, HAS_BIAS, HAS_SEG>;
  cudaError_t err = set_smem(kernel, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, Lq, Lk, d, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], st[14], scale, static_cast<float*>(dbias), m);
  return cudaGetLastError();
}

// Calls LAUNCH<DP, causal, has_bias, has_seg>(ARGS) for the form `code` =
// 4*causal + 2*has_bias + has_seg.
#define FDSD_FORMS(LAUNCH, DP, code, ...)                          \
  switch (code) {                                                  \
    case 0: return LAUNCH<DP, false, false, false>(__VA_ARGS__);   \
    case 1: return LAUNCH<DP, false, false, true>(__VA_ARGS__);    \
    case 2: return LAUNCH<DP, false, true, false>(__VA_ARGS__);    \
    case 3: return LAUNCH<DP, false, true, true>(__VA_ARGS__);     \
    case 4: return LAUNCH<DP, true, false, false>(__VA_ARGS__);    \
    case 5: return LAUNCH<DP, true, false, true>(__VA_ARGS__);     \
    case 6: return LAUNCH<DP, true, true, false>(__VA_ARGS__);     \
    default: return LAUNCH<DP, true, true, true>(__VA_ARGS__);     \
  }

template <int DP>
cudaError_t dispatch_dq(int code, const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* dq, void* dbias, int B, int H, int Lq, int Lk,
                        int d, const long long* st, float scale,
                        const MaskArgs& m, cudaStream_t s) {
  FDSD_FORMS(launch_dq, DP, code, q, k, v, g, lse, delta, dq, dbias, B, H, Lq,
             Lk, d, st, scale, m, s)
}

}  // namespace

// strides: (batch, head, seq) element strides of q, k, v, dO, dq, then
// (batch, head, row, col) of the bias (19 values); the head-dim stride is 1.
// lse and delta are (B, H, Lq) contiguous fp32. bias (fp32, or bf16 when
// bias_bf16), dbias (fp32 (B, H, Lq, Lk) contiguous, only with a bias) and
// the six segment arrays of mask.cuh are null when not asked for.
extern "C" int fdsd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dq, void* dbias,
                                 const void* bias, const void* q_ids,
                                 const void* kv_ids, const void* q_bounds,
                                 const void* kv_bounds, const void* lo,
                                 const void* hi, int B, int H, int Lq, int Lk,
                                 int d, const long long* strides, float scale,
                                 int causal, int bias_bf16, void* stream) {
  const MaskArgs m = fdsd::make_mask_args(bias, strides + 15, bias_bf16,
                                          q_ids, kv_ids, q_bounds, kv_bounds,
                                          lo, hi);
  const int code = 4 * (causal != 0) + 2 * (bias != nullptr) +
                   (q_ids != nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return static_cast<int>(dispatch_dq<64>(code, q, k, v, g, lse, delta, dq,
                                            dbias, B, H, Lq, Lk, d, strides,
                                            scale, m, s));
  if (d == 128)
    return static_cast<int>(dispatch_dq<128>(code, q, k, v, g, lse, delta, dq,
                                             dbias, B, H, Lq, Lk, d, strides,
                                             scale, m, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
