// Flash-attention backward on fp32 inputs for Hopper (sm_90a): the fp32 form
// of K3 (dq) and K4 (dk, dv), plain and causal, and of K6 / K7 (position
// masks under a caller-supplied global lse and delta).
//
// Replaces, for fp32 q, k, v, dO, the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel_pos
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel_pos
// which ask for Precision.HIGHEST on every dot when the inputs are fp32. All
// five products (Q K^T, dO V^T, dS K, P^T dO, dS^T Q) are fp32 FMAs on the
// CUDA cores (flash_f32.cuh); P = exp(scale Q K^T - lse) and
// dS = P (dO V^T - delta) stay fp32 and are selected to 0 where a mask hides
// the key; dq, dk and dv are fp32.
//
// What bounds them on the H100: operations, at the fp32 rate of the CUDA
// cores (67 TFLOP/s): dq does 6 Lq Lk d flop, dk/dv 8 Lq Lk d, on a few
// (L x d) matrices. The dq kernel takes 64 queries a block and walks the key
// tiles, the dk/dv kernel 64 keys a block and walks the query tiles; S and
// dO V^T are 4 x 4 register tiles a thread (4 x 2 at d = 128, where the
// walked tile is 32 long so that the shared tiles fit), dS (and P) go through
// shared memory once, transposed in the dk/dv kernel so that one
// accumulation routine serves all three output products.
// Later work: a split into bf16 or TF32 terms on the tensor cores.

#include "flash_f32.cuh"

namespace {

using namespace fdsd32;

// K3 / K6: dq for BQ queries of one (b, h).
template <int DP, int BQ, int BK, bool MASKED>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int RM = BQ / 16, RN = BK / 16, DPT = DP / 16;
  constexpr int kStride = DP + 4, kSStride = BK + 4;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* g_s = q_s + BQ * kStride;
  float* k_s = g_s + BQ * kStride;
  float* v_s = k_s + BK * kStride;
  float* ds_s = v_s + BK * kStride;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const Mask<MASKED> mask(p);

  const float* kb = p.k + b * p.ks[0] + h * p.ks[1];
  const float* vb = p.v + b * p.vs[0] + h * p.vs[1];
  load_tile<DP, BQ>(q_s, p.q + b * p.qs[0] + h * p.qs[1], p.qs[2], q0, p.Lq,
                    p.d, tid);
  load_tile<DP, BQ>(g_s, p.g + b * p.gs[0] + h * p.gs[1], p.gs[2], q0, p.Lq,
                    p.d, tid);

  const long long row_base = static_cast<long long>(blockIdx.x) * p.Lq;
  int rpos[RM];
  float lse[RM], delta[RM], dq[RM][DPT];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + 16 * i;
    rpos[i] = mask.row_pos(p, r);
    lse[i] = r < p.Lq ? p.lse_in[row_base + r] : 0.f;
    delta[i] = r < p.Lq ? p.delta[row_base + r] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) dq[i][c] = 0.f;
  }

  const int n_kt = (p.Lk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (mask.skip(p, q0, BQ, k0, BK)) continue;
    __syncthreads();  // the previous tile's readers of k_s, v_s, ds_s are done
    load_tile<DP, BK>(k_s, kb, p.ks[2], k0, p.Lk, p.d, tid);
    load_tile<DP, BK>(v_s, vb, p.vs[2], k0, p.Lk, p.d, tid);
    __syncthreads();

    float s[RM][RN], dp[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_tiles<RM, RN, DP>(s, q_s, k_s, ty, tx);
    dot_tiles<RM, RN, DP>(dp, g_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const bool vis = mask.sees(p, rpos[i], k0 + tx + 16 * j);
        const float pr = vis ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        ds_s[(ty + 16 * i) * kSStride + tx + 16 * j] =
            pr * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    accum_tiles<RM, DP, BK, kSStride>(dq, ds_s, k_s, ty, tx);
  }
  store_tiles<RM, DP>(dq, p.o0 + b * p.o0s[0] + h * p.o0s[1], p.o0s[2], q0,
                      p.Lq, p.d, p.scale, ty, tx);
}

// K4 / K7: dk and dv for BK keys of one (b, h). The logit tile is held
// transposed (keys along ty, queries along tx).
template <int DP, int BQ, int BK, bool MASKED>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int RM = BK / 16, RN = BQ / 16, DPT = DP / 16;
  constexpr int kStride = DP + 4, kTStride = BQ + 4;

  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + BK * kStride;
  float* q_s = v_s + BK * kStride;
  float* g_s = q_s + BQ * kStride;
  float* pt_s = g_s + BQ * kStride;
  float* dst_s = pt_s + BK * kTStride;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const Mask<MASKED> mask(p);

  const float* qb = p.q + b * p.qs[0] + h * p.qs[1];
  const float* gb = p.g + b * p.gs[0] + h * p.gs[1];
  load_tile<DP, BK>(k_s, p.k + b * p.ks[0] + h * p.ks[1], p.ks[2], k0, p.Lk,
                    p.d, tid);
  load_tile<DP, BK>(v_s, p.v + b * p.vs[0] + h * p.vs[1], p.vs[2], k0, p.Lk,
                    p.d, tid);

  const long long row_base = static_cast<long long>(blockIdx.x) * p.Lq;
  float dk[RM][DPT], dv[RM][DPT];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_qt = (p.Lq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    if (mask.skip(p, q0, BQ, k0, BK)) continue;
    __syncthreads();  // the previous tile's readers of q_s, g_s, pt_s, dst_s
    load_tile<DP, BQ>(q_s, qb, p.qs[2], q0, p.Lq, p.d, tid);
    load_tile<DP, BQ>(g_s, gb, p.gs[2], q0, p.Lq, p.d, tid);
    __syncthreads();

    float st[RM][RN], dpt[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) st[i][j] = dpt[i][j] = 0.f;
    dot_tiles<RM, RN, DP>(st, k_s, q_s, ty, tx);
    dot_tiles<RM, RN, DP>(dpt, v_s, g_s, ty, tx);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int r = q0 + tx + 16 * j;
      const bool row_ok = r < p.Lq;
      const int rp = mask.row_pos(p, r);
      const float lse = row_ok ? p.lse_in[row_base + r] : 0.f;
      const float delta = row_ok ? p.delta[row_base + r] : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const bool vis = row_ok && mask.sees(p, rp, k0 + ty + 16 * i);
        const float pr = vis ? expf(st[i][j] * p.scale - lse) : 0.f;
        pt_s[(ty + 16 * i) * kTStride + tx + 16 * j] = pr;
        dst_s[(ty + 16 * i) * kTStride + tx + 16 * j] =
            pr * (dpt[i][j] - delta);
      }
    }
    __syncthreads();
    accum_tiles<RM, DP, BQ, kTStride>(dv, pt_s, g_s, ty, tx);
    accum_tiles<RM, DP, BQ, kTStride>(dk, dst_s, q_s, ty, tx);
  }
  store_tiles<RM, DP>(dk, p.o0 + b * p.o0s[0] + h * p.o0s[1], p.o0s[2], k0,
                      p.Lk, p.d, p.scale, ty, tx);
  store_tiles<RM, DP>(dv, p.o1 + b * p.o1s[0] + h * p.o1s[1], p.o1s[2], k0,
                      p.Lk, p.d, 1.f, ty, tx);
}

template <int DP, int BQ, int BK, bool MASKED>
cudaError_t run_dq(const Params& p, int B, cudaStream_t s) {
  constexpr int kSmem = ((2 * BQ + 2 * BK) * (DP + 4) + BQ * (BK + 4)) * 4;
  return launch(flash_bwd_dq_f32_kernel<DP, BQ, BK, MASKED>, kSmem, p, B, p.Lq,
                BQ, s);
}

template <int DP, int BQ, int BK, bool MASKED>
cudaError_t run_dkv(const Params& p, int B, cudaStream_t s) {
  constexpr int kSmem = ((2 * BQ + 2 * BK) * (DP + 4) + 2 * BK * (BQ + 4)) * 4;
  return launch(flash_bwd_dkv_f32_kernel<DP, BQ, BK, MASKED>, kSmem, p, B,
                p.Lk, BK, s);
}

// strides: q, k, v, dO, then n_out outputs, three each.
Params bwd_params(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* delta, void* o0, void* o1,
                  int H, int Lq, int Lk, int d, const long long* strides,
                  float scale) {
  Params p = make_params(q, k, v, H, Lq, Lk, d, scale);
  p.g = static_cast<const float*>(g);
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.o0 = static_cast<float*>(o0);
  p.o1 = static_cast<float*>(o1);
  set_strides(p.qs, strides);
  set_strides(p.ks, strides + 3);
  set_strides(p.vs, strides + 6);
  set_strides(p.gs, strides + 9);
  set_strides(p.o0s, strides + 12);
  if (o1 != nullptr) set_strides(p.o1s, strides + 15);
  return p;
}

cudaError_t dispatch_dq(const Params& p, int B, bool masked, cudaStream_t s) {
  if (masked)
    return p.d == 64 ? run_dq<64, 64, 64, true>(p, B, s)
                     : cudaErrorInvalidValue;
  if (p.d == 64) return run_dq<64, 64, 64, false>(p, B, s);
  if (p.d == 128) return run_dq<128, 64, 32, false>(p, B, s);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_dkv(const Params& p, int B, bool masked, cudaStream_t s) {
  if (masked)
    return p.d == 64 ? run_dkv<64, 64, 64, true>(p, B, s)
                     : cudaErrorInvalidValue;
  if (p.d == 64) return run_dkv<64, 64, 64, false>(p, B, s);
  if (p.d == 128) return run_dkv<128, 32, 64, false>(p, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// K3 in fp32. strides: 15 element strides, (batch, head, seq) for q, k, v,
// dO, dq, each a multiple of 4; lse and delta are (B, H, Lq) contiguous fp32.
// Head dims 64 and 128 without a mask, 64 with causal.
extern "C" int fdsd_flash_bwd_dq_f32(const void* q, const void* k,
                                     const void* v, const void* g,
                                     const void* lse, const void* delta,
                                     void* dq, int B, int H, int Lq, int Lk,
                                     int d, const long long* strides,
                                     float scale, int causal, void* stream) {
  Params p = bwd_params(q, k, v, g, lse, delta, dq, nullptr, H, Lq, Lk, d,
                        strides, scale);
  p.causal = causal;
  return static_cast<int>(
      dispatch_dq(p, B, causal != 0, static_cast<cudaStream_t>(stream)));
}

// K4 in fp32. strides: 18 element strides, for q, k, v, dO, dk, dv.
extern "C" int fdsd_flash_bwd_dkv_f32(const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int B, int H, int Lq,
                                      int Lk, int d, const long long* strides,
                                      float scale, int causal, void* stream) {
  Params p = bwd_params(q, k, v, g, lse, delta, dk, dv, H, Lq, Lk, d, strides,
                        scale);
  p.causal = causal;
  return static_cast<int>(
      dispatch_dkv(p, B, causal != 0, static_cast<cudaStream_t>(stream)));
}

// K6 in fp32: the arguments of fdsd_flash_bwd_pos_dq on fp32 tensors. Head
// dim 64.
extern "C" int fdsd_flash_bwd_pos_dq_f32(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, const void* q_off,
    const void* k_off, int B, int H, int Lq, int Lk, int d,
    const long long* strides, float scale, int seg_q, int seg_k, int valid_len,
    int has_valid, int causal, void* stream) {
  Params p = bwd_params(q, k, v, g, lse, delta, dq, nullptr, H, Lq, Lk, d,
                        strides, scale);
  set_pos(p, q_off, k_off, seg_q, seg_k, valid_len, has_valid, causal);
  return static_cast<int>(
      dispatch_dq(p, B, true, static_cast<cudaStream_t>(stream)));
}

// K7 in fp32: the arguments of fdsd_flash_bwd_pos_dkv on fp32 tensors. Head
// dim 64.
extern "C" int fdsd_flash_bwd_pos_dkv_f32(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dk, void* dv, const void* q_off,
    const void* k_off, int B, int H, int Lq, int Lk, int d,
    const long long* strides, float scale, int seg_q, int seg_k, int valid_len,
    int has_valid, int causal, void* stream) {
  Params p = bwd_params(q, k, v, g, lse, delta, dk, dv, H, Lq, Lk, d, strides,
                        scale);
  set_pos(p, q_off, k_off, seg_q, seg_k, valid_len, has_valid, causal);
  return static_cast<int>(
      dispatch_dkv(p, B, true, static_cast<cudaStream_t>(stream)));
}
