// Flash-attention forward on fp32 inputs for Hopper (sm_90a): the fp32 form
// of K1 (plain and causal) and of K5 (position masks, online and bounded).
//
// Replaces, for fp32 q, k, v, the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_wide
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_pos
// which ask for Precision.HIGHEST on every dot when the inputs are fp32. Here
// Q K^T and P V are fp32 FMAs on the CUDA cores (flash_f32.cuh); P is never
// rounded; out and lse are fp32. Same output contract as the bf16 kernels:
// lse = max + log(sum) of the scaled logits, a row that sees no key gives
// out = 0 and lse = -1e30.
//
// What bounds it on the H100: operations, at the fp32 rate of the CUDA cores
// (67 TFLOP/s), 15 times below the bf16 tensor-core rate; at 4096 keys and
// d = 64 it does ~1,000 flop per byte moved. One block of 256 threads takes
// 64 queries (32 at d = 512) of one (b, h) and walks the key tiles; each
// thread holds a 4 x 4 tile of S in registers, where the online softmax runs
// (row max and sum by shuffles over the 16 lanes of a row), then P goes
// through shared memory once as the left operand of P V. d = 128 takes key
// tiles of 32 so that two blocks share an SM; d = 512 (the VAE's one-head
// attention) holds 32 x 512 Q, and 32 x 512 K and V tiles, 203 KB, with the
// 32 x 512 output tile as 64 accumulators a thread.
// Later work: a split into bf16 or TF32 terms on the tensor cores.

#include "flash_f32.cuh"

namespace {

using namespace fdsd32;

template <int DP, int BQ, int BK, bool MASKED, bool BOUNDED>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const Params p) {
  constexpr int RM = BQ / 16, RN = BK / 16, DPT = DP / 16;
  constexpr int kStride = DP + 4, kPStride = BK + 4;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + BQ * kStride;
  float* v_s = k_s + BK * kStride;
  float* p_s = v_s + BK * kStride;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const Mask<MASKED> mask(p);

  const float* kb = p.k + b * p.ks[0] + h * p.ks[1];
  const float* vb = p.v + b * p.vs[0] + h * p.vs[1];
  load_tile<DP, BQ>(q_s, p.q + b * p.qs[0] + h * p.qs[1], p.qs[2], q0, p.Lq,
                    p.d, tid);

  int rpos[RM];
  float m[RM], l[RM], o[RM][DPT];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    rpos[i] = mask.row_pos(p, q0 + ty + 16 * i);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) o[i][c] = 0.f;
  }

  const int n_kt = (p.Lk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (mask.skip(p, q0, BQ, k0, BK)) continue;
    __syncthreads();  // the previous tile's readers of k_s, v_s, p_s are done
    load_tile<DP, BK>(k_s, kb, p.ks[2], k0, p.Lk, p.d, tid);
    load_tile<DP, BK>(v_s, vb, p.vs[2], k0, p.Lk, p.d, tid);
    __syncthreads();

    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
    dot_tiles<RM, RN, DP>(s, q_s, k_s, ty, tx);

    // Softmax in registers: a row's 16 lanes hold its BK logits.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      bool vis[RN];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        vis[j] = mask.sees(p, rpos[i], k0 + tx + 16 * j);
        s[i][j] *= p.scale;
        if (vis[j]) mx = fmaxf(mx, s[i][j]);
      }
      float mu = 0.f;
      if (!BOUNDED) {
        const float m_new = fmaxf(m[i], row_max(mx));
        // a row with nothing visible so far keeps every P at 0
        mu = m_new == kNegInf ? 0.f : m_new;
        const float alpha = expf(m[i] - mu);
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int c = 0; c < DPT; ++c) o[i][c] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float pr = vis[j] ? expf(s[i][j] - mu) : 0.f;
        l[i] += pr;
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = pr;
      }
    }
    __syncthreads();
    accum_tiles<RM, DP, BK, kPStride>(o, p_s, v_s, ty, tx);
  }

  float* lb = p.lse + static_cast<long long>(blockIdx.x) * p.Lq;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float sum = row_sum(l[i]);
    const float inv = sum == 0.f ? 0.f : 1.f / sum;
#pragma unroll
    for (int c = 0; c < DPT; ++c) o[i][c] *= inv;
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < p.Lq)
      lb[r] = sum == 0.f ? kNegInf : (BOUNDED ? 0.f : m[i]) + logf(sum);
  }
  store_tiles<RM, DP>(o, p.o0 + b * p.o0s[0] + h * p.o0s[1], p.o0s[2], q0,
                      p.Lq, p.d, 1.f, ty, tx);
}

template <int DP, int BQ, int BK, bool MASKED, bool BOUNDED = false>
cudaError_t run(const Params& p, int B, cudaStream_t s) {
  constexpr int kSmem = ((BQ + 2 * BK) * (DP + 4) + BQ * (BK + 4)) * 4;
  return launch(flash_fwd_f32_kernel<DP, BQ, BK, MASKED, BOUNDED>, kSmem, p, B,
                p.Lq, BQ, s);
}

Params fwd_params(const void* q, const void* k, const void* v, void* out,
                  void* lse, int H, int Lq, int Lk, int d,
                  const long long* strides, float scale) {
  Params p = make_params(q, k, v, H, Lq, Lk, d, scale);
  p.o0 = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  set_strides(p.qs, strides);
  set_strides(p.ks, strides + 3);
  set_strides(p.vs, strides + 6);
  set_strides(p.o0s, strides + 9);
  return p;
}

}  // namespace

// K1 in fp32. strides: 12 element strides, (batch, head, seq) for q, k, v,
// out, each a multiple of 4; the head-dim stride is 1. lse is (B, H, Lq)
// contiguous fp32. Head dims 40, 48, 64, 80, 128 and 512 without a mask, 64
// with causal.
extern "C" int fdsd_flash_fwd_f32(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int H, int Lq,
                                  int Lk, int d, const long long* strides,
                                  float scale, int causal, void* stream) {
  Params p = fwd_params(q, k, v, out, lse, H, Lq, Lk, d, strides, scale);
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (causal)
    return static_cast<int>(d == 64 ? run<64, 64, 64, true>(p, B, s)
                                    : cudaErrorInvalidValue);
  switch ((d + 15) / 16 * 16) {
    case 48:
      return static_cast<int>(run<48, 64, 64, false>(p, B, s));
    case 64:
      return static_cast<int>(run<64, 64, 64, false>(p, B, s));
    case 80:
      return static_cast<int>(run<80, 64, 64, false>(p, B, s));
    case 128:
      return static_cast<int>(run<128, 64, 32, false>(p, B, s));
    case 512:
      return static_cast<int>(run<512, 32, 32, false>(p, B, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5 in fp32: the arguments of fdsd_flash_fwd_pos on fp32 tensors. Head dim
// 64.
extern "C" int fdsd_flash_fwd_pos_f32(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      const void* q_off, const void* k_off,
                                      int B, int H, int Lq, int Lk, int d,
                                      const long long* strides, float scale,
                                      int seg_q, int seg_k, int valid_len,
                                      int has_valid, int causal, int bounded,
                                      void* stream) {
  Params p = fwd_params(q, k, v, out, lse, H, Lq, Lk, d, strides, scale);
  set_pos(p, q_off, k_off, seg_q, seg_k, valid_len, has_valid, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bounded ? run<64, 64, 64, true, true>(p, B, s)
                                  : run<64, 64, 64, true, false>(p, B, s));
}
