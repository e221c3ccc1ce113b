// The C entries of K4 and K7 (bf16, every head dim up to 512):
// the kernels of flash_attention_bwd_sm90.cuh up to 256, their widths
// instantiated in flash_attention_bwd_sm90_w*.cu; above 256 K4 and K7 are
// the kernel of flash_attention_wide_bwd_sm90.cuh.

#include "flash_attention_bwd_sm90.cuh"
#include "flash_attention_wide_bwd_sm90.cuh"

using namespace fdsd::k4;

// strides: (batch, head, seq) element strides of q, k, v, dO, dk, dv, then
// (batch, head, row, col) of the bias (22 values); the head-dim stride is 1.
// lse and delta are (B, H, Lq) contiguous fp32. bias (fp32, or bf16 when
// bias_bf16) and the six segment arrays of mask.cuh (at (64, 128) tiles up
// to DP = 128, (64, 64) above) are null when not asked for. Every head dim
// from 1 to 256, in every form, at the padded width DP of padded_width (the
// columns past d read as zeros); from 264 to 512 (multiples of 8), in every
// form, the wide kernel (segment arrays at (32, 64) tiles); others return
// cudaErrorInvalidValue.
extern "C" int fdsd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* g, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  const void* bias, const void* q_ids,
                                  const void* kv_ids, const void* q_bounds,
                                  const void* kv_bounds, const void* lo,
                                  const void* hi, int B, int H, int Lq, int Lk,
                                  int d, const long long* strides, float scale,
                                  int causal, int bias_bf16, void* stream) {
  if (d > 256)
    return static_cast<int>(fdsd::kw::launch_wide(
        1, q, k, v, g, dk, dv, nullptr, lse, delta, bias, bias_bf16, q_ids,
        kv_ids, q_bounds, kv_bounds, lo, hi, B, H, Lq, Lk, d, strides, scale,
        fdsd::PosArgs{nullptr, nullptr, Lq, Lk, 0, 0, causal != 0},
        static_cast<cudaStream_t>(stream)));
  Params p;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.causal = causal != 0;
  for (int i = 0; i < 3; ++i) {
    p.dks[i] = strides[12 + i];
    p.dvs[i] = strides[15 + i];
  }
  p.scale = scale;
  p.m = fdsd::make_mask_args(bias, strides + 18, bias_bf16, q_ids, kv_ids,
                             q_bounds, kv_bounds, lo, hi);
  p.pos = fdsd::PosArgs{};
  const int code = 4 * (causal != 0) + 2 * (bias != nullptr) +
                   (q_ids != nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d < 1 || d > 256) return static_cast<int>(err);
  switch (padded_width(d)) {
#define FDSD_CASE(DP)                                             \
  case DP:                                                        \
    err = launch_width<DP>(code, q, k, v, g, B, strides, p, s);   \
    break;
    FDSD_K4_WIDTHS(FDSD_CASE)
#undef FDSD_CASE
  }
  return static_cast<int>(err);
}

// K7. strides: (batch, head, seq) element strides of q, k, v, dO, dk, dv (18
// values); the head-dim stride is 1. lse and delta are (B, H, Lq) contiguous
// fp32, the global ones; q_off and k_off are int32[2] in device memory.
// Every head dim from 1 to 256, at the padded width DP of padded_width;
// from 264 to 512 (multiples of 8) the wide kernel under the same masks, dk
// and dv in one cluster pair; others return cudaErrorInvalidValue.
extern "C" int fdsd_flash_bwd_pos_dkv(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dk, void* dv, const void* q_off,
    const void* k_off, int B, int H, int Lq, int Lk, int d,
    const long long* strides, float scale, int seg_q, int seg_k, int valid_len,
    int has_valid, int causal, void* stream) {
  const fdsd::PosArgs pos{static_cast<const int*>(q_off),
                          static_cast<const int*>(k_off), seg_q, seg_k,
                          valid_len, has_valid, causal};
  if (d > 256)
    return static_cast<int>(fdsd::kw::launch_wide(
        1, q, k, v, g, dk, dv, nullptr, lse, delta, nullptr, 0, nullptr,
        nullptr, nullptr, nullptr, nullptr, nullptr, B, H, Lq, Lk, d, strides,
        scale, pos, static_cast<cudaStream_t>(stream)));
  Params p = {};
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  for (int i = 0; i < 3; ++i) {
    p.dks[i] = strides[12 + i];
    p.dvs[i] = strides[15 + i];
  }
  p.scale = scale;
  p.pos = pos;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch (padded_width(d)) {
#define FDSD_CASE(DP)                                             \
  case DP:                                                        \
    err = launch_pos<DP>(q, k, v, g, B, strides, p, s);           \
    break;
    FDSD_K4_WIDTHS(FDSD_CASE)
#undef FDSD_CASE
  }
  return static_cast<int>(err);
}
