// The C entries of K1 (bf16, every head dim up to 256) and K5 (bf16, every
// head dim up to 512), the kernels of flash_attention_sm90.cuh up to 256,
// their widths instantiated in flash_attention_sm90_w*.cu; above 256 K5 is
// the kernel of flash_attention.cu.

#include "flash_attention_sm90.cuh"

using namespace fdsd::k1;

namespace fdsd::d512 {
// K5 above head dim 256 (flash_attention.cu): the arguments of
// fdsd_flash_fwd_pos.
cudaError_t fwd_pos(const void* q, const void* k, const void* v, void* out,
                    void* lse, const void* q_off, const void* k_off,
                    void* work, int B, int H, int Lq, int Lk, int d,
                    const long long* strides, float scale, int seg_q,
                    int seg_k, int valid_len, int has_valid, int causal,
                    int bounded, int splits, cudaStream_t stream);
}  // namespace fdsd::d512

// strides: 16 element strides, (batch, head, seq) for q, k, v, out, then
// (batch, head, row, col) for the bias; the head-dim stride is 1. lse is
// (B, H, Lq) contiguous fp32. bias (fp32, or bf16 when bias_bf16) and the six
// segment arrays of mask.cuh are null when the form is not asked for. Every
// head dim from 1 to 256 runs here, in every form, at the padded width DP =
// d rounded up to 16 (the columns past d read as zeros); others (d = 512:
// fdsd_flash_fwd_d512) return cudaErrorInvalidValue.
extern "C" int fdsd_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, const void* bias,
                              const void* q_ids, const void* kv_ids,
                              const void* q_bounds, const void* kv_bounds,
                              const void* lo, const void* hi, int B, int H,
                              int Lq, int Lk, int d, const long long* strides,
                              float scale, int causal, int bias_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = 4 * (causal != 0) + 2 * (bias != nullptr) +
                   (q_ids != nullptr);
  Params p;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.n_qt = (Lq + kBQ - 1) / kBQ;
  p.causal = causal != 0;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.scale = scale;
  p.m = fdsd::make_mask_args(bias, strides + 12, bias_bf16, q_ids, kv_ids,
                             q_bounds, kv_bounds, lo, hi);
  if (d < 1 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch ((d + 15) / 16 * 16) {
#define FDSD_CASE(DP)                                          \
  case DP:                                                     \
    err = launch_width<DP>(code, q, k, v, B, strides, p, s);   \
    break;
    FDSD_K1_WIDTHS(FDSD_CASE)
#undef FDSD_CASE
  }
  return static_cast<int>(err);
}

// K5. strides: 12 element strides, (batch, head, seq) for q, k, v, out; the
// head-dim stride is 1. lse is (B, H, Lq) contiguous fp32. q_off and k_off
// are int32[2] in device memory. Every head dim from 1 to 256, at the padded
// width DP = d rounded up to 16 (the columns past d read as zeros and not
// written; work and splits unread); from 264 to 512 (multiples of 8) the
// kernel of flash_attention.cu at DP = 384 or 512, its keys in `splits`
// splits (1 to 4) with the scratch of fdsd_flash_fwd_d512 in `work`; others
// return cudaErrorInvalidValue.
extern "C" int fdsd_flash_fwd_pos(const void* q, const void* k, const void* v,
                                  void* out, void* lse, const void* q_off,
                                  const void* k_off, void* work, int B, int H,
                                  int Lq, int Lk, int d,
                                  const long long* strides, float scale,
                                  int seg_q, int seg_k, int valid_len,
                                  int has_valid, int causal, int bounded,
                                  int splits, void* stream) {
  if (d > 256)
    return static_cast<int>(fdsd::d512::fwd_pos(
        q, k, v, out, lse, q_off, k_off, work, B, H, Lq, Lk, d, strides,
        scale, seg_q, seg_k, valid_len, has_valid, causal, bounded, splits,
        static_cast<cudaStream_t>(stream)));
  PosParams p;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.n_qt = (Lq + kBQ - 1) / kBQ;
  p.n_tiles = B * H * p.n_qt;
  p.d = d;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.scale = scale;
  p.pos = fdsd::PosArgs{static_cast<const int*>(q_off),
                        static_cast<const int*>(k_off), seg_q, seg_k,
                        valid_len, has_valid, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch ((d + 15) / 16 * 16) {
#define FDSD_CASE(DP)                                                   \
  case DP:                                                              \
    err = bounded ? launch_pos<DP, true>(q, k, v, B, strides, p, s)     \
                  : launch_pos<DP, false>(q, k, v, B, strides, p, s);   \
    break;
    FDSD_K1_WIDTHS(FDSD_CASE)
#undef FDSD_CASE
  }
  return static_cast<int>(err);
}
