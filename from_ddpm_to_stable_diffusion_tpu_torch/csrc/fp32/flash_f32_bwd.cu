// Flash-attention backward on fp32 inputs for Hopper (sm_90a) on the tensor
// cores: the fp32 form of K3 (dq, and dbias) and K4 (dk, dv) in every mask
// form (no mask, causal, an additive bias, segment ids and their
// combinations) at every head dim up to 512, and of K6 / K7 (position masks
// under a caller-supplied global lse and delta) at every head dim up to 512.
// The kernels live in flash_f32_bwd.cuh: up to 128 one block per tile; head
// dims 129 to 256 one cluster of two blocks, each owning half of the columns
// (above 128 the resident Q and dO (dq) or K and V (dk / dv) terms of a
// 64-row tile no longer fit in one block beside the rings); above 256 the
// streaming kernel of flash_f32_bwd_stream.cuh, nothing resident, on a
// cluster of two blocks that split the head dim. This file
// holds the split pre-pass, the dispatch and the C entries; every form (no
// mask, masked, and ANY: a bias with dbias, segment ids, causal, at the head
// dim rounded up to 32; above 256 at 384 or 512) is instantiated a few
// widths to a file in flash_f32_bwd_w*.cu.
//
// Replaces, for fp32 q, k, v, dO, the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel_pos
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel_pos
// which ask for Precision.HIGHEST on every dot when the inputs are fp32.
// P = exp(scale Q K^T - lse) and dS = P (dO V^T - delta) stay fp32 and are
// selected to 0 where a mask hides the key (never multiplied: a row that saw
// no key has lse = -1e30); dq = scale dS K, dk = scale dS^T Q, dv = P^T dO,
// all fp32.
//
// The numerical plan is the fp32 forwards' (flash_f32_fwd.cu, and
// flash_f32_fwd_wide.cuh above 160): the
// three-term TF32 split for all five products (Q K^T, dO V^T, dS K, P^T dO,
// dS^T Q), each A_lo B_hi + A_hi B_lo + A_hi B_hi as TF32 wgmma m64nNk8 with
// fp32 accumulators, small terms first; P and dS are split in registers from
// their fp32 values. The tensor cores round toward zero when they add into
// an accumulator, so each tile's dS K (and P^T dO, dS^T Q) goes into a fresh
// accumulator that is added to the running sum in registers, rounded to
// nearest: no chain is longer than 3 x 128 / 8 = 48 wgmmas.
//
// What bounds them on the H100: operations. dq does 3 Lq Lk d multiply-adds
// (S, dP, dS K), dk/dv 4 (S^T, dP^T, P^T dO, dS^T Q), each in three TF32
// passes at 495 TFLOP/s: 165 TFLOP/s of fp32 work, 2.5 x the 67 TFLOP/s of
// fp32 FMAs on the CUDA cores, plus one exponential per logit.
//
// Design. TF32 wgmma takes both operands K-major, so every product whose
// reduction runs over the sequence needs a transposed term: dq = dS K needs
// K^T, dv = P^T dO needs dO^T, dk = dS^T Q needs Q^T. A pre-pass
// (split_f32.cuh, shared with the forward) writes, into a workspace the
// caller allocates, the hi / lo terms of q, k, v and dO as rows and those of
// k^T (for dq) or q^T and dO^T (for dk/dv), the sequence padded to 8 and
// permuted within groups of 8 so that P and dS go from the S (or S^T)
// accumulators into the A fragments of the next product in registers.
//  - dq (K3, K6; flash_bwd_dq_f32_kernel): one block per (b*h, query tile)
//    of a producer warpgroup and one consumer warpgroup per 64 queries (two
//    at d = 64, one at d = 128). The producer issues TMA: the Q and dO terms
//    once; K and V tiles of 32 keys on one ring, K^T tiles on a second, so
//    that the next tile's K and V load during this tile's dS K and the next
//    K^T during the next S and dP. The consumers keep lse and delta of their
//    rows in registers, run S = Q K^T and dP = dO V^T (SS, 3 x d / 8 wgmmas
//    each), P and dS in registers, and dQ += dS K as 3 x 32 / 8 RS wgmmas.
//  - dk/dv (K4, K7; flash_bwd_dkv_f32_kernel): one block per (b*h, key
//    block) of 64 keys per consumer warpgroup (two at d = 64, one at
//    d = 128), the keys as wgmma's M. K and V terms stay resident; Q and dO
//    rows stream on a two-stage ring and Q^T and dO^T on a one-stage ring,
//    in query tiles of 32 (d = 64) or 16 (d = 128: a 128-wide fp32 tile
//    costs four times the bf16 bytes, and K and V alone take 128 KB). The
//    consumers run S^T = K Q^T and dP^T = V dO^T (SS), read the lse and
//    delta of the tile's queries from global memory, form P^T and dS^T in
//    registers, and run dV += P^T dO and dK += dS^T Q as RS wgmmas over
//    64-column chunks of d, each chunk into a fresh accumulator.
// Widths: 64 and 128 at DP = d; every other head dim up to 128 at d rounded
// up to 16, the columns past d read as TMA's zeros and not written; dk / dv
// accumulate in chunks of DP / 2 columns above DP = 64. Shared memory, every
// form at 64 and 128: 229,376 B of tiles (the two kernels were sized to it),
// less at the other widths. Masks (K3 / K4 causal, K6 / K7) are the position masks of
// pos_tile.cuh, judged per (query tile, key tile) pair by pos_pair in every
// role; the causal form of the plain kernels is the position mask with
// offsets 0. The ANY form adds the bias (read from global memory into each
// logit), segment ids (AnyMasks in flash_f32_bwd.cuh: tiles skipped by
// their id ranges at the kernel's own tile sizes) and, in K3, dbias = dS
// written once for every tile of the block's rows, zeros where a tile is
// skipped. Query rows past Lq get lse = +1e30 (P = 0); keys past Lk are
// selected to P = 0.

#include "flash_f32_bwd.cuh"
#include "flash_f32_bwd_stream.cuh"
#include "split_f32.cuh"

namespace {

using namespace fdsd::f32bwd;

// ---------------------------------------------------------------- host side
// The terms in the workspace, in floats from its start: q, k, v, dO as
// (2, B, H, L, d) rows, then k^T (2, B, H, d, Lk8), q^T and dO^T
// (2, B, H, d, Lq8). dq fills the rows and k^T, dk/dv the rows, q^T and
// dO^T.
Work carve(void* work, int B, int H, int Lq, int Lk, int d) {
  Work w;
  const long long bhd = static_cast<long long>(B) * H * d;
  w.nq = bhd * Lq;
  w.nk = bhd * Lk;
  w.nkt = bhd * round_up8(Lk);
  w.nqt = bhd * round_up8(Lq);
  w.q = static_cast<float*>(work);
  w.k = w.q + 2 * w.nq;
  w.v = w.k + 2 * w.nk;
  w.g = w.v + 2 * w.nk;
  w.kt = w.g + 2 * w.nq;
  w.qt = w.kt + 2 * w.nkt;
  w.gt = w.qt + 2 * w.nqt;
  return w;
}

// The rows of q, k, v, dO (strides: 12 element strides first) into the
// workspace.
cudaError_t split_row_terms(const void* q, const void* k, const void* v,
                            const void* g, const long long* st, int H,
                            int Lq, int Lk, int d, const Work& w,
                            cudaStream_t s) {
  RowsArgs a;
  const void* xs[4] = {q, k, v, g};
  float* outs[4] = {w.q, w.k, w.v, w.g};
  for (int i = 0; i < 4; ++i) {
    a.x[i] = static_cast<const float*>(xs[i]);
    for (int j = 0; j < 3; ++j) a.st[i][j] = st[3 * i + j];
    a.out[i] = outs[i];
    const bool is_q = i == 0 || i == 3;
    a.n[i] = is_q ? w.nq : w.nk;
    a.L[i] = is_q ? Lq : Lk;
  }
  a.H = H;
  a.d = d;
  return split_rows(a, 4, s);
}

// The pre-pass of dq: the rows of q, k, v, dO and k^T into the workspace.
cudaError_t split_dq(const void* q, const void* k, const void* v,
                     const void* g, const long long* st, const Work& w,
                     const Params& p, cudaStream_t s) {
  cudaError_t err =
      split_row_terms(q, k, v, g, st, p.H, p.Lq, p.Lk, p.d, w, s);
  if (err == cudaSuccess)
    err = split_transposed(k, st + 3, w.kt, w.nkt, p.B, p.H, p.Lk, p.d, s);
  return err;
}

// The pre-pass of dk/dv: the rows of q, k, v, dO, q^T and dO^T.
cudaError_t split_dkv(const void* q, const void* k, const void* v,
                      const void* g, const long long* st, const Work& w,
                      const Params& p, cudaStream_t s) {
  cudaError_t err =
      split_row_terms(q, k, v, g, st, p.H, p.Lq, p.Lk, p.d, w, s);
  if (err == cudaSuccess)
    err = split_transposed(q, st, w.qt, w.nqt, p.B, p.H, p.Lq, p.d, s);
  if (err == cudaSuccess)
    err = split_transposed(g, st + 9, w.gt, w.nqt, p.B, p.H, p.Lq, p.d, s);
  return err;
}

// strides: q, k, v, dO, then the outputs, three each.
Params bwd_params(const void* lse, const void* delta, void* o0, void* o1,
                  int B, int H, int Lq, int Lk, int d,
                  const long long* strides, float scale) {
  Params p = {};
  p.d = d;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.o0 = static_cast<float*>(o0);
  p.o1 = static_cast<float*>(o1);
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  for (int i = 0; i < 3; ++i) {
    p.o0s[i] = strides[12 + i];
    p.o1s[i] = o1 != nullptr ? strides[15 + i] : 0;
  }
  p.scale = scale;
  p.pos = PosArgs{nullptr, nullptr, Lq, Lk, 0, 0, 0};
  return p;
}

// run(std::integral_constant<int, DP>{}) at the width of head dim d (a
// multiple of 4): up to 128 d rounded up to 16 (the kernels of this file),
// above it rounded up to 32 (flash_f32_bwd.cuh's); cudaErrorInvalidValue
// past 256.
template <typename Run>
cudaError_t run_width(int d, Run run) {
  if (d < 4 || d > 256 || d % 4 != 0) return cudaErrorInvalidValue;
  if (d > 128) {
    switch ((d + 31) / 32 * 32) {
      case 160:
        return run(std::integral_constant<int, 160>{});
      case 192:
        return run(std::integral_constant<int, 192>{});
      case 224:
        return run(std::integral_constant<int, 224>{});
      default:
        return run(std::integral_constant<int, 256>{});
    }
  }
  switch ((d + 15) / 16 * 16) {
    case 16:
      return run(std::integral_constant<int, 16>{});
    case 32:
      return run(std::integral_constant<int, 32>{});
    case 48:
      return run(std::integral_constant<int, 48>{});
    case 64:
      return run(std::integral_constant<int, 64>{});
    case 80:
      return run(std::integral_constant<int, 80>{});
    case 96:
      return run(std::integral_constant<int, 96>{});
    case 112:
      return run(std::integral_constant<int, 112>{});
    default:
      return run(std::integral_constant<int, 128>{});
  }
}

// K3 (K6 with offsets) at width DP, with or without its mask.
template <int DP>
cudaError_t launch_dq(const Work& w, const Params& p, bool masked,
                      cudaStream_t s) {
  if constexpr (DP > 128)
    return masked ? run_dq_wide<DP, true>(w, p, s)
                  : run_dq_wide<DP, false>(w, p, s);
  else
    return run_narrow<DP>(true, masked, w, p, s);
}

template <int DP>
cudaError_t launch_dkv(const Work& w, const Params& p, bool masked,
                       cudaStream_t s) {
  if constexpr (DP > 128)
    return masked ? run_dkv_wide<DP, true>(w, p, s)
                  : run_dkv_wide<DP, false>(w, p, s);
  else
    return run_narrow<DP>(false, masked, w, p, s);
}

// run_any at the head dim d (a multiple of 4 up to 256) rounded up to 32.
cudaError_t any_width(int d, bool dq, const Work& w, const Params& p,
                      cudaStream_t s) {
  switch ((d + 31) / 32 * 32) {
#define FDSD_CASE(DP) \
  case DP:            \
    return run_any<DP>(dq, w, p, s);
    FDSD_F32_BWD_ANY_WIDTHS(FDSD_CASE)
#undef FDSD_CASE
  }
  return cudaErrorInvalidValue;
}

// Head dims the kernels take: multiples of 4 up to 256, of 8 from 264 to
// 512.
bool takes(int d) {
  return (d >= 4 && d <= 256 && d % 4 == 0) ||
         (d > 256 && d <= 512 && d % 8 == 0);
}

// K3 / K4 (K6 / K7) above 256 on the streaming kernel
// (flash_f32_bwd_stream.cuh) at DP 384 or 512, without a mask or ANY
// (causal, a bias, segment ids; the position masks).
cudaError_t stream_width(int d, bool masked, const Work& w, const Params& p,
                         cudaStream_t s) {
  if (d <= 384)
    return masked ? run_stream<384, true>(w, p, s)
                  : run_stream<384, false>(w, p, s);
  return masked ? run_stream<512, true>(w, p, s)
                : run_stream<512, false>(w, p, s);
}

// K3 (K6 with offsets) after its pre-pass: without a mask, masked (causal,
// the position masks), or in the ANY form (a bias, segment ids; causal too).
cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* g, const long long* st, void* work,
                        const Params& p, int d, bool masked, bool any,
                        cudaStream_t s) {
  if (!takes(d)) return cudaErrorInvalidValue;
  const Work w = carve(work, p.B, p.H, p.Lq, p.Lk, d);
  cudaError_t err = split_dq(q, k, v, g, st, w, p, s);
  if (err != cudaSuccess) return err;
  if (d > 256) return stream_width(d, masked, w, p, s);
  if (any) return any_width(d, true, w, p, s);
  return run_width(d, [&](auto width) {
    return launch_dq<decltype(width)::value>(w, p, masked, s);
  });
}

// K4 (K7 with offsets), as dispatch_dq.
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const void* g, const long long* st, void* work,
                         const Params& p, int d, bool masked, bool any,
                         cudaStream_t s) {
  if (!takes(d)) return cudaErrorInvalidValue;
  const Work w = carve(work, p.B, p.H, p.Lq, p.Lk, d);
  cudaError_t err = split_dkv(q, k, v, g, st, w, p, s);
  if (err != cudaSuccess) return err;
  if (d > 256) return stream_width(d, masked, w, p, s);
  if (any) return any_width(d, false, w, p, s);
  return run_width(d, [&](auto width) {
    return launch_dkv<decltype(width)::value>(w, p, masked, s);
  });
}

PosArgs pos_args(const void* q_off, const void* k_off, int seg_q, int seg_k,
                 int valid_len, int has_valid, int causal) {
  return PosArgs{static_cast<const int*>(q_off),
                 static_cast<const int*>(k_off), seg_q, seg_k, valid_len,
                 has_valid, causal};
}

}  // namespace

// K3 in fp32. strides: 15 element strides, (batch, head, seq) for q, k, v,
// dO, dq, each a multiple of 4 (the head-dim stride is 1), then (batch,
// head, row, col) for the bias. lse and delta are (B, H, Lq) contiguous
// fp32. dbias: with a bias, fp32 (B, H, Lq, Lk) contiguous (dS before any
// reduction; every element written), or null. bias (fp32, read through its
// strides) and the six segment arrays of mask.cuh (at the tiles of the ANY
// kernel of the head dim rounded up to 32: (128, 32) at 32 and 64, (64, 32)
// at 96 and 128, (64, 32) at 160 and 192, (64, 16) at 224 and 256) are null
// when not asked for. work: fp32 scratch of 2 B H d (2 Lq + 2 Lk + Lk8 +
// 2 Lq8) floats (L8: L rounded up to 8), shared in layout with
// fdsd_flash_bwd_dkv_f32. Every head dim up to 256 that is a multiple of 4,
// and every multiple of 8 from 264 to 512 (segment arrays at (64, 64)), in
// every form.
extern "C" int fdsd_flash_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, void* dbias, void* work,
    const void* bias, const void* q_ids, const void* kv_ids,
    const void* q_bounds, const void* kv_bounds, const void* lo,
    const void* hi, int B, int H, int Lq, int Lk, int d,
    const long long* strides, float scale, int causal, void* stream) {
  Params p = bwd_params(lse, delta, dq, nullptr, B, H, Lq, Lk, d, strides,
                       scale);
  p.pos.causal = causal;
  const bool any = bias != nullptr || q_ids != nullptr;
  p.m = fdsd::make_mask_args(bias, strides + 15, 0, q_ids, kv_ids, q_bounds,
                             kv_bounds, lo, hi);
  p.ds = bias != nullptr ? static_cast<float*>(dbias) : nullptr;
  return static_cast<int>(dispatch_dq(q, k, v, g, strides, work, p, d,
                                      causal != 0 || any, any,
                                      static_cast<cudaStream_t>(stream)));
}

// K4 in fp32. strides: 18 element strides, for q, k, v, dO, dk, dv, then
// the bias's 4; the segment arrays at the tiles of the ANY kernel of the
// head dim rounded up to 32 ((32 queries, 128 keys) at 32 and 64, (16, 64)
// at 96 and 128, (32, 64) at 160, (16, 64) from 192 to 256, (64, 64) above);
// work as for fdsd_flash_bwd_dq_f32. Every head dim of fdsd_flash_bwd_dq_f32:
// above 256 the dk and the dv blocks are one launch.
extern "C" int fdsd_flash_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dk, void* dv, void* work,
    const void* bias, const void* q_ids, const void* kv_ids,
    const void* q_bounds, const void* kv_bounds, const void* lo,
    const void* hi, int B, int H, int Lq, int Lk, int d,
    const long long* strides, float scale, int causal, void* stream) {
  Params p = bwd_params(lse, delta, dk, dv, B, H, Lq, Lk, d, strides,
                       scale);
  p.pos.causal = causal;
  const bool any = bias != nullptr || q_ids != nullptr;
  p.m = fdsd::make_mask_args(bias, strides + 18, 0, q_ids, kv_ids, q_bounds,
                             kv_bounds, lo, hi);
  return static_cast<int>(dispatch_dkv(q, k, v, g, strides, work, p, d,
                                       causal != 0 || any, any,
                                       static_cast<cudaStream_t>(stream)));
}

// K6 in fp32: the arguments of fdsd_flash_bwd_pos_dq on fp32 tensors, with
// the workspace of fdsd_flash_bwd_dq_f32 after the offsets. Every head dim
// up to 256 that is a multiple of 4, and every multiple of 8 from 264 to 512
// (the streaming kernel).
extern "C" int fdsd_flash_bwd_pos_dq_f32(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, const void* q_off,
    const void* k_off, void* work, int B, int H, int Lq, int Lk, int d,
    const long long* strides, float scale, int seg_q, int seg_k, int valid_len,
    int has_valid, int causal, void* stream) {
  Params p = bwd_params(lse, delta, dq, nullptr, B, H, Lq, Lk, d, strides,
                       scale);
  p.pos = pos_args(q_off, k_off, seg_q, seg_k, valid_len, has_valid, causal);
  return static_cast<int>(dispatch_dq(q, k, v, g, strides, work, p, d, true,
                                      false,
                                      static_cast<cudaStream_t>(stream)));
}

// K7 in fp32: the arguments of fdsd_flash_bwd_pos_dkv on fp32 tensors, with
// the workspace of fdsd_flash_bwd_dkv_f32 after the offsets. Every head dim
// up to 256 that is a multiple of 4, and every multiple of 8 from 264 to 512
// (the streaming kernel, the dk and the dv blocks in one launch).
extern "C" int fdsd_flash_bwd_pos_dkv_f32(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dk, void* dv, const void* q_off,
    const void* k_off, void* work, int B, int H, int Lq, int Lk, int d,
    const long long* strides, float scale, int seg_q, int seg_k, int valid_len,
    int has_valid, int causal, void* stream) {
  Params p = bwd_params(lse, delta, dk, dv, B, H, Lq, Lk, d, strides,
                       scale);
  p.pos = pos_args(q_off, k_off, seg_q, seg_k, valid_len, has_valid, causal);
  return static_cast<int>(dispatch_dkv(q, k, v, g, strides, work, p, d, true,
                                       false,
                                       static_cast<cudaStream_t>(stream)));
}
