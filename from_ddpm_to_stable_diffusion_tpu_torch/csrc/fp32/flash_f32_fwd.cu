// Flash-attention forward on fp32 inputs for Hopper (sm_90a) on the tensor
// cores: the fp32 form of K1 (every mask form at every head dim up to 512:
// no mask, causal, an additive bias, segment ids, and their combinations)
// and of K5 (the position masks at every head dim up to 512, online and
// bounded). Up to 160 the resident kernel of flash_f32_fwd.cuh; head dims
// 161 to 512 run the streaming kernel of flash_f32_fwd_wide.cuh (widths in
// flash_f32_fwd_w*.cu). This file holds the split pre-pass, the d = 512
// kernel, the key-split merge, the dispatch and the C entries.
//
// Replaces, for fp32 q, k, v, the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_wide
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_pos
// which ask for Precision.HIGHEST on every dot when the inputs are fp32 (a
// TPU computes that as several bf16 passes on its matrix unit). Same output
// contract as the bf16 kernels, in fp32: lse = max + log(sum) of the scaled
// logits; a row that sees no key gives out = 0 and lse = -1e30; a masked
// probability is selected to 0.
//
// The three-term TF32 split. Every fp32 operand x is taken as
// x_hi = tf32(x) (rounded to nearest, cvt.rna) and x_lo = tf32(x - x_hi);
// each product is A_hi B_hi + A_hi B_lo + A_lo B_hi (kPasses = 3 wgmma
// passes, m64nNk8 TF32, fp32 accumulators), the small terms first. The
// dropped A_lo B_lo and the rounding of the lo terms are ~2^-22 of each
// product, so out and lse stay within ~1e-6 of fp64, where one TF32 pass
// keeps ~1e-3. Both terms are rounded explicitly (x_hi is not the raw fp32
// value) so the result does not hang on how the tensor cores treat the low
// 13 bits. P is split in registers from its fp32 value; the row sums add
// the fp32 P itself. The tensor cores add into their accumulators rounding
// toward zero, so a long chain of wgmmas into one accumulator drifts (P V
// over 4096 keys in one chain: ~1e-5 from fp64): each key tile's P V (and
// at d = 512 each 64-column chunk of S) starts a fresh accumulator, added
// to the running one in registers, rounded to nearest; no chain is longer
// than 3 x 128 / 8 = 48 wgmmas.
//
// What bounds it on the H100: at 4096 keys ~1,000 flop per byte moved, so
// operations: three TF32 passes at 495 TFLOP/s (165 TFLOP/s of fp32 work,
// 2.5 x the 67 TFLOP/s of fp32 FMAs on the CUDA cores), and at small head
// dims the exponentials.
//
// Design.
//  - The split pre-pass of split_f32.cuh (shared with the backward) writes,
//    into a workspace the caller allocates, q and k as (2, B, H, L, d) hi /
//    lo terms and v TRANSPOSED as (2, B, H, d, Lk8) hi / lo terms (keys
//    padded with zeros to Lk8, a multiple of kKeyGroup = 8). TF32 wgmma
//    takes both operands K-major (PTX allows the transpose flags for 16-bit
//    types only), so for O = P V the key axis of V must be contiguous: the
//    pre-pass is where V is transposed, one smem-tiled pass over V with
//    coalesced reads and writes. Within each group of 8 keys the pre-pass
//    stores key 2t at position t and key 2t + 1 at position t + 4: the A
//    fragment of a TF32 wgmma holds columns (t, t + 4) of a k-step where the
//    S accumulator holds columns (2t, 2t + 1), so with V^T permuted alike P
//    goes from the S accumulators into the A operand of P V in registers.
//  - K1 / K5 at head dims up to 128 (flash_fwd_f32_kernel): K1's design of
//    flash_attention_sm90.cu in TF32. One block of three warpgroups per
//    (b*h, 128 queries): a producer thread issues TMA (the Q hi / lo tile
//    once; K hi / lo tiles and V^T hi / lo tiles on rings of their own, so
//    that the next K loads during this tile's P V and the next V during the
//    next S); two consumer warpgroups of 64 query rows run S = Q K^T as
//    3 x d / 8 SS wgmmas, the softmax in fp32 registers, and O += P V as
//    3 x kBK / 8 RS wgmmas. The Q tile holds both terms, so at d = 128 (Q
//    128 KB) the key tiles are 32 long on a single stage each.
//  - K1 at head dim 8 (the `checks sd1` UNet, SD1UNet(model_channels=64)
//    with 8 heads: 8 x 1024^2 x 8 at its 32^2 level) is the same kernel:
//    one 32-byte swizzle chunk a row for Q and K, so S = Q K^T is one k-step
//    (3 SS wgmmas m64n64k8 a key tile), and P V is m64n8k8 RS, one 8-row core
//    group of v^T. At d = 8 each logit costs 3 x 2 x 2 x 8 = 96 flop on the
//    tensor cores against one exponential, so the SFU's ex2, not the TF32
//    products, bound it (PERF.md); the simple form is kept.
//  - Widths: the head dims 8, 40, 48, 64, 72, 80, 128 and 160 run at DP = d;
//    every other head dim up to 160 at d rounded up to 16 (16, 32, 96, 112,
//    144, or a width above), the columns past d read as TMA's zeros and not
//    written. The stages follow the width: two while Q's terms and two of
//    each ring fit, else one.
//  - K1 at head dim 160 (the SD1 UNet's level-2 attention from 768^2) is the
//    same kernel with one consumer warpgroup and 64-query blocks: a
//    128-query Q tile's two terms would take 160 KB. Chosen over the d = 512
//    design (Q, K and V^T streamed through slots, two consumers splitting S
//    by keys) because 160 still leaves Q resident: Q 80 KB, one stage of K
//    and of V^T with 32 keys each (40 KB each), 160 KB in all. P V runs in
//    two halves of 80 output columns, each into a fresh accumulator of 40
//    registers. A 64-query block keeps one warpgroup on the tensor cores,
//    so the softmax is not hidden behind the other's products; the shape
//    is rare (768^2 and larger, fp32) and this is the simple form.
//  - The bias form (T5's relative-position bias, d = 64, scale 1.0): the
//    producer warpgroup's 128 threads stage each (128 queries x 64 keys)
//    fp32 bias tile by cp.async from the bias's strides, as the bf16 K1's
//    producer does (one stage, 32 KB, swizzled; 230,488 B in all); the
//    consumers add it to the scaled logits in fp32 after the three-term
//    product and before the row max. The key tail is masked after it, so a
//    bias narrows the tail mask and never replaces it; a logit at -1e30 or
//    -inf is selected to probability 0, so a row the bias hides whole gives
//    out = 0 and lse = -1e30.
//  - K1 at head dims 161 to 512 (widths 192, 224, 256, 384, 512;
//    flash_f32_fwd_wide.cuh; flash_fwd_f32_wide_kernel and, at 512 without
//    a mask, flash_fwd_f32_d512_kernel): 64-query blocks whose Q, K and v^T
//    terms all stream through three 64 KB slots, nothing resident; two
//    consumers split S by keys and own half of the output columns each.
//    Above 256, below 132 query tiles, the keys are split over up to
//    kMaxSplits blocks (k1_d512_splits in ops/flash_attention.py) and
//    merge_f32_d512_kernel merges them by their lse; a split a row sees no
//    key of (causal, segment ids) has weight 0.
//  - The ANY form (K1 with a bias or segment ids, causal or not), at the
//    head dim rounded up to 32 (32 - 160 resident, 192 - 256 streaming):
//    every mask compiled in and chosen per launch. The bias is read from
//    global memory (L2) through its strides, each consumer thread the
//    elements of its own accumulator fragment, and added to the scaled
//    logit in fp32 (a staged tile beside the resident Q terms would not fit
//    from DP 96 on); segment ids walk the key-tile range [lo, hi] of
//    mask.cuh at the kernel's own tiles (ops/flash_attention.py's
//    _f32_tiles), skip a tile whose ids are disjoint, and compare ids per
//    logit where a pair is not skipped.
// Masks (K1 causal and K5) are the position masks of pos_tile.cuh, runtime
// flags judged per (query tile, key tile) pair by pos_pair in every role;
// K1's causal is the position mask with offsets 0. The key tail is masked
// on the last tile only.

#include "flash_f32_fwd.cuh"
#include "split_f32.cuh"

namespace {

using namespace fdsd::f32fwd;
using fdsd::PosArgs;

// ------------------------------------------------------- K1 at d = 512
namespace d512 {
constexpr int DP = 512;
constexpr int kMaxSplits = 4;
using fdsd::f32fwd::WideParams;

// The streaming kernel of flash_f32_fwd_wide.cuh at 512, under its own name.
__global__ void __launch_bounds__(fdsd::f32fwd::kWideThreads, 1)
flash_fwd_f32_d512_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ WideParams p) {
  fdsd::f32fwd::wide_body<DP, fdsd::f32fwd::kWidePlain>(tq, tk, tv, p);
}

// The key splits of one row at width W (384 or 512), merged by their lse:
// out = sum_s w_s O_s with w_s = exp(lse_s - lse), lse = log sum_s
// exp(lse_s); a split at -1e30 (no key of it visible) has weight 0. One
// block of W / 8 threads per row, 8 columns a thread; the columns past d are
// not written.
template <int W>
__global__ void __launch_bounds__(W / 8)
merge_f32_d512_kernel(const float* __restrict__ work, float* __restrict__ out,
                      float* __restrict__ lse, int H, int Lq, int d,
                      int splits, long long rows, long long os0,
                      long long os1, long long os2) {
  constexpr int DP = W;
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
    if (w[s] == 0.f) continue;  // its O / l is 0 (and never read as NaN)
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
  if (col < d) {
    float* ob = out + b * os0 + h * os1 + r * os2 + col;
    reinterpret_cast<float2*>(ob)[0] = make_float2(acc[0], acc[1]);
    reinterpret_cast<float2*>(ob)[1] = make_float2(acc[2], acc[3]);
    reinterpret_cast<float2*>(ob)[2] = make_float2(acc[4], acc[5]);
    reinterpret_cast<float2*>(ob)[3] = make_float2(acc[6], acc[7]);
  }
  if (threadIdx.x == 0) lse[row] = tot == 0.f ? kNegInf : mx + logf(tot);
}
}  // namespace d512

// ---------------------------------------------------------------- host side
// The split pre-pass: q, k (through their strides, 12 element strides of q,
// k, v first) and v (transposed) into the workspace's terms.
cudaError_t split_inputs(const void* q, const void* k, const void* v,
                         const long long* st, int B, int H, int Lq, int Lk,
                         int d, const Work& w, cudaStream_t s) {
  RowsArgs a;
  a.x[0] = static_cast<const float*>(q);
  a.x[1] = static_cast<const float*>(k);
  for (int i = 0; i < 3; ++i) {
    a.st[0][i] = st[i];
    a.st[1][i] = st[3 + i];
  }
  a.out[0] = w.q;
  a.out[1] = w.k;
  a.n[0] = w.nq;
  a.n[1] = w.nk;
  a.L[0] = Lq;
  a.L[1] = Lk;
  a.H = H;
  a.d = d;
  cudaError_t err = split_rows(a, 2, s);
  if (err != cudaSuccess) return err;
  return split_transposed(v, st + 6, w.vt, w.nv, B, H, Lk, d, s);
}

// K1 or K5 on the streaming kernel at width DP (192, 224, 256 in a
// WideForm; 384 and 512 without a mask, causal, ANY and bounded, with their
// key splits and the merge).
template <int DP>
cudaError_t run_stream(const Work& w, const Params& q, int splits, int form,
                       cudaStream_t s) {
  using C = fdsd::f32fwd::WideCfg<DP>;
  if (splits < 1 || splits > d512::kMaxSplits || (DP <= 256 && splits > 1))
    return cudaErrorInvalidValue;
  fdsd::f32fwd::WideParams p;
  p.out = q.out;
  p.lse = q.lse;
  p.work = w.part;
  p.B = q.B;
  p.H = q.H;
  p.Lq = q.Lq;
  p.Lk = q.Lk;
  p.d = q.d;
  p.n_qt = (q.Lq + C::kBQ - 1) / C::kBQ;
  p.splits = splits;
  const int n_kt = (q.Lk + C::kBK - 1) / C::kBK;
  p.kt_per_split = (n_kt + splits - 1) / splits;
  p.rows = static_cast<long long>(q.B) * q.H * q.Lq;
  for (int i = 0; i < 3; ++i) p.os[i] = q.os[i];
  p.scale = q.scale;
  p.pos = q.pos;
  p.m = q.m;
  CUtensorMap tq, tk, tv;
  cudaError_t err = term_maps(&tq, &tk, &tv, w, q.B, q.H, q.Lq, q.Lk, q.d,
                              32, C::kBQ, C::kBK, C::kVRows);
  if (err != cudaSuccess) return err;
  if constexpr (DP <= 256) {
    return fdsd::f32fwd::launch_wide<DP>(form, tq, tk, tv, p, s);
  } else {
    if (DP == 512 && form == fdsd::f32fwd::kWidePlain)
      err = s9::launch_kernel(d512::flash_fwd_f32_d512_kernel,
                              q.B * q.H * p.n_qt * splits,
                              fdsd::f32fwd::kWideThreads, C::kSmemBytes, s,
                              tq, tk, tv, p);
    else
      err = fdsd::f32fwd::launch_wide_k1<DP>(form, tq, tk, tv, p, s);
    if (err == cudaSuccess && splits > 1) {
      d512::merge_f32_d512_kernel<DP><<<static_cast<unsigned>(p.rows),
                                         DP / 8, 0, s>>>(
          p.work, p.out, p.lse, q.H, q.Lq, q.d, splits, p.rows, p.os[0],
          p.os[1], p.os[2]);
      err = cudaGetLastError();
    }
    return err;
  }
}

template <int DP>
using Width = std::integral_constant<int, DP>;

// f(Width<DP>{}) at the width the resident kernel's no-mask, causal and K5
// online forms run head dim d (<= 160) at: 8, 40, 48, 64, 72, 80, 128 and
// 160 at DP = d, the others rounded up to 16.
template <typename F>
cudaError_t resident_width(int d, F f) {
  switch (d) {
    case 8:  // the `checks sd1` UNet (model_channels 64, 8 heads)
      return f(Width<8>{});
    case 40:  // SD1 UNet at 64^2
      return f(Width<40>{});
    case 72:
      return f(Width<72>{});
  }
  switch ((d + 15) / 16 * 16) {
    case 16:
      return f(Width<16>{});
    case 32:
      return f(Width<32>{});
    case 48:
      return f(Width<48>{});
    case 64:  // SigLIP tower, TinyVLM decoder
      return f(Width<64>{});
    case 80:  // SD1 UNet at 32^2
      return f(Width<80>{});
    case 96:  // tiny-SD UNet at channel 96, 64^2
      return f(Width<96>{});
    case 112:
      return f(Width<112>{});
    case 128:  // tiny-SD UNet
      return f(Width<128>{});
    case 144:
      return f(Width<144>{});
    default:  // SD1 UNet level 2, from 768^2 images
      return f(Width<160>{});
  }
}

// f(Width<DP>{}) at the width of the forms of run_masks (head dims up to
// 160 rounded up to 32).
template <typename F>
cudaError_t mask_width(int d, F f) {
  switch ((d + 31) / 32 * 32) {
    case 32:
      return f(Width<32>{});
    case 64:
      return f(Width<64>{});
    case 96:
      return f(Width<96>{});
    case 128:
      return f(Width<128>{});
    default:
      return f(Width<160>{});
  }
}

// run_stream at the width of head dim d (161 to 256 rounded up to 32) in the
// WideForm `form`.
cudaError_t stream_width(int d, const Work& w, const Params& p, int form,
                         cudaStream_t s) {
  switch ((d + 31) / 32 * 32) {
    case 192:  // tiny-SD UNet at channel 96, 32^2
      return run_stream<192>(w, p, 1, form, s);
    case 224:
      return run_stream<224>(w, p, 1, form, s);
    default:
      return run_stream<256>(w, p, 1, form, s);
  }
}

Params fwd_params(void* out, void* lse, int B, int H, int Lq, int Lk, int d,
                  const long long* strides, float scale) {
  Params p = {};
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.scale = scale;
  p.pos = PosArgs{nullptr, nullptr, Lq, Lk, 0, 0, 0};
  return p;
}

}  // namespace

// K1 in fp32. strides: 16 element strides, (batch, head, seq) for q, k, v,
// out, each a multiple of 4 (the head-dim stride is 1), then (batch, head,
// row, col) for the bias. lse is (B, H, Lq) contiguous fp32. bias: fp32,
// read through its strides (0 on a broadcast axis), or null; q_ids ..
// hi: the six segment arrays of mask.cuh at the tiles of the kernel the
// form runs on (the resident kernel's (kBQ, kBK) at the head dim rounded
// up to 32 up to 160, (64, 64) above), or null. work: fp32 scratch of
// 2 B H (Lq + Lk) d + 2 B H d Lk8 floats (Lk8: Lk rounded up to 8), plus
// splits * B * H * Lq * (DP + 1) above 256 with splits > 1 (1 to 4 key splits
// per 64-query tile; ignored at other head dims). Every head dim up to 256
// that is a multiple of 4 in every form (a bias alone at 64 on T5's staged
// bias tile), and every multiple of 8 from 264 to 512 in every form (at DP
// 384 or 512); others return cudaErrorInvalidValue.
extern "C" int fdsd_flash_fwd_f32(const void* q, const void* k, const void* v,
                                  void* out, void* lse, void* work,
                                  const void* bias, const void* q_ids,
                                  const void* kv_ids, const void* q_bounds,
                                  const void* kv_bounds, const void* lo,
                                  const void* hi, int B, int H, int Lq,
                                  int Lk, int d, const long long* strides,
                                  float scale, int causal, int splits,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p = fwd_params(out, lse, B, H, Lq, Lk, d, strides, scale);
  const Work w = carve(work, B, H, Lq, Lk, d);
  const bool width = (d >= 4 && d <= 256 && d % 4 == 0) ||
                     (d > 256 && d <= 512 && d % 8 == 0);
  const bool masks = bias != nullptr || q_ids != nullptr;
  if (!width) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = split_inputs(q, k, v, strides, B, H, Lq, Lk, d, w, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.pos.causal = causal != 0;  // the position mask with offsets 0
  if (masks)
    p.m = fdsd::make_mask_args(bias, strides + 12, 0, q_ids, kv_ids,
                               q_bounds, kv_bounds, lo, hi);
  if (d > 256) {  // 512 without a mask: the VAEs' mid attention
    const int form = masks ? kWideAny : causal ? kWideCausal : kWidePlain;
    return static_cast<int>(d <= 384 ? run_stream<384>(w, p, splits, form, s)
                                     : run_stream<512>(w, p, splits, form, s));
  }
  if (masks) {
    // T5's relative bias: the staged tile, 1.6 x faster than ANY's reads
    // from L2 at T5-XXL's (2, 64, 512, 512, 64) (PERF.md)
    if (q_ids == nullptr && !causal && d == 64)
      return static_cast<int>(run<64, false, false, true>(w, p, s));
    if (d > 160)
      return static_cast<int>(stream_width(d, w, p, kWideAny, s));
    return static_cast<int>(mask_width(d, [&](auto dp) {
      return run_masks<decltype(dp)::value>(false, w, p, s);
    }));
  }
  if (d > 160)  // the streaming kernel at d rounded up to 32
    return static_cast<int>(
        stream_width(d, w, p, causal ? kWideCausal : kWidePlain, s));
  return static_cast<int>(resident_width(d, [&](auto dp) {
    return run_plain<decltype(dp)::value>(causal != 0, w, p, s);
  }));
}

// K5 in fp32: the arguments of fdsd_flash_fwd_pos (flash_attention_sm90.cu)
// on fp32 tensors, with the workspace of fdsd_flash_fwd_f32 after the
// offsets and the key splits (1 to 4, read above 256 only, where the
// workspace holds them) before the stream. Every
// head dim up to 256 that is a multiple of 4: online on the resident
// kernel's masked form up to 160, bounded at the head dim rounded up to 32;
// above 160 the streaming kernel; every multiple of 8 from 264 to 512 the
// streaming kernel at 384 or 512 with its key splits.
extern "C" int fdsd_flash_fwd_pos_f32(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      const void* q_off, const void* k_off,
                                      void* work, int B, int H, int Lq,
                                      int Lk, int d, const long long* strides,
                                      float scale, int seg_q, int seg_k,
                                      int valid_len, int has_valid,
                                      int causal, int bounded, int splits,
                                      void* stream) {
  if (!((d >= 4 && d <= 256 && d % 4 == 0) ||
        (d > 256 && d <= 512 && d % 8 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p = fwd_params(out, lse, B, H, Lq, Lk, d, strides, scale);
  p.pos = PosArgs{static_cast<const int*>(q_off),
                  static_cast<const int*>(k_off), seg_q, seg_k, valid_len,
                  has_valid, causal};
  const Work w = carve(work, B, H, Lq, Lk, d);
  cudaError_t err = split_inputs(q, k, v, strides, B, H, Lq, Lk, d, w, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int form = bounded ? kWideBounded : kWideAny;
  if (d > 256)
    return static_cast<int>(d <= 384 ? run_stream<384>(w, p, splits, form, s)
                                     : run_stream<512>(w, p, splits, form, s));
  if (d > 160) return static_cast<int>(stream_width(d, w, p, form, s));
  if (bounded)
    return static_cast<int>(mask_width(d, [&](auto dp) {
      return run_masks<decltype(dp)::value>(true, w, p, s);
    }));
  return static_cast<int>(resident_width(d, [&](auto dp) {
    return run_plain<decltype(dp)::value>(true, w, p, s);
  }));
}
