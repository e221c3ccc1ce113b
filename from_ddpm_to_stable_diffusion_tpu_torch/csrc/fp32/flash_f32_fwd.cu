// Flash-attention forward on fp32 inputs for Hopper (sm_90a) on the tensor
// cores: the fp32 form of K1 (no mask and causal at every head dim up to
// 256, no mask at 512; T5's additive bias at 64) and of K5 (position masks
// at 64, online and bounded). Head dims 161 to 256 and 512 run the streaming
// kernel of flash_f32_fwd_wide.cuh (widths in flash_f32_fwd_w*.cu).
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
//  - K1 at head dims 161 to 256 (widths 192, 224, 256) and 512
//    (flash_f32_fwd_wide.cuh; flash_fwd_f32_wide_kernel and, at 512,
//    flash_fwd_f32_d512_kernel): 64-query blocks whose Q, K and v^T terms
//    all stream through three 64 KB slots, nothing resident; two consumers
//    split S by keys and own half of the output columns each. Below 132
//    query tiles the keys at d = 512 are split over up to kMaxSplits blocks
//    (k1_d512_splits in ops/flash_attention.py) and merge_f32_d512_kernel
//    merges them by their lse.
// Masks (K1 causal and K5) are the position masks of pos_tile.cuh, runtime
// flags judged per (query tile, key tile) pair by pos_pair in every role;
// K1's causal is the position mask with offsets 0. The key tail is masked
// on the last tile only.

#include "../pos_tile.cuh"
#include "../sm90.cuh"
#include "flash_f32_fwd_wide.cuh"
#include "split_f32.cuh"

namespace {

namespace s9 = fdsd::sm90;
using fdsd::PosArgs;
using fdsd::pos_bounds;
using fdsd::pos_of;
using fdsd::pos_pair;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPasses = 3;    // TF32 wgmma passes per product
static_assert(kPasses == 3, "hi hi + hi lo + lo hi");
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// ------------------------------------------------------------- workspace
// The split terms, in floats from the workspace's start: q (2, B, H, Lq, d),
// k (2, B, H, Lk, d), v^T (2, B, H, d, Lk8), then at d = 512 with key splits
// the partial outputs (splits, B*H*Lq, 513).
struct Work {
  float* q;
  float* k;
  float* vt;
  float* part;
  long long nq, nk, nv;  // floats of one term
  int lk8;
};

Work carve(void* work, int B, int H, int Lq, int Lk, int d) {
  Work w;
  w.lk8 = round_up8(Lk);
  w.nq = static_cast<long long>(B) * H * Lq * d;
  w.nk = static_cast<long long>(B) * H * Lk * d;
  w.nv = static_cast<long long>(B) * H * d * w.lk8;
  w.q = static_cast<float*>(work);
  w.k = w.q + 2 * w.nq;
  w.vt = w.k + 2 * w.nk;
  w.part = w.vt + 2 * w.nv;
  return w;
}

// ------------------------------------------------ K1 / K5 at d <= 160
// Two consumer warpgroups of 64 query rows (128 queries a block) up to
// d = 128; one at d = 160, where a 128-query Q tile's two terms alone would
// take 160 KB. HAS_BIAS adds a (kBQ x kBK) fp32 bias tile.
template <int DP, bool HAS_BIAS = false>
struct Cfg {
  static constexpr int kCons = DP <= 128 ? 2 : 1;
  static constexpr int kBQ = 64 * kCons;  // queries per block
  static constexpr int kThreads = 128 * (1 + kCons);
  static constexpr int kConsumers = 128 * kCons;
  static constexpr int W = DP % 32 == 0 ? 32 : 8;  // columns per swizzle row
  static constexpr uint32_t kLayout = W == 32 ? 1 : 3;  // 128B / 32B swizzle
  static constexpr uint32_t kAtom = 8 * W * 4;          // 8 rows of a chunk
  static constexpr int kChunks = DP / W;
  static constexpr int kBK = DP >= 80 ? 32 : 64;  // keys per tile
  // two stages where Q's terms and two of each ring fit (DP < 120)
  static constexpr int kStages =
      2 * kBQ * DP * 4 + 2 * 4 * kBK * DP * 4 + 1024 + 8 * 11 <= 232448 &&
              DP < 128
          ? 2
          : 1;
  // output columns per P V wgmma: at d = 160 two halves of 80, so that the
  // fresh accumulator of a key tile's P V stays 40 registers
  static constexpr int kPVN = DP == 160 ? 80 : DP;
  static constexpr int kQChunk = kBQ * W * 4, kKChunk = kBK * W * 4;
  static constexpr int kVChunk = DP * 128;  // 32 keys of every v^T row
  static constexpr int kQTerm = kBQ * DP * 4;  // one term of the Q tile
  static constexpr int kKTerm = kBK * DP * 4;  // one term of a K tile
  static constexpr int kVTerm = DP * kBK * 4;  // one term of a v^T tile
  static constexpr int kKOff = 2 * kQTerm;
  static constexpr int kVOff = kKOff + kStages * 2 * kKTerm;
  static constexpr int kBiasOff = kVOff + kStages * 2 * kVTerm;
  static constexpr int kBarOff = kBiasOff + (HAS_BIAS ? kBQ * kBK * 4 : 0);
  // Q full; K full and empty, V full and empty per stage; bias full, empty
  static constexpr int kBars = 1 + 4 * kStages + 2;
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(DP % 8 == 0 && DP <= 160, "head dim");
  static_assert(!HAS_BIAS || DP == 64, "the bias form: d = 64");
};

struct Params {
  float* out;
  float* lse;
  int B, H, Lq, Lk, n_qt;
  int d;            // the head dim; columns d .. DP - 1 are padding
  long long os[3];  // out's (batch, head, seq) element strides
  float scale;
  PosArgs pos;       // MASKED only; null offsets read as 0
  fdsd::MaskArgs m;  // HAS_BIAS only: the fp32 bias and its strides
};

// logit = scale * s + bias in fp32, for this thread's tile rows rl0, rl1.
template <int BK>
__device__ __forceinline__ void add_bias(float (&s)[BK / 2], const float* tile,
                                         int rl0, int rl1, int t,
                                         float scale) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 b0 = s9::load_pair(tile + s9::bias_at<BK>(rl0, c));
    const float2 b1 = s9::load_pair(tile + s9::bias_at<BK>(rl1, c));
    s[4 * j] = fmaf(s[4 * j], scale, b0.x);
    s[4 * j + 1] = fmaf(s[4 * j + 1], scale, b0.y);
    s[4 * j + 2] = fmaf(s[4 * j + 2], scale, b1.x);
    s[4 * j + 3] = fmaf(s[4 * j + 3], scale, b1.y);
  }
}

template <int DP, bool MASKED, bool BOUNDED, bool HAS_BIAS>
__global__ void __launch_bounds__(Cfg<DP>::kThreads, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ Params p) {
  using C = Cfg<DP, HAS_BIAS>;
  constexpr int BK = C::kBK, S = C::kStages, BQ = C::kBQ;
  // a logit at -1e30 is a masked one, selected to probability 0
  constexpr bool kSelect = MASKED || HAS_BIAS;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* bias_s =
      reinterpret_cast<float*>(smem_raw + (base - raw) + C::kBiasOff);
  const uint32_t q_s = base, k_s = base + C::kKOff, v_s = base + C::kVOff;
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t kfull0 = q_full + 8, kempty0 = kfull0 + 8 * S;
  const uint32_t vfull0 = kempty0 + 8 * S, vempty0 = vfull0 + 8 * S;
  const uint32_t bias_full = vempty0 + 8 * S, bias_empty = bias_full + 8;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / p.n_qt;
  int qt = blockIdx.x % p.n_qt;
  if (MASKED && p.pos.causal) qt = p.n_qt - 1 - qt;  // long rows first
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * BQ;

  if (tid == 0) {
    s9::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      s9::mbar_init(kfull0 + 8 * s, 1);
      s9::mbar_init(kempty0 + 8 * s, C::kConsumers);
      s9::mbar_init(vfull0 + 8 * s, 1);
      s9::mbar_init(vempty0 + 8 * s, C::kConsumers);
    }
    if (HAS_BIAS) {
      s9::mbar_init(bias_full, 128);
      s9::mbar_init(bias_empty, C::kConsumers);
    }
    s9::mbar_init_fence();
  } else if (tid == 32) {  // fetch the descriptors while barriers are set up
    s9::prefetch_tensormap(&tq);
    s9::prefetch_tensormap(&tk);
    s9::prefetch_tensormap(&tv);
  }
  __syncthreads();

  // Positions matter only to a mask: without causal and valid_len every
  // pair is visible (the key tail aside) and the offsets are not read.
  const bool masked = MASKED && (p.pos.causal || p.pos.has_valid);
  int q_off0 = 0, q_off1 = 0, k_off0 = 0, k_off1 = 0;
  if (masked && p.pos.q_off != nullptr) {
    q_off0 = p.pos.q_off[0];
    q_off1 = p.pos.q_off[1];
  }
  if (masked && p.pos.k_off != nullptr) {
    k_off0 = p.pos.k_off[0];
    k_off1 = p.pos.k_off[1];
  }
  const int n_kt = (p.Lk + BK - 1) / BK;
  // pos_pair of this query tile with key tile kt: 0 skip, 1 visible, 2
  // masked per logit; the same call in every role keeps the rings in step.
  auto pair = [&](int kt) {
    if (!masked) return 1;
    int q_lo, q_hi, k_lo, k_hi;
    pos_bounds(q0, BQ, q_off0, q_off1, p.pos.seg_q, p.Lq, q_lo, q_hi);
    pos_bounds(kt * BK, BK, k_off0, k_off1, p.pos.seg_k, p.Lk, k_lo, k_hi);
    return pos_pair(p.pos, q_lo, q_hi, k_lo, k_hi);
  };

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    // One thread issues TMA; in the bias form all 128 stage the bias tile
    // by cp.async, as the bf16 K1's producer does.
    s9::reg_dealloc<kProducerRegs>();
    if (!HAS_BIAS && tid != 0) return;
    if (tid == 0) {
      s9::mbar_expect_tx(q_full, 2 * C::kQTerm);
      for (int term = 0; term < 2; ++term)
        for (int c = 0; c < C::kChunks; ++c)
          s9::tma_load_4d(q_s + term * C::kQTerm + c * C::kQChunk, &tq,
                          q_full, c * C::W, q0, h, b + term * p.B);
    }
    const long long bias_base = HAS_BIAS ? b * p.m.bs[0] + h * p.m.bs[1] : 0;
    int stage = 0;
    uint32_t phase = 0, bias_phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      if (pair(kt) == 0) continue;
      const int k0 = kt * BK;
      if (tid == 0) {
        const uint32_t kfull = kfull0 + 8 * stage, vfull = vfull0 + 8 * stage;
        s9::mbar_wait(kempty0 + 8 * stage, phase ^ 1);
        s9::mbar_expect_tx(kfull, 2 * C::kKTerm);
        for (int term = 0; term < 2; ++term)
          for (int c = 0; c < C::kChunks; ++c)
            s9::tma_load_4d(
                k_s + (2 * stage + term) * C::kKTerm + c * C::kKChunk, &tk,
                kfull, c * C::W, k0, h, b + term * p.B);
        s9::mbar_wait(vempty0 + 8 * stage, phase ^ 1);
        s9::mbar_expect_tx(vfull, 2 * C::kVTerm);
        for (int term = 0; term < 2; ++term)
          for (int kc = 0; kc < BK / 32; ++kc)
            s9::tma_load_4d(
                v_s + (2 * stage + term) * C::kVTerm + kc * C::kVChunk, &tv,
                vfull, k0 + 32 * kc, 0, h, b + term * p.B);
      }
      if constexpr (HAS_BIAS) {
        s9::mbar_wait(bias_empty, bias_phase ^ 1);
        s9::stage_bias<BQ, BK>(bias_s, p.m, bias_base, q0, k0, p.Lq, p.Lk,
                               tid, bias_full);
        bias_phase ^= 1;
      }
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    s9::reg_alloc<kConsumerRegs>();
    const int cw = (tid - 128) / 128;  // query rows 64*cw .. 64*cw + 63
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl0 = 64 * cw + 16 * warp + g, rl1 = rl0 + 8;  // tile rows
    const int r0 = q0 + rl0, r1 = q0 + rl1;
    // exp(x * scale) = exp2(x * c); with a bias the logits are scaled first
    const float c = HAS_BIAS ? kLog2e : p.scale * kLog2e;
    int qpos0 = 0, qpos1 = 0;
    if (masked) {
      qpos0 = pos_of(r0, q_off0, q_off1, p.pos.seg_q);
      qpos1 = pos_of(r1, q_off0, q_off1, p.pos.seg_q);
    }
    // running row max (logit units; bounded: fixed at 0) and this thread's
    // share of the row sums
    float m0 = BOUNDED ? 0.f : kNegInf, m1 = m0;
    float l0 = 0.f, l1 = 0.f;
    float o[DP / 2], pv[C::kPVN / 2];  // O, and one chunk of a tile's P V
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float s[BK / 2];
    const uint32_t q_rows = q_s + cw * 64 * C::W * 4;  // this group's rows

    s9::mbar_wait(q_full, 0);  // also when no tile is visited: TMA is done
    int stage = 0;
    uint32_t phase = 0, bias_phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int state = pair(kt);
      if (state == 0) continue;
      const int k0 = kt * BK;
      const uint32_t ks = k_s + 2 * stage * C::kKTerm;
      const uint32_t vs = v_s + 2 * stage * C::kVTerm;
      s9::mbar_wait(kfull0 + 8 * stage, phase);

      // S = Q K^T in three passes: Q_lo K_hi + Q_hi K_lo + Q_hi K_hi.
      s9::fence_regs(s);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const uint32_t qa = q_rows + (kk * 8 / C::W) * C::kQChunk +
                            (kk * 8 % C::W) * 4;
        const uint32_t ka =
            ks + (kk * 8 / C::W) * C::kKChunk + (kk * 8 % C::W) * 4;
        const uint64_t qh = s9::smem_desc(qa, 16, C::kAtom, C::kLayout);
        const uint64_t ql =
            s9::smem_desc(qa + C::kQTerm, 16, C::kAtom, C::kLayout);
        const uint64_t kh = s9::smem_desc(ka, 16, C::kAtom, C::kLayout);
        const uint64_t kl =
            s9::smem_desc(ka + C::kKTerm, 16, C::kAtom, C::kLayout);
        s9::wgmma_tf32_ss<BK>(s, ql, kh, kk > 0);
        s9::wgmma_tf32_ss<BK>(s, qh, kl, 1);
        s9::wgmma_tf32_ss<BK>(s, qh, kh, 1);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(s);
      s9::mbar_arrive(kempty0 + 8 * stage);  // K of this stage is read

      if (HAS_BIAS) {  // logit = scale * s + bias, in fp32
        s9::mbar_wait(bias_full, bias_phase);
        add_bias<BK>(s, bias_s, rl0, rl1, t, p.scale);
        s9::mbar_arrive(bias_empty);
        bias_phase ^= 1;
      }

      // Per-logit masks (the key tail; valid_len and causal by position),
      // only on the tiles that need them. The key tail is masked after the
      // bias, which narrows it and never replaces it.
      if (k0 + BK > p.Lk || state == 2) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * t + e;
            bool v0 = col < p.Lk, v1 = v0;
            if (masked) {
              const int cpos = pos_of(col, k_off0, k_off1, p.pos.seg_k);
              if (p.pos.has_valid && cpos >= p.pos.valid_len) v0 = v1 = false;
              if (p.pos.causal) {
                v0 = v0 && cpos <= qpos0;
                v1 = v1 && cpos <= qpos1;
              }
            }
            if (!v0) s[4 * j + e] = kNegInf;
            if (!v1) s[4 * j + 2 + e] = kNegInf;
          }
        }
      }

      // The softmax in fp32 registers: online (running max, rescale of l
      // and O) or bounded (max fixed at 0). A logit at -1e30 (or -inf, from
      // a bias) is masked and selected to probability 0; a row with nothing
      // visible yet subtracts 0. P is split into TF32 hi / lo A fragments
      // of P V: accumulator columns (2t, 2t + 1) of a k-step are the
      // fragment's (t, t + 4).
      float al0 = 1.f, al1 = 1.f, sub0 = 0.f, sub1 = 0.f;
      if (!BOUNDED) {
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float mu0 = kSelect && mn0 <= kNegInf ? 0.f : mn0;
        const float mu1 = kSelect && mn1 <= kNegInf ? 0.f : mn1;
        al0 = s9::exp2_approx((m0 - mu0) * c);
        al1 = s9::exp2_approx((m1 - mu1) * c);
        m0 = mn0;
        m1 = mn1;
        sub0 = mu0 * c;
        sub1 = mu1 * c;
      }
      uint32_t ph[BK / 8][4], pl[BK / 8][4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * j + e];
          float pr = s9::exp2_approx(fmaf(x, c, -(e < 2 ? sub0 : sub1)));
          if (kSelect && x <= kNegInf) pr = 0.f;  // selected, not exp'd
          if (e < 2)
            sum0 += pr;
          else
            sum1 += pr;
          const int f = (e & 1) * 2 + (e >> 1);  // fragment register
          ph[j][f] = s9::to_tf32(pr);
          pl[j][f] = s9::to_tf32(pr - __uint_as_float(ph[j][f]));
        }
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;

      // This tile's P V in three passes, P_lo V_hi + P_hi V_lo + P_hi V_hi,
      // into a fresh accumulator per chunk of kPVN output columns; v^T
      // K-major, the k-step kk is keys 8kk .. 8kk + 7. Then O = alpha O +
      // P V in registers.
      s9::mbar_wait(vfull0 + 8 * stage, phase);
#pragma unroll
      for (int nc = 0; nc < DP / C::kPVN; ++nc) {
        s9::fence_regs(pv);
        s9::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const uint32_t va = vs + (kk / 4) * C::kVChunk + (kk % 4) * 32 +
                              nc * C::kPVN * 128;
          const uint64_t vh = s9::smem_desc(va, 16, 1024, 1);
          const uint64_t vl = s9::smem_desc(va + C::kVTerm, 16, 1024, 1);
          s9::wgmma_tf32_rs<C::kPVN>(pv, pl[kk], vh, kk > 0);
          s9::wgmma_tf32_rs<C::kPVN>(pv, ph[kk], vl, 1);
          s9::wgmma_tf32_rs<C::kPVN>(pv, ph[kk], vh, 1);
        }
        s9::wgmma_commit();
        s9::wgmma_wait<0>();
        s9::fence_regs(pv);
        float* oc = o + nc * (C::kPVN / 2);
#pragma unroll
        for (int j = 0; j < C::kPVN / 8; ++j) {
          oc[4 * j] = fmaf(oc[4 * j], al0, pv[4 * j]);
          oc[4 * j + 1] = fmaf(oc[4 * j + 1], al0, pv[4 * j + 1]);
          oc[4 * j + 2] = fmaf(oc[4 * j + 2], al1, pv[4 * j + 2]);
          oc[4 * j + 3] = fmaf(oc[4 * j + 3], al1, pv[4 * j + 3]);
        }
      }
      s9::mbar_arrive(vempty0 + 8 * stage);  // v^T of this stage is read
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue: O / l in fp32 through out's strides; lse = m scale + log l
    // (m in scaled units with a bias); a row with l = 0 gives out = 0 and
    // lse = -1e30.
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    const float to_ln = HAS_BIAS ? 1.f : p.scale;
    float* ob = p.out + b * p.os[0] + h * p.os[1];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p.d) continue;
      if (r0 < p.Lq)
        *reinterpret_cast<float2*>(ob + r0 * p.os[2] + col) =
            make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < p.Lq)
        *reinterpret_cast<float2*>(ob + r1 * p.os[2] + col) =
            make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    float* lb = p.lse + static_cast<long long>(bh) * p.Lq;
    if (t == 0) {
      if (r0 < p.Lq) lb[r0] = l0 == 0.f ? kNegInf : m0 * to_ln + logf(l0);
      if (r1 < p.Lq) lb[r1] = l1 == 0.f ? kNegInf : m1 * to_ln + logf(l1);
    }
  }
}

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
  fdsd::f32fwd::wide_body<DP, false>(tq, tk, tv, p);
}

// The key splits of one row, merged by their lse: out = sum_s w_s O_s with
// w_s = exp(lse_s - lse), lse = log sum_s exp(lse_s). One block of 64
// threads per row, 8 columns a thread.
__global__ void __launch_bounds__(64)
merge_f32_d512_kernel(const float* __restrict__ work, float* __restrict__ out,
                      float* __restrict__ lse, int H, int Lq, int splits,
                      long long rows, long long os0, long long os1,
                      long long os2) {
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
  float* ob = out + b * os0 + h * os1 + r * os2 + col;
  reinterpret_cast<float4*>(ob)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  reinterpret_cast<float4*>(ob)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
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

// The tensor maps of the terms: q and k (d, L, H, 2B), box W columns x
// `rows`; v^T (lk8, d, H, 2B), box 32 keys x `vt_rows` rows.
cudaError_t term_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
                      const Work& w, int B, int H, int Lq, int Lk, int d,
                      int W, int q_rows, int k_rows, int vt_rows) {
  const CUtensorMapSwizzle sw =
      W == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const long long sq[3] = {static_cast<long long>(H) * Lq * d,
                           static_cast<long long>(Lq) * d, d};
  const long long sk[3] = {static_cast<long long>(H) * Lk * d,
                           static_cast<long long>(Lk) * d, d};
  const long long sv[3] = {static_cast<long long>(H) * d * w.lk8,
                           static_cast<long long>(d) * w.lk8, w.lk8};
  cudaError_t err =
      s9::make_map(tq, w.q, d, Lq, H, 2 * B, sq, W, q_rows, sw, f32);
  if (err == cudaSuccess)
    err = s9::make_map(tk, w.k, d, Lk, H, 2 * B, sk, W, k_rows, sw, f32);
  if (err == cudaSuccess)
    err = s9::make_map(tv, w.vt, w.lk8, d, H, 2 * B, sv, 32, vt_rows,
                       CU_TENSOR_MAP_SWIZZLE_128B, f32);
  return err;
}

template <int DP, bool MASKED = false, bool BOUNDED = false,
          bool HAS_BIAS = false>
cudaError_t run(const Work& w, Params p, cudaStream_t s) {
  using C = Cfg<DP, HAS_BIAS>;
  p.n_qt = (p.Lq + C::kBQ - 1) / C::kBQ;
  CUtensorMap tq, tk, tv;
  const cudaError_t err = term_maps(&tq, &tk, &tv, w, p.B, p.H, p.Lq, p.Lk,
                                    p.d, C::W, C::kBQ, C::kBK, DP);
  if (err != cudaSuccess) return err;
  return s9::launch_kernel(flash_fwd_f32_kernel<DP, MASKED, BOUNDED, HAS_BIAS>,
                           p.B * p.H * p.n_qt, C::kThreads, C::kSmemBytes, s,
                           tq, tk, tv, p);
}

// K1 on the streaming kernel at width DP (192, 224, 256; 512 with its key
// splits and their merge).
template <int DP>
cudaError_t run_stream(const Work& w, const Params& q, int splits,
                       bool causal, cudaStream_t s) {
  using C = fdsd::f32fwd::WideCfg<DP>;
  if (splits < 1 || splits > d512::kMaxSplits || (DP != 512 && splits > 1))
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
  CUtensorMap tq, tk, tv;
  cudaError_t err = term_maps(&tq, &tk, &tv, w, q.B, q.H, q.Lq, q.Lk, q.d,
                              32, C::kBQ, C::kBK, C::kVRows);
  if (err != cudaSuccess) return err;
  if constexpr (DP != 512) {
    return fdsd::f32fwd::launch_wide<DP>(causal, tq, tk, tv, p, s);
  } else {
    if (causal) return cudaErrorInvalidValue;
    err = s9::launch_kernel(d512::flash_fwd_f32_d512_kernel,
                            q.B * q.H * p.n_qt * splits,
                            fdsd::f32fwd::kWideThreads, C::kSmemBytes, s, tq,
                            tk, tv, p);
    if (err == cudaSuccess && splits > 1) {
      d512::merge_f32_d512_kernel<<<static_cast<unsigned>(p.rows),
                                     d512::DP / 8, 0, s>>>(
          p.work, p.out, p.lse, q.H, q.Lq, splits, p.rows, p.os[0], p.os[1],
          p.os[2]);
      err = cudaGetLastError();
    }
    return err;
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

// K1 at the width DP, without a mask or causal (the position mask with
// offsets 0).
template <int DP>
cudaError_t run_width(const Work& w, Params p, bool causal, cudaStream_t s) {
  if (!causal) return run<DP>(w, p, s);
  p.pos.causal = 1;
  return run<DP, true>(w, p, s);
}

}  // namespace

// K1 in fp32. strides: 16 element strides, (batch, head, seq) for q, k, v,
// out, each a multiple of 4 (the head-dim stride is 1), then (batch, head,
// row, col) for the bias. lse is (B, H, Lq) contiguous fp32. bias: fp32,
// read through its strides (0 on a broadcast axis), or null. work: fp32
// scratch of 2 B H (Lq + Lk) d + 2 B H d Lk8 floats (Lk8: Lk rounded up to
// 8), plus splits * B * H * Lq * 513 at d = 512 with splits > 1 (1 to 4 key
// splits per 64-query tile; ignored at other head dims). Every head dim up to
// 256 that is a multiple of 4 without a mask or causal, 512 without a mask,
// 64 with a bias; others return cudaErrorInvalidValue.
extern "C" int fdsd_flash_fwd_f32(const void* q, const void* k, const void* v,
                                  void* out, void* lse, void* work,
                                  const void* bias, int B, int H, int Lq,
                                  int Lk, int d, const long long* strides,
                                  float scale, int causal, int splits,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p = fwd_params(out, lse, B, H, Lq, Lk, d, strides, scale);
  const Work w = carve(work, B, H, Lq, Lk, d);
  const bool width = (d >= 4 && d <= 256 && d % 4 == 0) || d == 512;
  if (!width || (bias != nullptr && (d != 64 || causal)) ||
      (causal && d == 512))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = split_inputs(q, k, v, strides, B, H, Lq, Lk, d, w, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bias != nullptr) {  // T5's relative-position bias
    p.m = fdsd::make_mask_args(bias, strides + 12, 0, nullptr, nullptr,
                               nullptr, nullptr, nullptr, nullptr);
    return static_cast<int>(run<64, false, false, true>(w, p, s));
  }
  const bool c = causal != 0;
  switch (d) {  // the widths at DP = d
    case 8:  // the `checks sd1` UNet (model_channels 64, 8 heads)
      return static_cast<int>(run_width<8>(w, p, c, s));
    case 40:  // SD1 UNet at 64^2
      return static_cast<int>(run_width<40>(w, p, c, s));
    case 48:
      return static_cast<int>(run_width<48>(w, p, c, s));
    case 64:  // SigLIP tower, TinyVLM decoder
      return static_cast<int>(run_width<64>(w, p, c, s));
    case 72:
      return static_cast<int>(run_width<72>(w, p, c, s));
    case 80:  // SD1 UNet at 32^2
      return static_cast<int>(run_width<80>(w, p, c, s));
    case 128:  // tiny-SD UNet
      return static_cast<int>(run_width<128>(w, p, c, s));
    case 160:  // SD1 UNet level 2, from 768^2 images
      return static_cast<int>(run_width<160>(w, p, c, s));
    case 512:  // the VAEs' mid attention
      return static_cast<int>(run_stream<512>(w, p, splits, c, s));
  }
  if (d > 160) {  // the streaming kernel at d rounded up to 32
    switch ((d + 31) / 32 * 32) {
      case 192:  // tiny-SD UNet at channel 96, 32^2
        return static_cast<int>(run_stream<192>(w, p, 1, c, s));
      case 224:
        return static_cast<int>(run_stream<224>(w, p, 1, c, s));
      default:
        return static_cast<int>(run_stream<256>(w, p, 1, c, s));
    }
  }
  switch ((d + 15) / 16 * 16) {  // the others, padded to a width
    case 16:
      return static_cast<int>(run_width<16>(w, p, c, s));
    case 32:
      return static_cast<int>(run_width<32>(w, p, c, s));
    case 48:
      return static_cast<int>(run_width<48>(w, p, c, s));
    case 64:
      return static_cast<int>(run_width<64>(w, p, c, s));
    case 80:
      return static_cast<int>(run_width<80>(w, p, c, s));
    case 96:  // tiny-SD UNet at channel 96, 64^2
      return static_cast<int>(run_width<96>(w, p, c, s));
    case 112:
      return static_cast<int>(run_width<112>(w, p, c, s));
    case 128:
      return static_cast<int>(run_width<128>(w, p, c, s));
    case 144:
      return static_cast<int>(run_width<144>(w, p, c, s));
    default:
      return static_cast<int>(run_width<160>(w, p, c, s));
  }
}

// K5 in fp32: the arguments of fdsd_flash_fwd_pos on fp32 tensors, with the
// workspace of fdsd_flash_fwd_f32 after the offsets. Head dim 64.
extern "C" int fdsd_flash_fwd_pos_f32(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      const void* q_off, const void* k_off,
                                      void* work, int B, int H, int Lq,
                                      int Lk, int d, const long long* strides,
                                      float scale, int seg_q, int seg_k,
                                      int valid_len, int has_valid,
                                      int causal, int bounded, void* stream) {
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p = fwd_params(out, lse, B, H, Lq, Lk, d, strides, scale);
  p.pos = PosArgs{static_cast<const int*>(q_off),
                  static_cast<const int*>(k_off), seg_q, seg_k, valid_len,
                  has_valid, causal};
  const Work w = carve(work, B, H, Lq, Lk, d);
  cudaError_t err = split_inputs(q, k, v, strides, B, H, Lq, Lk, d, w, s);
  if (err == cudaSuccess)
    err = bounded ? run<64, true, true>(w, p, s) : run<64, true>(w, p, s);
  return static_cast<int>(err);
}
