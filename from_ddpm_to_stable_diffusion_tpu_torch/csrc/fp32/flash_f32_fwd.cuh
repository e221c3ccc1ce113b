// The fp32 flash forward's resident kernel (flash_fwd_f32_kernel): K1 and K5
// on fp32 inputs on the tensor cores at head dims up to 160, with Q's split
// terms resident for the whole key loop; the design notes are in
// flash_f32_fwd.cu, which holds the C entries, the split pre-pass, the d =
// 512 kernel and T5's bias form. Its forms are instantiated a few widths to
// a file in flash_f32_fwd_w*.cu, so that the build compiles them in
// parallel: without a mask and masked (K1 causal, K5 online; run_plain) at
// 13 widths, and K5 bounded and ANY (K1 with an fp32 bias read from global
// memory and segment ids, with causal or not; run_masks) at 32, 64, 96,
// 128, 160 (every head dim up to 160 rounded up to 32).

#pragma once

#include "../mask.cuh"
#include "../pos_tile.cuh"
#include "../sm90.cuh"
#include "flash_f32_fwd_wide.cuh"

namespace fdsd::f32fwd {

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

inline Work carve(void* work, int B, int H, int Lq, int Lk, int d) {
  Work w;
  w.lk8 = (Lk + 7) / 8 * 8;  // kKeyGroup
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
// take 160 KB. HAS_BIAS adds a (kBQ x kBK) fp32 bias tile (T5's form).
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
  fdsd::MaskArgs m;  // HAS_BIAS: the fp32 bias; ANY: bias and segment ids
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

// MASKED: the position masks (K1's causal, K5); ANY (with MASKED): also an
// fp32 bias read from global memory through its strides and segment ids,
// each where the launch asks for it (p.m), segment tiles at (kBQ, kBK).
template <int DP, bool MASKED, bool BOUNDED, bool HAS_BIAS, bool ANY = false>
__global__ void __launch_bounds__(Cfg<DP>::kThreads, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ Params p) {
  using C = Cfg<DP, HAS_BIAS>;
  constexpr int BK = C::kBK, S = C::kStages, BQ = C::kBQ;
  // a logit at -1e30 is a masked one, selected to probability 0
  constexpr bool kSelect = MASKED || HAS_BIAS;
  static_assert(!ANY || (MASKED && !BOUNDED && !HAS_BIAS), "the ANY form");
  const bool any_bias = ANY && p.m.bias != nullptr;
  const bool has_seg = ANY && p.m.q_ids != nullptr;

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
  // ANY: segment ids walk the key tiles [lo, hi] of mask.cuh and skip a
  // tile whose ids are disjoint from this query tile's
  int kt_lo = 0, kt_hi = n_kt - 1;
  const int* q_bound = nullptr;
  const int* k_bounds = nullptr;
  if (has_seg) {
    const int tile = b * p.n_qt + qt;
    kt_lo = p.m.lo[tile];
    kt_hi = p.m.hi[tile];
    q_bound = p.m.q_bounds + 2 * tile;
    k_bounds = p.m.kv_bounds + 2 * b * n_kt;
  }
  // pos_pair of this query tile with key tile kt: 0 skip, 1 visible, 2
  // masked per logit (ANY: also by segment ids); the same call in every
  // role keeps the rings in step.
  auto pair = [&](int kt) {
    int state = 1;
    if (masked) {
      int q_lo, q_hi, k_lo, k_hi;
      pos_bounds(q0, BQ, q_off0, q_off1, p.pos.seg_q, p.Lq, q_lo, q_hi);
      pos_bounds(kt * BK, BK, k_off0, k_off1, p.pos.seg_k, p.Lk, k_lo,
                 k_hi);
      state = pos_pair(p.pos, q_lo, q_hi, k_lo, k_hi);
    }
    if (has_seg && state != 0)
      state = kt >= kt_lo && kt <= kt_hi &&
                      seg_overlap(q_bound, k_bounds + 2 * kt)
                  ? 2
                  : 0;
    return state;
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
    const float c = HAS_BIAS || any_bias ? kLog2e : p.scale * kLog2e;
    int qpos0 = 0, qpos1 = 0;
    if (masked) {
      qpos0 = pos_of(r0, q_off0, q_off1, p.pos.seg_q);
      qpos1 = pos_of(r1, q_off0, q_off1, p.pos.seg_q);
    }
    // ANY: this thread's rows' segment ids, the key ids, the bias's base
    const int* kv_ids = nullptr;
    int qid0 = -1, qid1 = -1;
    if (has_seg) {
      kv_ids = p.m.kv_ids + static_cast<long long>(b) * p.Lk;
      const int* ids = p.m.q_ids + static_cast<long long>(b) * p.Lq;
      if (r0 < p.Lq) qid0 = ids[r0];
      if (r1 < p.Lq) qid1 = ids[r1];
    }
    const long long bias_base = any_bias ? b * p.m.bs[0] + h * p.m.bs[1] : 0;
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
      if (any_bias) {  // the same from global memory (L2), row by row
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            const int row = e < 2 ? r0 : r1;
            const float bias = row < p.Lq && col < p.Lk
                                   ? load_bias(p.m, bias_base, row, col)
                                   : 0.f;
            s[4 * j + e] = fmaf(s[4 * j + e], p.scale, bias);
          }
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
            if (has_seg && col < p.Lk) {
              const int kid = kv_ids[col];
              v0 = v0 && kid == qid0;
              v1 = v1 && kid == qid1;
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
    const float to_ln = HAS_BIAS || any_bias ? 1.f : p.scale;
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

// The tensor maps of the terms: q and k (d, L, H, 2B), box W columns x
// `rows`; v^T (lk8, d, H, 2B), box 32 keys x `vt_rows` rows.
inline cudaError_t term_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
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

// One launch of the kernel at width DP in a form, on the split terms in w;
// sets p.n_qt.
template <int DP, bool MASKED = false, bool BOUNDED = false,
          bool HAS_BIAS = false, bool ANY = false>
cudaError_t run(const Work& w, Params p, cudaStream_t s) {
  using C = Cfg<DP, HAS_BIAS>;
  p.n_qt = (p.Lq + C::kBQ - 1) / C::kBQ;
  CUtensorMap tq, tk, tv;
  const cudaError_t err = term_maps(&tq, &tk, &tv, w, p.B, p.H, p.Lq, p.Lk,
                                    p.d, C::W, C::kBQ, C::kBK, DP);
  if (err != cudaSuccess) return err;
  return s9::launch_kernel(
      flash_fwd_f32_kernel<DP, MASKED, BOUNDED, HAS_BIAS, ANY>,
      p.B * p.H * p.n_qt, C::kThreads, C::kSmemBytes, s, tq, tk, tv, p);
}

// Without a mask, or masked (K1's causal, K5 online), at width DP: the 13
// widths of every head dim up to 160 (8, 40, 48, 64, 72, 80, 128, 160 at
// DP = d, the rest rounded up to 16).
template <int DP>
cudaError_t run_plain(bool masked, const Work& w, const Params& p,
                      cudaStream_t s) {
  return masked ? run<DP, true>(w, p, s) : run<DP>(w, p, s);
}

// The forms added at the widths 32, 64, 96, 128, 160 (every head dim up to
// 160 rounded up to 32): bounded K5 (the position masks under the fixed
// max), else ANY (K1 with a bias or segment ids, causal or not).
template <int DP>
cudaError_t run_masks(bool bounded, const Work& w, const Params& p,
                      cudaStream_t s) {
  return bounded ? run<DP, true, true>(w, p, s)
                 : run<DP, true, false, false, true>(w, p, s);
}

// The explicit instantiations of run_plain<DP> and run_masks<DP> (P: empty,
// or `extern` for their declarations); the widths are instantiated a few to
// a file in flash_f32_fwd_w*.cu.
#define FDSD_F32_FWD_PLAIN(P, DP)                                           \
  P template cudaError_t run_plain<DP>(bool, const Work&, const Params&,   \
                                       cudaStream_t);
#define FDSD_F32_FWD_MASKS(P, DP)                                           \
  P template cudaError_t run_masks<DP>(bool, const Work&, const Params&,   \
                                       cudaStream_t);
#define FDSD_F32_FWD_PLAIN_WIDTHS(X)                                        \
  X(8) X(16) X(32) X(40) X(48) X(64) X(72) X(80) X(96) X(112) X(128)      \
  X(144) X(160)
#define FDSD_F32_FWD_MASK_WIDTHS(X) X(32) X(64) X(96) X(128) X(160)
#define FDSD_F32_FWD_PLAIN_EXTERN(DP) FDSD_F32_FWD_PLAIN(extern, DP)
#define FDSD_F32_FWD_MASKS_EXTERN(DP) FDSD_F32_FWD_MASKS(extern, DP)
FDSD_F32_FWD_PLAIN_WIDTHS(FDSD_F32_FWD_PLAIN_EXTERN)
FDSD_F32_FWD_MASK_WIDTHS(FDSD_F32_FWD_MASKS_EXTERN)
#undef FDSD_F32_FWD_PLAIN_EXTERN
#undef FDSD_F32_FWD_MASKS_EXTERN


}  // namespace fdsd::f32fwd
