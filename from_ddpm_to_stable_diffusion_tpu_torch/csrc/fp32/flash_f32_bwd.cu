// Flash-attention backward on fp32 inputs for Hopper (sm_90a) on the tensor
// cores: the fp32 form of K3 (dq) and K4 (dk, dv), plain and causal at
// every head dim up to 256, and of K6 / K7 (position masks under a
// caller-supplied global lse and delta) at 64. This file holds the kernels up
// to 128, the split pre-pass, the dispatch and the C entries; head dims 129
// to 256 take the kernels of flash_f32_bwd.cuh (one cluster of two blocks,
// each owning half of the columns: above 128 the resident Q and dO (dq) or K
// and V (dk / dv) terms of a 64-row tile no longer fit in one block beside
// the rings), instantiated in flash_f32_bwd_w*.cu.
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
// offsets 0. Query rows past Lq get lse = +1e30 (P = 0); keys past Lk are
// selected to P = 0.

#include "flash_f32_bwd.cuh"
#include "split_f32.cuh"

namespace {

using namespace fdsd::f32bwd;

// ------------------------------------------------------------- K3 / K6: dq
template <int DP>
struct DqCfg {
  static constexpr int kCons = DP <= 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int kBQ = 64 * kCons, kBK = 32;
  static constexpr int kThreads = 128 * (1 + kCons);
  static constexpr int kConsumers = 128 * kCons;
  static constexpr int kConsumerRegs = kCons == 2 ? 232 : 240;
  static constexpr int kStages = DP <= 64 ? 2 : 1;
  using TQ = Tile<kBQ, DP>;   // Q, dO
  using TK = Tile<kBK, DP>;   // K, V
  using TKT = Tile<DP, kBK>;  // K^T
  static constexpr int kGOff = 2 * TQ::kBytes;
  static constexpr int kAOff = 4 * TQ::kBytes;  // ring A: K, V per stage
  static constexpr int kAStage = 4 * TK::kBytes;
  static constexpr int kBOff = kAOff + kStages * kAStage;  // ring B: K^T
  static constexpr int kBStage = 2 * TKT::kBytes;
  static constexpr int kBarOff = kBOff + kStages * kBStage;
  // Q / dO full; A full, empty; B full, empty per stage
  static constexpr int kBars = 1 + 4 * kStages;
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(DP % 16 == 0 && DP <= 128, "head dim");
};

template <int DP, bool MASKED>
__global__ void __launch_bounds__(DqCfg<DP>::kThreads, 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tkt,
                        const __grid_constant__ Params p) {
  using C = DqCfg<DP>;
  using TQ = typename C::TQ;
  using TK = typename C::TK;
  using TKT = typename C::TKT;
  constexpr int BQ = C::kBQ, BK = C::kBK, S = C::kStages;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (s9::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, g_s = base + C::kGOff;
  const uint32_t a_s = base + C::kAOff, b_s = base + C::kBOff;
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t afull0 = q_full + 8, aempty0 = afull0 + 8 * S;
  const uint32_t bfull0 = aempty0 + 8 * S, bempty0 = bfull0 + 8 * S;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / p.n_tiles;
  int qt = blockIdx.x % p.n_tiles;
  if (MASKED && p.pos.causal) qt = p.n_tiles - 1 - qt;  // long rows first
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * BQ;

  if (tid == 0) {
    s9::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      s9::mbar_init(afull0 + 8 * s, 1);
      s9::mbar_init(aempty0 + 8 * s, C::kConsumers);
      s9::mbar_init(bfull0 + 8 * s, 1);
      s9::mbar_init(bempty0 + 8 * s, C::kConsumers);
    }
    s9::mbar_init_fence();
  } else if (tid == 32) {  // fetch the descriptors while barriers are set up
    s9::prefetch_tensormap(&tq);
    s9::prefetch_tensormap(&tg);
    s9::prefetch_tensormap(&tk);
    s9::prefetch_tensormap(&tv);
    s9::prefetch_tensormap(&tkt);
  }
  __syncthreads();

  // Positions matter only to a mask: without causal and valid_len every
  // pair is visible (the key tail aside) and the offsets are not read.
  const bool masked = MASKED && (p.pos.causal || p.pos.has_valid);
  const Offsets off(p.pos, masked);
  const int n_kt = (p.Lk + BK - 1) / BK;
  auto pair = [&](int kt) {
    return tile_pair(p, off, masked, q0, BQ, kt * BK, BK);
  };

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid != 0) return;
    s9::mbar_expect_tx(q_full, 4 * TQ::kBytes);
    TQ::load(q_s, &tq, q_full, 0, q0, h, b, p.B);
    TQ::load(g_s, &tg, q_full, 0, q0, h, b, p.B);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      if (pair(kt) == 0) continue;
      const int k0 = kt * BK;
      const uint32_t afull = afull0 + 8 * stage, bfull = bfull0 + 8 * stage;
      const uint32_t as = a_s + stage * C::kAStage;
      s9::mbar_wait(aempty0 + 8 * stage, phase ^ 1);
      s9::mbar_expect_tx(afull, 4 * TK::kBytes);
      TK::load(as, &tk, afull, 0, k0, h, b, p.B);
      TK::load(as + 2 * TK::kBytes, &tv, afull, 0, k0, h, b, p.B);
      s9::mbar_wait(bempty0 + 8 * stage, phase ^ 1);
      s9::mbar_expect_tx(bfull, 2 * TKT::kBytes);
      TKT::load(b_s + stage * C::kBStage, &tkt, bfull, k0, 0, h, b, p.B);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    s9::reg_alloc<C::kConsumerRegs>();
    const int cw = (tid - 128) / 128;  // query rows 64*cw .. 64*cw + 63
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * cw + 16 * warp + g, r1 = r0 + 8;
    const float c = p.scale * kLog2e;  // exp(x scale) = exp2(x c)
    // lse (times log2 e) and delta of this thread's two rows
    const float* lse_b = p.lse + static_cast<long long>(bh) * p.Lq;
    const float* dl_b = p.delta + static_cast<long long>(bh) * p.Lq;
    const float lse0 = (r0 < p.Lq ? lse_b[r0] : kPadLse) * kLog2e;
    const float lse1 = (r1 < p.Lq ? lse_b[r1] : kPadLse) * kLog2e;
    const float dl0 = r0 < p.Lq ? dl_b[r0] : 0.f;
    const float dl1 = r1 < p.Lq ? dl_b[r1] : 0.f;
    int qpos0 = 0, qpos1 = 0;
    if (masked) {
      qpos0 = pos_of(r0, off.q0, off.q1, p.pos.seg_q);
      qpos1 = pos_of(r1, off.q0, off.q1, p.pos.seg_q);
    }
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    float s[BK / 2], dp[BK / 2];
    const int row = 64 * cw;  // this group's rows of the Q and dO tiles

    s9::mbar_wait(q_full, 0);  // also when no tile is visited: TMA is done
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int state = pair(kt);
      if (state == 0) continue;
      const int k0 = kt * BK;
      const uint32_t ks = a_s + stage * C::kAStage;
      const uint32_t vs = ks + 2 * TK::kBytes;
      s9::mbar_wait(afull0 + 8 * stage, phase);

      // S = Q K^T and dP = dO V^T, three passes each.
      s9::fence_regs(s);
      s9::fence_regs(dp);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const uint64_t qh = TQ::desc(q_s, kk, row);
        const uint64_t ql = TQ::desc(q_s + TQ::kBytes, kk, row);
        const uint64_t kh = TK::desc(ks, kk, 0);
        const uint64_t kl = TK::desc(ks + TK::kBytes, kk, 0);
        s9::wgmma_tf32_ss<BK>(s, ql, kh, kk > 0);
        s9::wgmma_tf32_ss<BK>(s, qh, kl, 1);
        s9::wgmma_tf32_ss<BK>(s, qh, kh, 1);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const uint64_t gh = TQ::desc(g_s, kk, row);
        const uint64_t gl = TQ::desc(g_s + TQ::kBytes, kk, row);
        const uint64_t vh = TK::desc(vs, kk, 0);
        const uint64_t vl = TK::desc(vs + TK::kBytes, kk, 0);
        s9::wgmma_tf32_ss<BK>(dp, gl, vh, kk > 0);
        s9::wgmma_tf32_ss<BK>(dp, gh, vl, 1);
        s9::wgmma_tf32_ss<BK>(dp, gh, vh, 1);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(s);
      s9::fence_regs(dp);
      s9::mbar_arrive(aempty0 + 8 * stage);  // K and V of this stage are read

      // P = exp(scale s - lse), selected to 0 where the key is hidden or
      // past Lk; dS = P (dP - delta), split into the TF32 A fragments of
      // dS K: accumulator columns (2t, 2t + 1) of a k-step are the
      // fragment's (t, t + 4).
      const bool check = k0 + BK > p.Lk || state == 2;
      uint32_t dh[BK / 8][4], dlo[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          float pr = s9::exp2_approx(
              fmaf(s[4 * j + e], c, -(e < 2 ? lse0 : lse1)));
          if (check) {
            bool visible = key < p.Lk;
            if (masked && state == 2)
              visible = visible && pos_sees(p, off, e < 2 ? qpos0 : qpos1,
                                            key);
            if (!visible) pr = 0.f;  // selected, not multiplied
          }
          const float ds = pr * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
          const int f = (e & 1) * 2 + (e >> 1);  // fragment register
          split_frag(ds, dh[j][f], dlo[j][f]);
        }
      }

      // dQ += this tile's dS K (K^T K-major, permuted as dS), into a fresh
      // accumulator.
      s9::mbar_wait(bfull0 + 8 * stage, phase);
      accum_rs<TKT, DP, DP>(dq, dh, dlo, b_s + stage * C::kBStage);
      s9::mbar_arrive(bempty0 + 8 * stage);  // K^T of this stage is read
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue: dQ * scale through dq's strides; rows past Lq not written.
    float* ob = p.o0 + b * p.o0s[0] + h * p.o0s[1];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p.d) continue;
      if (r0 < p.Lq)
        *reinterpret_cast<float2*>(ob + r0 * p.o0s[2] + col) =
            make_float2(dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
      if (r1 < p.Lq)
        *reinterpret_cast<float2*>(ob + r1 * p.o0s[2] + col) =
            make_float2(dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
    }
  }
}

// ------------------------------------------------------- K4 / K7: dk, dv
template <int DP>
struct DkvCfg {
  static constexpr int kCons = DP <= 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int kBKey = 64 * kCons;        // keys per block
  static constexpr int kBQ = DP <= 64 ? 32 : 16;  // queries per tile
  static constexpr int kThreads = 128 * (1 + kCons);
  static constexpr int kConsumers = 128 * kCons;
  static constexpr int kConsumerRegs = kCons == 2 ? 232 : 240;
  static constexpr int kStagesA = 2, kStagesB = 1;
  // output columns per dV / dK accumulator
  static constexpr int kNC = DP <= 64 ? DP : DP / 2;
  using TK = Tile<kBKey, DP>;     // K, V (resident)
  using TQ = Tile<kBQ, DP>;       // Q, dO
  using TQT = Tile<DP, kBQ>;      // Q^T, dO^T
  static constexpr int kVOff = 2 * TK::kBytes;
  static constexpr int kAOff = 4 * TK::kBytes;  // ring A: Q, dO per stage
  static constexpr int kAStage = 4 * TQ::kBytes;
  static constexpr int kBOff = kAOff + kStagesA * kAStage;  // Q^T, dO^T
  static constexpr int kBStage = 4 * TQT::kBytes;
  static constexpr int kBarOff = kBOff + kStagesB * kBStage;
  // K / V full; A full, empty per stage; B full, empty per stage
  static constexpr int kBars = 1 + 2 * kStagesA + 2 * kStagesB;
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(DP % 16 == 0 && DP <= 128, "head dim");
};

template <int DP, bool MASKED>
__global__ void __launch_bounds__(DkvCfg<DP>::kThreads, 1)
flash_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tg,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tqt,
                         const __grid_constant__ CUtensorMap tgt,
                         const __grid_constant__ Params p) {
  using C = DkvCfg<DP>;
  using TK = typename C::TK;
  using TQ = typename C::TQ;
  using TQT = typename C::TQT;
  constexpr int BQ = C::kBQ, BKEY = C::kBKey, SA = C::kStagesA,
                SB = C::kStagesB, NC = C::kNC;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (s9::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + C::kVOff;
  const uint32_t a_s = base + C::kAOff, b_s = base + C::kBOff;
  const uint32_t kv_full = base + C::kBarOff;
  const uint32_t afull0 = kv_full + 8, aempty0 = afull0 + 8 * SA;
  const uint32_t bfull0 = aempty0 + 8 * SA, bempty0 = bfull0 + 8 * SB;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / p.n_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int kb0 = (blockIdx.x % p.n_tiles) * BKEY;

  if (tid == 0) {
    s9::mbar_init(kv_full, 1);
    for (int s = 0; s < SA; ++s) {
      s9::mbar_init(afull0 + 8 * s, 1);
      s9::mbar_init(aempty0 + 8 * s, C::kConsumers);
    }
    for (int s = 0; s < SB; ++s) {
      s9::mbar_init(bfull0 + 8 * s, 1);
      s9::mbar_init(bempty0 + 8 * s, C::kConsumers);
    }
    s9::mbar_init_fence();
  } else if (tid == 32) {  // fetch the descriptors while barriers are set up
    s9::prefetch_tensormap(&tq);
    s9::prefetch_tensormap(&tg);
    s9::prefetch_tensormap(&tk);
    s9::prefetch_tensormap(&tv);
    s9::prefetch_tensormap(&tqt);
    s9::prefetch_tensormap(&tgt);
  }
  __syncthreads();

  const bool masked = MASKED && (p.pos.causal || p.pos.has_valid);
  const Offsets off(p.pos, masked);
  const int n_qt = (p.Lq + BQ - 1) / BQ;
  auto pair = [&](int qt) {
    return tile_pair(p, off, masked, qt * BQ, BQ, kb0, BKEY);
  };

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid != 0) return;
    s9::mbar_expect_tx(kv_full, 4 * TK::kBytes);
    TK::load(k_s, &tk, kv_full, 0, kb0, h, b, p.B);
    TK::load(v_s, &tv, kv_full, 0, kb0, h, b, p.B);
    int sa = 0, sb = 0;
    uint32_t pa = 0, pb = 0;
    for (int qt = 0; qt < n_qt; ++qt) {
      if (pair(qt) == 0) continue;
      const int q0 = qt * BQ;
      const uint32_t afull = afull0 + 8 * sa, bfull = bfull0 + 8 * sb;
      const uint32_t as = a_s + sa * C::kAStage, bs = b_s + sb * C::kBStage;
      s9::mbar_wait(aempty0 + 8 * sa, pa ^ 1);
      s9::mbar_expect_tx(afull, 4 * TQ::kBytes);
      TQ::load(as, &tq, afull, 0, q0, h, b, p.B);
      TQ::load(as + 2 * TQ::kBytes, &tg, afull, 0, q0, h, b, p.B);
      s9::mbar_wait(bempty0 + 8 * sb, pb ^ 1);
      s9::mbar_expect_tx(bfull, 4 * TQT::kBytes);
      TQT::load(bs, &tqt, bfull, q0, 0, h, b, p.B);
      TQT::load(bs + 2 * TQT::kBytes, &tgt, bfull, q0, 0, h, b, p.B);
      if (++sa == SA) {
        sa = 0;
        pa ^= 1;
      }
      if (++sb == SB) {
        sb = 0;
        pb ^= 1;
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    s9::reg_alloc<C::kConsumerRegs>();
    const int cw = (tid - 128) / 128;  // keys 64*cw .. 64*cw + 63 of the block
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int key0 = kb0 + 64 * cw + 16 * warp + g, key1 = key0 + 8;
    const float c = p.scale * kLog2e;  // exp(x scale) = exp2(x c)
    const float* lse_b = p.lse + static_cast<long long>(bh) * p.Lq;
    const float* dl_b = p.delta + static_cast<long long>(bh) * p.Lq;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[BQ / 2], dpt[BQ / 2];
    const int row = 64 * cw;  // this group's rows of the K and V tiles

    s9::mbar_wait(kv_full, 0);  // also when no tile is visited: TMA is done
    int sa = 0, sb = 0;
    uint32_t pa = 0, pb = 0;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int state = pair(qt);
      if (state == 0) continue;
      const int q0 = qt * BQ;
      // lse (times log2 e), delta and position of this thread's query
      // columns 8j + 2t + u, read before the wait
      float lq[BQ / 4], dlt[BQ / 4];
      int qpos[BQ / 4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = q0 + 8 * j + 2 * t + u;
          const bool in = col < p.Lq;
          lq[2 * j + u] = (in ? lse_b[col] : kPadLse) * kLog2e;
          dlt[2 * j + u] = in ? dl_b[col] : 0.f;
          qpos[2 * j + u] =
              masked ? pos_of(col, off.q0, off.q1, p.pos.seg_q) : 0;
        }
      const uint32_t qs = a_s + sa * C::kAStage;
      const uint32_t gs = qs + 2 * TQ::kBytes;
      s9::mbar_wait(afull0 + 8 * sa, pa);

      // S^T = K Q^T and dP^T = V dO^T with the keys as M, three passes each.
      s9::fence_regs(st);
      s9::fence_regs(dpt);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const uint64_t kh = TK::desc(k_s, kk, row);
        const uint64_t kl = TK::desc(k_s + TK::kBytes, kk, row);
        const uint64_t qh = TQ::desc(qs, kk, 0);
        const uint64_t ql = TQ::desc(qs + TQ::kBytes, kk, 0);
        s9::wgmma_tf32_ss<BQ>(st, kl, qh, kk > 0);
        s9::wgmma_tf32_ss<BQ>(st, kh, ql, 1);
        s9::wgmma_tf32_ss<BQ>(st, kh, qh, 1);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const uint64_t vh = TK::desc(v_s, kk, row);
        const uint64_t vl = TK::desc(v_s + TK::kBytes, kk, row);
        const uint64_t gh = TQ::desc(gs, kk, 0);
        const uint64_t gl = TQ::desc(gs + TQ::kBytes, kk, 0);
        s9::wgmma_tf32_ss<BQ>(dpt, vl, gh, kk > 0);
        s9::wgmma_tf32_ss<BQ>(dpt, vh, gl, 1);
        s9::wgmma_tf32_ss<BQ>(dpt, vh, gh, 1);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(st);
      s9::fence_regs(dpt);
      s9::mbar_arrive(aempty0 + 8 * sa);  // Q and dO of this stage are read

      // P^T and dS^T in registers, selected to 0 where hidden or past the
      // ends, split into the TF32 A fragments of P^T dO and dS^T Q.
      const bool check = q0 + BQ > p.Lq || state == 2 ||
                         kb0 + BKEY > p.Lk;
      uint32_t ph[BQ / 8][4], pl[BQ / 8][4], sh[BQ / 8][4], sl[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = 2 * j + (e & 1);
          const int key = e < 2 ? key0 : key1;
          float pr = s9::exp2_approx(fmaf(st[4 * j + e], c, -lq[u]));
          if (check) {
            bool visible = q0 + 8 * j + 2 * t + (e & 1) < p.Lq && key < p.Lk;
            if (masked && state == 2)
              visible = visible && pos_sees(p, off, qpos[u], key);
            if (!visible) pr = 0.f;  // selected, not multiplied
          }
          const int f = (e & 1) * 2 + (e >> 1);  // fragment register
          split_frag(pr, ph[j][f], pl[j][f]);
          split_frag(pr * (dpt[4 * j + e] - dlt[u]), sh[j][f], sl[j][f]);
        }
      }

      // dV += P^T dO and dK += dS^T Q, NC columns of d at a time (dO^T and
      // Q^T K-major, permuted as P^T).
      const uint32_t qts = b_s + sb * C::kBStage;
      s9::mbar_wait(bfull0 + 8 * sb, pb);
      accum_rs<TQT, DP, NC>(dv, ph, pl, qts + 2 * TQT::kBytes);
      accum_rs<TQT, DP, NC>(dk, sh, sl, qts);
      s9::mbar_arrive(bempty0 + 8 * sb);  // Q^T and dO^T are read
      if (++sa == SA) {
        sa = 0;
        pa ^= 1;
      }
      if (++sb == SB) {
        sb = 0;
        pb ^= 1;
      }
    }

    // Epilogue: dK * scale and dV through their strides; keys past Lk are
    // not written.
    float* kb = p.o0 + b * p.o0s[0] + h * p.o0s[1];
    float* vb = p.o1 + b * p.o1s[0] + h * p.o1s[1];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p.d) continue;
      if (key0 < p.Lk) {
        *reinterpret_cast<float2*>(kb + key0 * p.o0s[2] + col) =
            make_float2(dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale);
        *reinterpret_cast<float2*>(vb + key0 * p.o1s[2] + col) =
            make_float2(dv[4 * j], dv[4 * j + 1]);
      }
      if (key1 < p.Lk) {
        *reinterpret_cast<float2*>(kb + key1 * p.o0s[2] + col) =
            make_float2(dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
        *reinterpret_cast<float2*>(vb + key1 * p.o1s[2] + col) =
            make_float2(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

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

template <int DP, bool MASKED>
cudaError_t run_dq(const Work& w, Params p, cudaStream_t s) {
  using C = DqCfg<DP>;
  const int d = p.d;
  CUtensorMap tq, tg, tk, tv, tkt;
  cudaError_t err = rows_map(&tq, w.q, p.B, p.H, p.Lq, d, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tg, w.g, p.B, p.H, p.Lq, d, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tk, w.k, p.B, p.H, p.Lk, d, C::TK::W, C::kBK);
  if (err == cudaSuccess)
    err = rows_map(&tv, w.v, p.B, p.H, p.Lk, d, C::TK::W, C::kBK);
  if (err == cudaSuccess)
    err = transposed_map(&tkt, w.kt, p.B, p.H, p.Lk, d, C::TKT::W, DP);
  if (err != cudaSuccess) return err;
  p.n_tiles = (p.Lq + C::kBQ - 1) / C::kBQ;
  return s9::launch_kernel(flash_bwd_dq_f32_kernel<DP, MASKED>,
                           p.B * p.H * p.n_tiles, C::kThreads, C::kSmemBytes,
                           s, tq, tg, tk, tv, tkt, p);
}

template <int DP, bool MASKED>
cudaError_t run_dkv(const Work& w, Params p, cudaStream_t s) {
  using C = DkvCfg<DP>;
  const int d = p.d;
  CUtensorMap tq, tg, tk, tv, tqt, tgt;
  cudaError_t err = rows_map(&tq, w.q, p.B, p.H, p.Lq, d, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tg, w.g, p.B, p.H, p.Lq, d, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tk, w.k, p.B, p.H, p.Lk, d, C::TK::W, C::kBKey);
  if (err == cudaSuccess)
    err = rows_map(&tv, w.v, p.B, p.H, p.Lk, d, C::TK::W, C::kBKey);
  if (err == cudaSuccess)
    err = transposed_map(&tqt, w.qt, p.B, p.H, p.Lq, d, C::TQT::W, DP);
  if (err == cudaSuccess)
    err = transposed_map(&tgt, w.gt, p.B, p.H, p.Lq, d, C::TQT::W, DP);
  if (err != cudaSuccess) return err;
  p.n_tiles = (p.Lk + C::kBKey - 1) / C::kBKey;
  return s9::launch_kernel(flash_bwd_dkv_f32_kernel<DP, MASKED>,
                           p.B * p.H * p.n_tiles, C::kThreads, C::kSmemBytes,
                           s, tq, tg, tk, tv, tqt, tgt, p);
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
    return masked ? run_dq<DP, true>(w, p, s) : run_dq<DP, false>(w, p, s);
}

template <int DP>
cudaError_t launch_dkv(const Work& w, const Params& p, bool masked,
                       cudaStream_t s) {
  if constexpr (DP > 128)
    return masked ? run_dkv_wide<DP, true>(w, p, s)
                  : run_dkv_wide<DP, false>(w, p, s);
  else
    return masked ? run_dkv<DP, true>(w, p, s)
                  : run_dkv<DP, false>(w, p, s);
}

cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* g, const long long* st, void* work,
                        const Params& p, int d, bool masked, cudaStream_t s) {
  if (masked && p.pos.q_off != nullptr && d != 64)  // K6: 64 only
    return cudaErrorInvalidValue;
  const Work w = carve(work, p.B, p.H, p.Lq, p.Lk, d);
  return run_width(d, [&](auto width) {
    cudaError_t err = split_dq(q, k, v, g, st, w, p, s);
    return err == cudaSuccess
               ? launch_dq<decltype(width)::value>(w, p, masked, s)
               : err;
  });
}

cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const void* g, const long long* st, void* work,
                         const Params& p, int d, bool masked,
                         cudaStream_t s) {
  if (masked && p.pos.q_off != nullptr && d != 64)  // K7: 64 only
    return cudaErrorInvalidValue;
  const Work w = carve(work, p.B, p.H, p.Lq, p.Lk, d);
  return run_width(d, [&](auto width) {
    cudaError_t err = split_dkv(q, k, v, g, st, w, p, s);
    return err == cudaSuccess
               ? launch_dkv<decltype(width)::value>(w, p, masked, s)
               : err;
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
// dO, dq, each a multiple of 4; the head-dim stride is 1. lse and delta are
// (B, H, Lq) contiguous fp32. work: fp32 scratch of 2 B H d (2 Lq + 2 Lk +
// Lk8 + 2 Lq8) floats (L8: L rounded up to 8), shared in layout with
// fdsd_flash_bwd_dkv_f32. Every head dim up to 256 that is a multiple of 4,
// without a mask or causal.
extern "C" int fdsd_flash_bwd_dq_f32(const void* q, const void* k,
                                     const void* v, const void* g,
                                     const void* lse, const void* delta,
                                     void* dq, void* work, int B, int H,
                                     int Lq, int Lk, int d,
                                     const long long* strides, float scale,
                                     int causal, void* stream) {
  Params p = bwd_params(lse, delta, dq, nullptr, B, H, Lq, Lk, d, strides,
                       scale);
  p.pos.causal = causal;
  return static_cast<int>(dispatch_dq(q, k, v, g, strides, work, p, d,
                                      causal != 0,
                                      static_cast<cudaStream_t>(stream)));
}

// K4 in fp32. strides: 18 element strides, for q, k, v, dO, dk, dv; work
// as for fdsd_flash_bwd_dq_f32.
extern "C" int fdsd_flash_bwd_dkv_f32(const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, void* work, int B,
                                      int H, int Lq, int Lk, int d,
                                      const long long* strides, float scale,
                                      int causal, void* stream) {
  Params p = bwd_params(lse, delta, dk, dv, B, H, Lq, Lk, d, strides,
                       scale);
  p.pos.causal = causal;
  return static_cast<int>(dispatch_dkv(q, k, v, g, strides, work, p, d,
                                       causal != 0,
                                       static_cast<cudaStream_t>(stream)));
}

// K6 in fp32: the arguments of fdsd_flash_bwd_pos_dq on fp32 tensors, with
// the workspace of fdsd_flash_bwd_dq_f32 after the offsets. Head dim 64.
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
                                      static_cast<cudaStream_t>(stream)));
}

// K7 in fp32: the arguments of fdsd_flash_bwd_pos_dkv on fp32 tensors, with
// the workspace of fdsd_flash_bwd_dkv_f32 after the offsets. Head dim 64.
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
                                       static_cast<cudaStream_t>(stream)));
}
