// Flash-attention backward on fp32 inputs for Hopper (sm_90a) on the tensor
// cores: the fp32 form of K3 (dq) and K4 (dk, dv), plain and causal, and of
// K6 / K7 (position masks under a caller-supplied global lse and delta).
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
// The numerical plan is the fp32 forward's (flash_f32_fwd.cu): the
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
// fp32 FMAs on the CUDA cores that the kernels they replace used (4 x 4
// register tiles, dS through shared memory), plus one exponential per
// logit.
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
// Shared memory, every form: 229,376 B of tiles (the two kernels were sized
// to it). Masks (K3 / K4 causal, K6 / K7) are the position masks of
// pos_tile.cuh, judged per (query tile, key tile) pair by pos_pair in every
// role; the causal form of the plain kernels is the position mask with
// offsets 0. Query rows past Lq get lse = +1e30 (P = 0); keys past Lk are
// selected to P = 0.

#include "../pos_tile.cuh"
#include "../sm90.cuh"
#include "split_f32.cuh"

namespace {

namespace s9 = fdsd::sm90;
using fdsd::PosArgs;
using fdsd::pos_bounds;
using fdsd::pos_of;
using fdsd::pos_pair;

constexpr float kPadLse = 1e30f;  // query rows past Lq: P = 0
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPasses = 3;  // TF32 wgmma passes per product
static_assert(kPasses == 3, "lo hi + hi lo + hi hi");
constexpr int kProducerRegs = 40;

// A tile of R rows x C fp32 columns of one term as TMA writes it: C / W
// chunks of R rows x W columns, W = 32 (128-byte swizzle) or 8 (32-byte).
template <int R, int C>
struct Tile {
  static constexpr int W = C % 32 == 0 ? 32 : 8;
  static constexpr uint32_t kLayout = W == 32 ? 1 : 3;
  static constexpr uint32_t kAtom = 8 * W * 4;  // 8 rows of a chunk
  static constexpr int kChunks = C / W;
  static constexpr int kChunk = R * W * 4;
  static constexpr int kBytes = R * C * 4;  // one term; hi, then lo
  static_assert(C % 8 == 0 && R % 8 == 0, "tile");

  // K-major descriptor of k-step kk (columns 8kk ..) from row `row`.
  static __device__ __forceinline__ uint64_t desc(uint32_t at, int kk,
                                                  int row) {
    return s9::smem_desc(at + (kk * 8 / W) * kChunk + row * W * 4 +
                             (kk * 8 % W) * 4,
                         16, kAtom, kLayout);
  }
  // Both terms by TMA: chunk c from map coordinates (x0 + c W, y0, h,
  // b + term B).
  static __device__ __forceinline__ void load(uint32_t at,
                                              const CUtensorMap* map,
                                              uint32_t bar, int x0, int y0,
                                              int h, int b, int B) {
    for (int term = 0; term < 2; ++term)
      for (int c = 0; c < kChunks; ++c)
        s9::tma_load_4d(at + term * kBytes + c * kChunk, map, bar,
                        x0 + c * W, y0, h, b + term * B);
  }
};

struct Params {
  const float* lse;    // (B, H, Lq)
  const float* delta;  // (B, H, Lq)
  float* o0;           // dq, or dk
  float* o1;           // dv
  int B, H, Lq, Lk, n_tiles;  // query tiles (dq) or key blocks (dk/dv)
  long long o0s[3], o1s[3];   // outputs' (batch, head, seq) strides
  float scale;
  PosArgs pos;  // MASKED only; null offsets read as 0
};

// The offsets of a masked launch, read once; zeros without positions.
struct Offsets {
  int q0 = 0, q1 = 0, k0 = 0, k1 = 0;
  __device__ __forceinline__ Offsets(const PosArgs& a, bool masked) {
    if (masked && a.q_off != nullptr) {
      q0 = a.q_off[0];
      q1 = a.q_off[1];
    }
    if (masked && a.k_off != nullptr) {
      k0 = a.k_off[0];
      k1 = a.k_off[1];
    }
  }
};

// pos_pair of the query tile [q0, q0 + bq) with the key tile [k0, k0 + bk):
// 0 skip, 1 visible, 2 masked per logit; 1 without positions.
__device__ __forceinline__ int tile_pair(const Params& p, const Offsets& o,
                                         bool masked, int q0, int bq, int k0,
                                         int bk) {
  if (!masked) return 1;
  int q_lo, q_hi, k_lo, k_hi;
  pos_bounds(q0, bq, o.q0, o.q1, p.pos.seg_q, p.Lq, q_lo, q_hi);
  pos_bounds(k0, bk, o.k0, o.k1, p.pos.seg_k, p.Lk, k_lo, k_hi);
  return pos_pair(p.pos, q_lo, q_hi, k_lo, k_hi);
}

// Does the query at position qpos see the key at index key (< Lk)?
__device__ __forceinline__ bool pos_sees(const Params& p, const Offsets& o,
                                         int qpos, int key) {
  const int kpos = pos_of(key, o.k0, o.k1, p.pos.seg_k);
  if (p.pos.has_valid && kpos >= p.pos.valid_len) return false;
  return !p.pos.causal || kpos <= qpos;
}

// x split in registers into the TF32 hi / lo A-fragment registers f.
__device__ __forceinline__ void split_frag(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = s9::to_tf32(x);
  lo = s9::to_tf32(x - __uint_as_float(hi));
}

// acc += A B over one tile, NC output columns at a time, each chunk into a
// fresh accumulator added to acc in registers: A the split TF32 fragments
// (hi, lo) of KS k-steps, B the transposed terms at ts (TT, K-major: the
// k-step kk is positions 8kk .. 8kk + 7, permuted as A's columns; chunk nc
// is its rows NC nc ..). Three passes: lo hi + hi lo + hi hi.
template <typename TT, int DP, int NC, int KS>
__device__ __forceinline__ void accum_rs(float (&acc)[DP / 2],
                                         const uint32_t (&hi)[KS][4],
                                         const uint32_t (&lo)[KS][4],
                                         uint32_t ts) {
  float part[NC / 2];
#pragma unroll
  for (int nc = 0; nc < DP / NC; ++nc) {
    s9::fence_regs(part);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t th = TT::desc(ts, kk, NC * nc);
      const uint64_t tl = TT::desc(ts + TT::kBytes, kk, NC * nc);
      s9::wgmma_tf32_rs<NC>(part, lo[kk], th, kk > 0);
      s9::wgmma_tf32_rs<NC>(part, hi[kk], tl, 1);
      s9::wgmma_tf32_rs<NC>(part, hi[kk], th, 1);
    }
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
    s9::fence_regs(part);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[nc * (NC / 2) + i] += part[i];
  }
}

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
  static_assert(DP == 64 || DP == 128, "head dim");
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
  static constexpr int kNC = 64;  // output columns per dV / dK accumulator
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
  static_assert(DP == 64 || DP == 128, "head dim");
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
struct Work {
  float* q;
  float* k;
  float* v;
  float* g;
  float* kt;
  float* qt;
  float* gt;
  long long nq, nk, nkt, nqt;  // floats of one term
};

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

// A rows map (d, L, H, 2B) with a box of W columns x `rows`, or a
// transposed one (L8, d, H, 2B) with a box of W positions x d rows.
cudaError_t rows_map(CUtensorMap* map, const float* terms, int B, int H,
                     int L, int d, int W, int rows) {
  const long long st[3] = {static_cast<long long>(H) * L * d,
                           static_cast<long long>(L) * d, d};
  return s9::make_map(map, terms, d, L, H, 2 * B, st, W, rows,
                      W == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
                      CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

cudaError_t transposed_map(CUtensorMap* map, const float* terms, int B, int H,
                           int L, int d, int W) {
  const int l8 = round_up8(L);
  const long long st[3] = {static_cast<long long>(H) * d * l8,
                           static_cast<long long>(d) * l8, l8};
  return s9::make_map(map, terms, l8, d, H, 2 * B, st, W, d,
                      W == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
                      CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

template <int DP, bool MASKED>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* g,
                   const long long* st, const Work& w, Params p,
                   cudaStream_t s) {
  using C = DqCfg<DP>;
  cudaError_t err = split_row_terms(q, k, v, g, st, p.H, p.Lq, p.Lk, DP, w, s);
  if (err == cudaSuccess)
    err = split_transposed(k, st + 3, w.kt, w.nkt, p.B, p.H, p.Lk, DP, s);
  CUtensorMap tq, tg, tk, tv, tkt;
  if (err == cudaSuccess)
    err = rows_map(&tq, w.q, p.B, p.H, p.Lq, DP, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tg, w.g, p.B, p.H, p.Lq, DP, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tk, w.k, p.B, p.H, p.Lk, DP, C::TK::W, C::kBK);
  if (err == cudaSuccess)
    err = rows_map(&tv, w.v, p.B, p.H, p.Lk, DP, C::TK::W, C::kBK);
  if (err == cudaSuccess)
    err = transposed_map(&tkt, w.kt, p.B, p.H, p.Lk, DP, C::TKT::W);
  if (err != cudaSuccess) return err;
  p.n_tiles = (p.Lq + C::kBQ - 1) / C::kBQ;
  return s9::launch_kernel(flash_bwd_dq_f32_kernel<DP, MASKED>,
                           p.B * p.H * p.n_tiles, C::kThreads, C::kSmemBytes,
                           s, tq, tg, tk, tv, tkt, p);
}

template <int DP, bool MASKED>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* g, const long long* st, const Work& w,
                    Params p, cudaStream_t s) {
  using C = DkvCfg<DP>;
  cudaError_t err = split_row_terms(q, k, v, g, st, p.H, p.Lq, p.Lk, DP, w, s);
  if (err == cudaSuccess)
    err = split_transposed(q, st, w.qt, w.nqt, p.B, p.H, p.Lq, DP, s);
  if (err == cudaSuccess)
    err = split_transposed(g, st + 9, w.gt, w.nqt, p.B, p.H, p.Lq, DP, s);
  CUtensorMap tq, tg, tk, tv, tqt, tgt;
  if (err == cudaSuccess)
    err = rows_map(&tq, w.q, p.B, p.H, p.Lq, DP, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tg, w.g, p.B, p.H, p.Lq, DP, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tk, w.k, p.B, p.H, p.Lk, DP, C::TK::W, C::kBKey);
  if (err == cudaSuccess)
    err = rows_map(&tv, w.v, p.B, p.H, p.Lk, DP, C::TK::W, C::kBKey);
  if (err == cudaSuccess)
    err = transposed_map(&tqt, w.qt, p.B, p.H, p.Lq, DP, C::TQT::W);
  if (err == cudaSuccess)
    err = transposed_map(&tgt, w.gt, p.B, p.H, p.Lq, DP, C::TQT::W);
  if (err != cudaSuccess) return err;
  p.n_tiles = (p.Lk + C::kBKey - 1) / C::kBKey;
  return s9::launch_kernel(flash_bwd_dkv_f32_kernel<DP, MASKED>,
                           p.B * p.H * p.n_tiles, C::kThreads, C::kSmemBytes,
                           s, tq, tg, tk, tv, tqt, tgt, p);
}

// strides: q, k, v, dO, then the outputs, three each.
Params bwd_params(const void* lse, const void* delta, void* o0, void* o1,
                  int B, int H, int Lq, int Lk, const long long* strides,
                  float scale) {
  Params p = {};
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

cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* g, const long long* st, void* work,
                        const Params& p, int d, bool masked, cudaStream_t s) {
  const Work w = carve(work, p.B, p.H, p.Lq, p.Lk, d);
  if (masked)
    return d == 64 ? run_dq<64, true>(q, k, v, g, st, w, p, s)
                   : cudaErrorInvalidValue;
  if (d == 64) return run_dq<64, false>(q, k, v, g, st, w, p, s);
  if (d == 128) return run_dq<128, false>(q, k, v, g, st, w, p, s);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const void* g, const long long* st, void* work,
                         const Params& p, int d, bool masked,
                         cudaStream_t s) {
  const Work w = carve(work, p.B, p.H, p.Lq, p.Lk, d);
  if (masked)
    return d == 64 ? run_dkv<64, true>(q, k, v, g, st, w, p, s)
                   : cudaErrorInvalidValue;
  if (d == 64) return run_dkv<64, false>(q, k, v, g, st, w, p, s);
  if (d == 128) return run_dkv<128, false>(q, k, v, g, st, w, p, s);
  return cudaErrorInvalidValue;
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
// fdsd_flash_bwd_dkv_f32. Head dims 64 and 128 without a mask, 64 with
// causal.
extern "C" int fdsd_flash_bwd_dq_f32(const void* q, const void* k,
                                     const void* v, const void* g,
                                     const void* lse, const void* delta,
                                     void* dq, void* work, int B, int H,
                                     int Lq, int Lk, int d,
                                     const long long* strides, float scale,
                                     int causal, void* stream) {
  Params p = bwd_params(lse, delta, dq, nullptr, B, H, Lq, Lk, strides, scale);
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
  Params p = bwd_params(lse, delta, dk, dv, B, H, Lq, Lk, strides, scale);
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
  Params p = bwd_params(lse, delta, dq, nullptr, B, H, Lq, Lk, strides, scale);
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
  Params p = bwd_params(lse, delta, dk, dv, B, H, Lq, Lk, strides, scale);
  p.pos = pos_args(q_off, k_off, seg_q, seg_k, valid_len, has_valid, causal);
  return static_cast<int>(dispatch_dkv(q, k, v, g, strides, work, p, d, true,
                                       static_cast<cudaStream_t>(stream)));
}
