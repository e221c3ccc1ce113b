// Flash-attention backward dq for Hopper (sm_90a) on TMA and wgmma: bf16 in
// and out, fp32 softmax reconstruction and accumulators. K3, and K6, its
// position-masked form.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel
//     (K3) in every form of its: ragged Lq and Lk, and as template
//     parameters beside the head dim (64: SigLIP tower, TinyVLM decoder, T5;
//     128: tiny-SD) CAUSAL (key <= query from index 0 on both sides),
//     HAS_BIAS (an additive bias read through its strides, added in fp32
//     after the scale) and HAS_SEG (segment ids: same-id pairs only);
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel_pos
//     (K6): dq of a LOCAL block of queries against a LOCAL block of keys
//     under a GLOBAL softmax over more keys than this block holds, with the
//     position masks of K5 (flash_attention_sm90.cu): the MMDiT's training
//     step runs it four times per joint block at (2, 24, {154, 4096},
//     {154, 4096}, 64) under the lse merged over both streams.
// It recomputes the probabilities under the caller's lse (K3: the forward's;
// K6: the global one), P = exp(scale * Q K^T + bias - lse), selected to 0
// where a mask hides the key (never multiplied: a row that saw no key has
// lse = -1e30, and under K6 a row that only another block's keys see has a
// finite lse and is masked in every tile here), with delta = rowsum(dO *
// out) computed beforehand (fp32, by the caller): dS = P * (dO V^T - delta),
// dQ = scale * dS K; under K6 the contributions of several key blocks add
// up in the caller, and this kernel's dq is written, not accumulated. With
// a bias that needs a gradient it also writes dbias = dS, fp32 (B, H, Lq,
// Lk): every tile exactly once, zeros where a tile is skipped, so the
// caller reduces it over the bias's broadcast axes without a memset. The
// TPU's sequential key-block grid axis is a loop inside the block. dk and
// dv are K4 / K7, the kernel of flash_attention_bwd_sm90.cu, whose shape
// this one mirrors with the roles of queries and keys swapped.
//
// What bounds it on the H100: three L^2 * d products per (b, h), thousands
// of flop per byte of q, k, v and dO at the tiny-SD, TinyVLM and MMDiT
// shapes: operations, so the tensor cores' issue rate and, at d = 64, the
// exponentials. The mma.sync kernels it replaces reached ~15 % (K3) and
// ~19 % (K6) of that bound: tiles were loaded synchronously, no load
// overlapped a product, and (K3) K went through shared memory a second time
// as a transposed copy for the dS K product.
//
// Design. One block of three warpgroups per (b*h, 128 queries):
//  - a producer warpgroup gives up its registers (setmaxnreg 40). One thread
//    issues TMA: the block's Q and dO tiles once, then K and V tiles of 64
//    keys into a two-stage ring with full / empty mbarriers, so that the
//    next tile's copy overlaps this tile's products. In the bias form its
//    128 threads stage the (128 queries x 64 keys) bias tile in its own
//    dtype by cp.async, as K1's and K4's producers do (one stage, swizzled).
//    The tensor maps are 4-D (D, L, H, B) over the operands' own strides;
//    rows past Lq or Lk read as zeros.
//  - two consumer warpgroups of 64 queries each (setmaxnreg 232), each with
//    the lse and delta of its rows in registers, compute S = Q K^T and
//    dP = dO V^T (wgmma m64n64k16, SS form, both operands K-major as TMA
//    wrote them); P and dS in registers; dS converted to bf16 is the A
//    operand of dQ += dS K in RS form, with K read MN-major from the same
//    shared tile (the key axis is the reduction): no transposed copy. dQ
//    (64 x d fp32) stays in registers until the end.
//  - query rows past Lq get lse = +1e30 (P = 0); keys past Lk are selected
//    to P = 0 on the last tile, and dbias is not written there. Causal stops
//    at the diagonal and masks per logit only where a tile crosses it;
//    segment ids walk the tile range [lo, hi] of mask.cuh at (128 queries,
//    64 keys), skip a tile whose ids are disjoint, and mask per logit only
//    where the two tiles are not one same segment.
//  - K6 (POS) is one more form, with its own kernel name
//    (flash_bwd_pos_dq_sm90_kernel) so that profiles and the SASS check tell
//    it from K3. Its masks are runtime flags read per tile: every role judges
//    each (query tile, key tile) pair by the same pos_pair of the two tiles'
//    position bounds (pos_tile.cuh), as K7 does, so producer and consumers
//    walk the same tiles: skipped, wholly visible, or masked per logit (key
//    index < Lk, key position < valid_len, key position <= query position
//    when causal).
// dq (times scale) is written in bf16 through its strides, every row of it:
// rows whose tiles were all skipped as 0.

#include "mask.cuh"
#include "pos_tile.cuh"
#include "sm90.cuh"

namespace {

namespace s9 = fdsd::sm90;
using fdsd::MaskArgs;
using fdsd::PosArgs;
using fdsd::pos_bounds;
using fdsd::pos_of;
using fdsd::pos_pair;
using fdsd::seg_overlap;

constexpr float kNegInf = -1e30f;
constexpr float kPadLse = 1e30f;  // query rows past Lq: P = 0
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128, kBK = 64;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int DP, bool HAS_BIAS>
struct Cfg {
  static constexpr int W = 64;  // columns per 128-byte swizzle row
  static constexpr int kChunks = DP / W;
  static constexpr int kStages = 2;  // K / V ring
  static constexpr uint32_t kAtom = 8 * W * 2;  // 8 rows of a chunk
  static constexpr int kQChunk = kBQ * W * 2;   // one chunk of Q or dO
  static constexpr int kKChunk = kBK * W * 2;   // one chunk of K or V
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kKBytes = kBK * DP * 2;
  static constexpr int kGOff = kQBytes;
  static constexpr int kKOff = 2 * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBiasOff = kVOff + kStages * kKBytes;
  static constexpr int kBarOff = kBiasOff + (HAS_BIAS ? kBQ * kBK * 4 : 0);
  // Q / dO full; K / V full and empty per stage; bias full and empty
  static constexpr int kBars = 1 + 2 * kStages + 2;
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(DP == 64 || DP == 128, "head dim");
};

struct Params {
  __nv_bfloat16* dq;
  float* dbias;  // fp32 (B, H, Lq, Lk), or null
  const float* lse;
  const float* delta;
  int H, Lq, Lk, d, n_qt;
  long long dqs[3];  // dq's (batch, head, seq) element strides
  float scale;
  MaskArgs m;
  PosArgs pos;  // K6 only
};

// One pair of the staged bias tile, (query row r, key columns c, c + 1).
__device__ __forceinline__ float2 bias_pair(const void* tile, int bf16, int r,
                                            int c) {
  const int i = s9::bias_at<kBK>(r, c);
  return bf16 ? s9::load_pair(static_cast<const __nv_bfloat16*>(tile) + i)
              : s9::load_pair(static_cast<const float*>(tile) + i);
}

// The kernel body of K3 (POS = false) and K6 (POS = true, no other mask).
template <int DP, bool CAUSAL, bool HAS_BIAS, bool HAS_SEG, bool POS>
__device__ __forceinline__ void flash_bwd_dq_body(const CUtensorMap& tq,
                                                  const CUtensorMap& tk,
                                                  const CUtensorMap& tv,
                                                  const CUtensorMap& tg,
                                                  const Params& p) {
  using C = Cfg<DP, HAS_BIAS>;
  constexpr bool kSelect = CAUSAL || HAS_BIAS || HAS_SEG || POS;
  static_assert(!POS || !(CAUSAL || HAS_BIAS || HAS_SEG), "K6's masks");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  void* bias_s = smem_raw + (base - raw) + C::kBiasOff;
  const uint32_t q_s = base, g_s = base + C::kGOff;
  const uint32_t k_s = base + C::kKOff, v_s = base + C::kVOff;
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * C::kStages;
  const uint32_t bias_full = empty0 + 8 * C::kStages, bias_empty = bias_full + 8;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / p.n_qt;
  int qt = blockIdx.x % p.n_qt;
  if (CAUSAL) qt = p.n_qt - 1 - qt;  // the longest rows start first
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kBQ;

  if (tid == 0) {
    s9::mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      s9::mbar_init(full0 + 8 * s, 1);
      s9::mbar_init(empty0 + 8 * s, kConsumers);
    }
    if (HAS_BIAS) {
      s9::mbar_init(bias_full, 128);
      s9::mbar_init(bias_empty, kConsumers);
    }
    s9::mbar_init_fence();
  } else if (tid == 32) {  // fetch the descriptors while barriers are set up
    s9::prefetch_tensormap(&tq);
    s9::prefetch_tensormap(&tk);
    s9::prefetch_tensormap(&tv);
    s9::prefetch_tensormap(&tg);
  }
  __syncthreads();

  // The key tiles this block visits, the same walk in every role: all of
  // them; up to the diagonal when causal; the range whose segment ids
  // overlap this query tile's, less the disjoint tiles inside it; under
  // position masks, those pos_pair does not skip.
  const int n_kt = (p.Lk + kBK - 1) / kBK;
  int kt_begin = 0, kt_end = n_kt;
  if (CAUSAL) kt_end = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  const int* q_bound = nullptr;
  const int* k_bounds = nullptr;
  if (HAS_SEG) {
    const int tile = b * p.n_qt + qt;
    kt_begin = max(kt_begin, p.m.lo[tile]);
    kt_end = min(kt_end, p.m.hi[tile] + 1);
    q_bound = p.m.q_bounds + 2 * tile;
    k_bounds = p.m.kv_bounds + 2 * b * n_kt;
  }
  int q_lo = 0, q_hi = 0, k_off0 = 0, k_off1 = 0;
  if (POS) {
    k_off0 = p.pos.k_off[0];
    k_off1 = p.pos.k_off[1];
    pos_bounds(q0, kBQ, p.pos.q_off[0], p.pos.q_off[1], p.pos.seg_q, p.Lq,
               q_lo, q_hi);
  }
  // pos_pair of this query tile with key tile kt: 0 skip, 1 visible, 2 masked
  auto pos_state = [&](int kt) {
    int k_lo, k_hi;
    pos_bounds(kt * kBK, kBK, k_off0, k_off1, p.pos.seg_k, p.Lk, k_lo, k_hi);
    return pos_pair(p.pos, q_lo, q_hi, k_lo, k_hi);
  };
  auto visits = [&](int kt) {
    return kt >= kt_begin && kt < kt_end &&
           (!HAS_SEG || seg_overlap(q_bound, k_bounds + 2 * kt)) &&
           (!POS || pos_state(kt) != 0);
  };

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      s9::mbar_expect_tx(q_full, 2 * C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c) {
        s9::tma_load_4d(q_s + c * C::kQChunk, &tq, q_full, c * C::W, q0, h, b);
        s9::tma_load_4d(g_s + c * C::kQChunk, &tg, q_full, c * C::W, q0, h, b);
      }
    }
    const long long bias_base = HAS_BIAS ? b * p.m.bs[0] + h * p.m.bs[1] : 0;
    int stage = 0;
    uint32_t phase = 0, bias_phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      if (!visits(kt)) continue;
      const int k0 = kt * kBK;
      if (tid == 0) {
        const uint32_t full = full0 + 8 * stage;
        s9::mbar_wait(empty0 + 8 * stage, phase ^ 1);
        s9::mbar_expect_tx(full, 2 * C::kKBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          const int off = stage * C::kKBytes + c * C::kKChunk;
          s9::tma_load_4d(k_s + off, &tk, full, c * C::W, k0, h, b);
          s9::tma_load_4d(v_s + off, &tv, full, c * C::W, k0, h, b);
        }
      }
      if (HAS_BIAS) {
        s9::mbar_wait(bias_empty, bias_phase ^ 1);
        if (p.m.bias_bf16)
          s9::stage_bias<kBQ, kBK>(static_cast<__nv_bfloat16*>(bias_s), p.m,
                                   bias_base, q0, k0, p.Lq, p.Lk, tid,
                                   bias_full);
        else
          s9::stage_bias<kBQ, kBK>(static_cast<float*>(bias_s), p.m,
                                   bias_base, q0, k0, p.Lq, p.Lk, tid,
                                   bias_full);
        bias_phase ^= 1;
      }
      if (++stage == C::kStages) {
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
    // lse (times log2 e) and delta of this thread's two rows
    const float* lse_b = p.lse + static_cast<long long>(bh) * p.Lq;
    const float* dl_b = p.delta + static_cast<long long>(bh) * p.Lq;
    const float lse0 = (r0 < p.Lq ? lse_b[r0] : kPadLse) * kLog2e;
    const float lse1 = (r1 < p.Lq ? lse_b[r1] : kPadLse) * kLog2e;
    const float dl0 = r0 < p.Lq ? dl_b[r0] : 0.f;
    const float dl1 = r1 < p.Lq ? dl_b[r1] : 0.f;
    int qpos0 = 0, qpos1 = 0;  // K6: the positions of the two rows
    if (POS) {
      qpos0 = pos_of(r0, p.pos.q_off[0], p.pos.q_off[1], p.pos.seg_q);
      qpos1 = pos_of(r1, p.pos.q_off[0], p.pos.q_off[1], p.pos.seg_q);
    }
    const int* kv_ids = nullptr;
    int qid0 = -1, qid1 = -1;
    if (HAS_SEG) {
      kv_ids = p.m.kv_ids + static_cast<long long>(b) * p.Lk;
      const int* ids = p.m.q_ids + static_cast<long long>(b) * p.Lq;
      if (r0 < p.Lq) qid0 = ids[r0];
      if (r1 < p.Lq) qid1 = ids[r1];
    }
    // dbias: every tile of this block's rows is written, skipped ones as 0
    float* db = HAS_BIAS && p.dbias != nullptr
                    ? p.dbias + static_cast<long long>(bh) * p.Lq * p.Lk
                    : nullptr;
    auto write_db = [&](const float (&ds)[kBK / 2], int k0) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1, col = k0 + 8 * j + 2 * t + (e & 1);
          if (row < p.Lq && col < p.Lk)
            db[static_cast<long long>(row) * p.Lk + col] = ds[4 * j + e];
        }
    };
    // exp(x) = exp2(x log2 e); without a bias the scale is folded in too
    const float c = HAS_BIAS ? kLog2e : p.scale * kLog2e;
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    float s[kBK / 2], dp[kBK / 2];
    const uint32_t row_off = cw * 64 * C::W * 2;  // this group's Q, dO rows

    s9::mbar_wait(q_full, 0);  // also when no tile is visited: TMA is done
    int stage = 0;
    uint32_t phase = 0, bias_phase = 0;
    const int kt_first = db != nullptr ? 0 : kt_begin;
    const int kt_last = db != nullptr ? n_kt : kt_end;
    for (int kt = kt_first; kt < kt_last; ++kt) {
      const int k0 = kt * kBK;
      if (!visits(kt)) {
        if (db != nullptr) {
#pragma unroll
          for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
          write_db(s, k0);
        }
        continue;
      }
      // Which per-logit masks this tile needs; the segment ids of this
      // thread's 16 key columns are loaded before the wait. The key tail is
      // selected away too: a key past Lk is a zero row of K, but its logit
      // of 0 under a very small (or -1e30) lse would overflow P.
      const bool tail = k0 + kBK > p.Lk;
      bool need_mask = false;
      if (CAUSAL) need_mask = k0 + kBK - 1 > q0 + 64 * cw;
      if (POS) need_mask = pos_state(kt) == 2;
      int kv_id[HAS_SEG ? kBK / 8 : 1][2];
      bool seg_mask = false;  // the two tiles are not all one segment
      if (HAS_SEG) {
        const int* kb = k_bounds + 2 * kt;
        seg_mask = !(q_bound[0] == q_bound[1] && kb[0] == kb[1] &&
                     q_bound[0] == kb[0]);
        need_mask = need_mask || seg_mask;
        if (seg_mask) {
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + 8 * j + 2 * t + e;
              kv_id[j][e] = col < p.Lk ? kv_ids[col] : -1;
            }
        }
      }
      const uint32_t ks = k_s + stage * C::kKBytes;
      const uint32_t vs = v_s + stage * C::kKBytes;
      s9::mbar_wait(full0 + 8 * stage, phase);

      // S = Q K^T and dP = dO V^T: 64 queries x 64 keys each.
      s9::fence_regs(s);
      s9::fence_regs(dp);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t qoff = (kk * 16 / C::W) * C::kQChunk + row_off +
                              (kk * 16 % C::W) * 2;
        const uint32_t koff =
            (kk * 16 / C::W) * C::kKChunk + (kk * 16 % C::W) * 2;
        s9::wgmma_ss<kBK>(s, s9::smem_desc(q_s + qoff, 16, C::kAtom, 1),
                          s9::smem_desc(ks + koff, 16, C::kAtom, 1), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t qoff = (kk * 16 / C::W) * C::kQChunk + row_off +
                              (kk * 16 % C::W) * 2;
        const uint32_t koff =
            (kk * 16 / C::W) * C::kKChunk + (kk * 16 % C::W) * 2;
        s9::wgmma_ss<kBK>(dp, s9::smem_desc(g_s + qoff, 16, C::kAtom, 1),
                          s9::smem_desc(vs + koff, 16, C::kAtom, 1), kk > 0);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(s);
      s9::fence_regs(dp);
      if (HAS_BIAS) s9::mbar_wait(bias_full, bias_phase);

      // P = exp(logit - lse), selected to 0 where hidden, and
      // dS = P (dP - delta), in place of S; dS to bf16 A fragments.
      uint32_t da[kBK / 16][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const int col = 8 * j + 2 * t;  // this thread's keys col, col + 1
        float2 b0 = make_float2(0.f, 0.f), b1 = b0;
        if (HAS_BIAS) {
          b0 = bias_pair(bias_s, p.m.bias_bf16, rl0, col);
          b1 = bias_pair(bias_s, p.m.bias_bf16, rl1, col);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + col + (e & 1);
          float x = s[4 * j + e];
          bool visible = !tail || key < p.Lk;
          if (HAS_BIAS) {  // logit = scale * s + bias, in fp32
            const float2 bb = e < 2 ? b0 : b1;
            x = fmaf(x, p.scale, (e & 1) ? bb.y : bb.x);
            visible = visible && x > kNegInf;
          }
          if (CAUSAL && need_mask) visible = visible && key <= (e < 2 ? r0 : r1);
          if (HAS_SEG && seg_mask)
            visible = visible && kv_id[j][e & 1] == (e < 2 ? qid0 : qid1);
          if (POS && need_mask) {
            const int kp = pos_of(key, k_off0, k_off1, p.pos.seg_k);
            if (p.pos.has_valid) visible = visible && kp < p.pos.valid_len;
            if (p.pos.causal)
              visible = visible && kp <= (e < 2 ? qpos0 : qpos1);
          }
          float pv = s9::exp2_approx(fmaf(x, c, -(e < 2 ? lse0 : lse1)));
          if ((kSelect || tail) && !visible) pv = 0.f;  // selected
          s[4 * j + e] = pv * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
        }
        da[j / 2][(j & 1) * 2] = s9::pack_bf16(s[4 * j], s[4 * j + 1]);
        da[j / 2][(j & 1) * 2 + 1] =
            s9::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
      if (HAS_BIAS) {
        s9::mbar_arrive(bias_empty);
        bias_phase ^= 1;
        if (db != nullptr) write_db(s, k0);
      }

      // dQ += dS K: K MN-major, the k-step kk is keys 16kk .. 16kk + 15.
      s9::fence_regs(dq);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        s9::wgmma_rs<DP>(dq, da[kk],
                         s9::smem_desc(ks + kk * 16 * C::W * 2, C::kKChunk,
                                       C::kAtom, 1),
                         1);
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(dq);
      s9::mbar_arrive(empty0 + 8 * stage);  // K and V of this stage are read
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue: dQ * scale in bf16 through dq's strides; rows past Lq and
    // columns past d are not written.
    __nv_bfloat16* ob = p.dq + b * p.dqs[0] + h * p.dqs[1];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < p.d) {
        if (r0 < p.Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + r0 * p.dqs[2] + col) =
              __floats2bfloat162_rn(dq[4 * j] * p.scale,
                                    dq[4 * j + 1] * p.scale);
        if (r1 < p.Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + r1 * p.dqs[2] + col) =
              __floats2bfloat162_rn(dq[4 * j + 2] * p.scale,
                                    dq[4 * j + 3] * p.scale);
      }
    }
  }
}

// K3.
template <int DP, bool CAUSAL, bool HAS_BIAS, bool HAS_SEG>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg,
                         const __grid_constant__ Params p) {
  flash_bwd_dq_body<DP, CAUSAL, HAS_BIAS, HAS_SEG, false>(tq, tk, tv, tg, p);
}

// K6: the position masks under a global lse.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_pos_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tg,
                             const __grid_constant__ Params p) {
  flash_bwd_dq_body<DP, false, false, false, true>(tq, tk, tv, tg, p);
}

// The q, k, v and dO tensor maps, then `kernel` on one block per (b*h, 128
// queries).
template <int DP, typename Kernel>
cudaError_t launch_on(Kernel kernel, int smem, const void* q, const void* k,
                      const void* v, const void* g, int B,
                      const long long* st, const Params& p,
                      cudaStream_t stream) {
  using C = Cfg<DP, false>;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err =
      s9::make_map(&tq, q, p.d, p.Lq, p.H, B, st, C::W, kBQ, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tk, k, p.d, p.Lk, p.H, B, st + 3, C::W, kBK, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tv, v, p.d, p.Lk, p.H, B, st + 6, C::W, kBK, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tg, g, p.d, p.Lq, p.H, B, st + 9, C::W, kBQ, sw);
  if (err != cudaSuccess) return err;
  return s9::launch_kernel(kernel, B * p.H * p.n_qt, kThreads, smem, stream,
                           tq, tk, tv, tg, p);
}

template <int DP, bool CAUSAL, bool HAS_BIAS, bool HAS_SEG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, int B, const long long* st,
                   const Params& p, cudaStream_t stream) {
  return launch_on<DP>(
      flash_bwd_dq_sm90_kernel<DP, CAUSAL, HAS_BIAS, HAS_SEG>,
      Cfg<DP, HAS_BIAS>::kSmemBytes, q, k, v, g, B, st, p, stream);
}

// The eight forms at one head dim; code = 4*causal + 2*has_bias + has_seg.
template <int DP>
cudaError_t launch_form(int code, const void* q, const void* k, const void* v,
                        const void* g, int B, const long long* st,
                        const Params& p, cudaStream_t s) {
  switch (code) {
#define FDSD_FORM(CODE, CA, BI, SE) \
  case CODE:                        \
    return launch<DP, CA, BI, SE>(q, k, v, g, B, st, p, s);
    FDSD_FORM(0, false, false, false)
    FDSD_FORM(1, false, false, true)
    FDSD_FORM(2, false, true, false)
    FDSD_FORM(3, false, true, true)
    FDSD_FORM(4, true, false, false)
    FDSD_FORM(5, true, false, true)
    FDSD_FORM(6, true, true, false)
    FDSD_FORM(7, true, true, true)
#undef FDSD_FORM
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: (batch, head, seq) element strides of q, k, v, dO, dq, then
// (batch, head, row, col) of the bias (19 values); the head-dim stride is 1.
// lse and delta are (B, H, Lq) contiguous fp32. bias (fp32, or bf16 when
// bias_bf16), dbias (fp32 (B, H, Lq, Lk) contiguous, only with a bias) and
// the six segment arrays of mask.cuh (at (128, 64) tiles) are null when not
// asked for. Head dims 64 and 128; others return cudaErrorInvalidValue.
extern "C" int fdsd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dq, void* dbias,
                                 const void* bias, const void* q_ids,
                                 const void* kv_ids, const void* q_bounds,
                                 const void* kv_bounds, const void* lo,
                                 const void* hi, int B, int H, int Lq, int Lk,
                                 int d, const long long* strides, float scale,
                                 int causal, int bias_bf16, void* stream) {
  Params p = {};
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dbias = bias != nullptr ? static_cast<float*>(dbias) : nullptr;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.n_qt = (Lq + kBQ - 1) / kBQ;
  for (int i = 0; i < 3; ++i) p.dqs[i] = strides[12 + i];
  p.scale = scale;
  p.m = fdsd::make_mask_args(bias, strides + 15, bias_bf16, q_ids, kv_ids,
                             q_bounds, kv_bounds, lo, hi);
  const int code = 4 * (causal != 0) + 2 * (bias != nullptr) +
                   (q_ids != nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64)
    err = launch_form<64>(code, q, k, v, g, B, strides, p, s);
  else if (d == 128)
    err = launch_form<128>(code, q, k, v, g, B, strides, p, s);
  return static_cast<int>(err);
}

// K6. strides: (batch, head, seq) element strides of q, k, v, dO, dq (15
// values); the head-dim stride is 1. lse and delta are (B, H, Lq) contiguous
// fp32, the global ones; q_off and k_off are int32[2] in device memory. Head
// dims 64 and 128; others return cudaErrorInvalidValue.
extern "C" int fdsd_flash_bwd_pos_dq(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, const void* q_off,
    const void* k_off, int B, int H, int Lq, int Lk, int d,
    const long long* strides, float scale, int seg_q, int seg_k, int valid_len,
    int has_valid, int causal, void* stream) {
  Params p = {};
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.n_qt = (Lq + kBQ - 1) / kBQ;
  for (int i = 0; i < 3; ++i) p.dqs[i] = strides[12 + i];
  p.scale = scale;
  p.pos = PosArgs{static_cast<const int*>(q_off),
                  static_cast<const int*>(k_off), seg_q, seg_k, valid_len,
                  has_valid, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64)
    err = launch_on<64>(flash_bwd_pos_dq_sm90_kernel<64>,
                        Cfg<64, false>::kSmemBytes, q, k, v, g, B, strides,
                        p, s);
  else if (d == 128)
    err = launch_on<128>(flash_bwd_pos_dq_sm90_kernel<128>,
                         Cfg<128, false>::kSmemBytes, q, k, v, g, B, strides,
                         p, s);
  return static_cast<int>(err);
}
