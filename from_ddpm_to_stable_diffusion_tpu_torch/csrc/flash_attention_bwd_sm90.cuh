// Flash-attention backward dk / dv for Hopper (sm_90a) on TMA and wgmma:
// bf16 in and out, fp32 softmax reconstruction and accumulators. K4 at every
// padded head dim DP up to 256 (a multiple of 16 up to 128, of 32 above), in
// every form, and K7, its position-masked form, at the same widths. The
// kernels and their launch templates live here; flash_attention_bwd_sm90.cu
// holds the C entries, and each flash_attention_bwd_sm90_w*.cu instantiates
// a few widths of both.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel
//     (K4) in all of its forms: ragged Lq and Lk, CAUSAL (key <= query from
//     index 0 on both sides), HAS_BIAS (an additive bias read through its
//     strides, added in fp32 after the scale) and HAS_SEG (segment ids:
//     same-id pairs only), as template parameters beside the head dim (64:
//     SigLIP tower, TinyVLM decoder, T5; 128: tiny-SD; 96, 160, 192 ...:
//     tiny-SD at other widths);
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel_pos
//     (K7): the same gradients of a LOCAL block of queries against a LOCAL
//     block of keys under a GLOBAL softmax over more keys than this block
//     holds, with the position masks of K5 (flash_attention_sm90.cu): the
//     MMDiT's training step runs it four times per joint block at (2, 24,
//     {154, 4096}, {154, 4096}, 64) under the lse merged over both streams.
// It recomputes the probabilities under the caller's lse (K4: the forward's;
// K7: the global one), P = exp(scale * Q K^T + bias - lse), selected to 0
// where a mask hides the key (never multiplied: a row that saw no key has
// lse = -1e30, and under K7 a row that only another block's keys see has a
// finite lse and is masked in every tile here), with delta = rowsum(dO *
// out) computed beforehand (fp32, by the caller):
//   dV = P^T dO,  dS = P * (dO V^T - delta),  dK = scale * dS^T Q;
// under K7 the contributions of several key blocks add up in the caller.
// The TPU's sequential query-block grid axis is a loop inside the block.
//
// What bounds it on the H100: four L^2 * d products per (b, h), thousands of
// flop per byte of q, k, v and dO at the tiny-SD and MMDiT shapes:
// operations, so the tensor cores' issue rate and, at d = 64, the
// exponentials. The mma.sync kernels it replaces reached ~9 % (K4) and ~13 %
// (K7) of that bound: tiles were loaded synchronously, P^T and dS^T went
// through shared memory (K4), and no load overlapped a product.
//
// Design, up to DP = 128. One block of three warpgroups per (b*h, 128 keys):
//  - a producer warpgroup gives up its registers (setmaxnreg 40). One thread
//    issues TMA: the block's K and V tiles once, then Q and dO tiles of 64
//    queries into a two-stage ring with full / empty mbarriers, so that the
//    next tile's copy overlaps this tile's products. Its threads store the
//    tile's lse (pre-multiplied by log2 e), delta and segment ids beside
//    them, arriving on the same barrier, and in the bias form stage the
//    (64 queries x 128 keys) bias tile in its own dtype by cp.async, as K1's
//    producer does (one stage, swizzled). The tensor maps are 4-D (D, L, H,
//    B) over the operands' own strides; rows past Lq or Lk read as zeros.
//  - two consumer warpgroups of 64 keys each (setmaxnreg 232) compute
//    S^T = K Q^T and dP^T = V dO^T with the keys as wgmma's M (m64n64k16, SS
//    form, both operands K-major as TMA wrote them). P^T and dS^T then lie in
//    the accumulator layout, which, converted to bf16 in registers, is the A
//    operand of the RS form: dV += P^T dO and dK += dS^T Q (m64nDPk16) read
//    dO and Q from the same shared tiles MN-major, as K1 reads V. No
//    transposed copy, no P^T or dS^T in shared memory, four products per
//    query tile; dK and dV (64 x DP fp32 each) stay in registers.
//  - query rows past Lq get lse = +1e30 (P = 0) and zero Q and dO; key rows
//    past Lk only reach their own rows of dK and dV, which are not written.
//    Causal starts at the first query tile that reaches the key tile and
//    masks per logit only where a tile crosses the diagonal; segment ids walk
//    the tile range [lo, hi] of mask.cuh at (64 queries, 128 keys), skip a
//    tile whose ids are disjoint, and mask per logit only where the two
//    tiles are not one same segment. A key that no query sees gets 0.
//  - K7 (POS) is one more form, with its own kernel name
//    (flash_bwd_pos_dkv_sm90_kernel) so that profiles and the SASS check
//    tell it from K4. Its masks are runtime flags read per tile: every role
//    judges each (query tile, key tile) pair by the same pos_pair of the two
//    tiles' position bounds (pos_tile.cuh), so producer and consumers walk
//    the same tiles and the ring's phases stay in step: skipped, wholly
//    visible, or masked per logit (key index < Lk, key position < valid_len,
//    key position <= query position when causal). A key tile wholly past
//    valid_len walks nothing.
//  - above DP = 128 dK and dV (64 x DP fp32 each a consumer) no longer fit
//    in the registers, so the kernel takes another form above it
//    (flash_bwd_dkv_wide_body): one block per key tile of 64 keys,
//    64-query tiles on the two-stage Q / dO ring. The
//    two consumer warpgroups split the query tile: each computes S^T =
//    K Q^T and dP^T = V dO^T for all 64 keys and its 32 queries over the
//    whole head dim (m64n32k16 SS), so S^T and dP^T are computed once a key
//    tile and every exponential taken once. Each converts its P^T and dS^T
//    to bf16 into its half of two shared tiles (64 keys x 64 queries,
//    128-byte swizzle, as wgmma's K-major A operand); the two meet at a
//    named barrier, and each runs dV += P^T dO and dK += dS^T Q over its
//    half of the columns (m64n(DP/2)k16 SS: P^T and dS^T from the shared
//    tiles, dO and Q MN-major from the ring), so dK and dV of 64 keys x DP/2
//    fp32 (128 registers a thread at DP = 256) stay in registers. A second
//    named barrier keeps a consumer from overwriting the tiles before the
//    other has read them. At DP = 256 K and V take 64 KB, the ring 128 KB,
//    the two tiles 16 KB and a bias tile 16 KB (231,992 B in all). FA3's
//    backward splits dK / dV across its consumer warpgroups the same way; the
//    form it replaces split each 128-key tile over two blocks by columns,
//    each recomputing S^T and dP^T over the whole head dim at 32-query tiles
//    (six L^2 d products a key tile where four are needed). The two
//    consumers work in lockstep, so the tensor cores wait while both take
//    the exponentials and meet at the barriers; queueing the next tile's
//    S^T / dP^T behind this tile's dV / dK (wgmma_wait<1>) measured slower
//    on the H100, and so did K and V as register A operands at DP = 160.
//    The wrapper's segment-id tiles follow ((64, 64) above 128: _dkv_tiles
//    in ops/flash_attention.py).
//  - swizzle: 128-byte where a consumer's column range is whole 64-column
//    chunks, else 32-byte atoms of 16 columns. At DP = 64 and 128 each mask
//    form has its own instantiation; at other widths one instantiation with
//    the three mask paths compiled in (ANY) takes the ones a launch asks for.
// dk (times scale) and dv are written in bf16 through their strides.

#pragma once

#include "mask.cuh"
#include "pos_tile.cuh"
#include "sm90.cuh"

namespace fdsd::k4 {

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
constexpr int kBQ = 64, kBK = 128;  // key tile up to DP 128, else kBK / 2
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int DP, bool HAS_BIAS>
struct Cfg {
  // above 128: one 64-key block, the consumers split queries and columns
  static constexpr bool kWide = DP > 128;
  static constexpr int kBK = DP <= 128 ? k4::kBK : k4::kBK / 2;  // keys
  static constexpr int kBQ = k4::kBQ;                            // queries
  static constexpr int kDC = kWide ? DP / 2 : DP;  // dK / dV columns a consumer
  // columns per swizzle row: a consumer's column range starts on a chunk
  static constexpr int W = DP % 64 == 0 && kDC % 64 == 0 ? 64 : 16;
  static constexpr uint32_t kLayout = W == 64 ? 1 : 3;  // 128B / 32B swizzle
  static constexpr int kChunks = DP / W;
  static constexpr int kStages = 2;  // Q / dO ring
  static constexpr uint32_t kAtom = 8 * W * 2;  // 8 rows of a chunk
  static constexpr int kKChunk = kBK * W * 2;   // one chunk of K or V
  static constexpr int kQChunk = kBQ * W * 2;   // one chunk of Q or dO
  static constexpr int kKBytes = kBK * DP * 2;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kVOff = kKBytes;
  static constexpr int kQOff = 2 * kKBytes;
  static constexpr int kGOff = kQOff + kStages * kQBytes;
  // wide: the P^T and dS^T tiles (kBK keys x kBQ queries bf16 each)
  static constexpr int kPOff = kGOff + kStages * kQBytes;
  static constexpr int kPBytes = kBK * kBQ * 2;
  // per stage: lse * log2 e, delta, query segment ids (kBQ each)
  static constexpr int kRowOff = kPOff + (kWide ? 2 * kPBytes : 0);
  static constexpr int kRowFloats = 3 * kBQ;
  static constexpr int kBiasOff = kRowOff + kStages * kRowFloats * 4;
  static constexpr int kBarOff = kBiasOff + (HAS_BIAS ? kBQ * kBK * 4 : 0);
  // K / V full; Q / dO full and empty per stage; bias full and empty
  static constexpr int kBars = 1 + 2 * kStages + 2;
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(DP % 16 == 0 && DP >= 16 && DP <= 256 &&
                    (DP <= 128 || DP % 32 == 0),
                "head dim");
};

struct Params {
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* lse;
  const float* delta;
  int H, Lq, Lk, d, n_kt;
  int causal;  // the ANY instantiation's causal flag
  long long dks[3], dvs[3];  // dk's and dv's (batch, head, seq) strides
  float scale;
  MaskArgs m;
  PosArgs pos;  // K7 only
};

// One element of the staged bias tile of BK keys, (query row r, key column
// c).
template <int BK>
__device__ __forceinline__ float bias_elem(const void* tile, int bf16, int r,
                                           int c) {
  const int i = s9::bias_at<BK>(r, c);
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(tile)[i])
              : static_cast<const float*>(tile)[i];
}

// The kernel body of K4 up to DP = 128 (POS = false) and K7 (POS = true, no
// other mask).
// CAUSAL, HAS_BIAS, HAS_SEG: the mask paths compiled in; with ANY each is
// taken only where the launch asks for it (p.causal, a bias, segment ids).
template <int DP, bool CAUSAL, bool HAS_BIAS, bool HAS_SEG, bool POS,
          bool ANY = false>
__device__ __forceinline__ void flash_bwd_dkv_body(const CUtensorMap& tq,
                                                   const CUtensorMap& tk,
                                                   const CUtensorMap& tv,
                                                   const CUtensorMap& tg,
                                                   const Params& p) {
  using C = Cfg<DP, HAS_BIAS>;
  constexpr int BQ = C::kBQ, kBK = C::kBK;
  constexpr bool kSelect = CAUSAL || HAS_BIAS || HAS_SEG || POS;
  static_assert(!POS || !(CAUSAL || HAS_BIAS || HAS_SEG), "K7's masks");
  static_assert(!C::kWide, "up to DP = 128");
  const bool causal = CAUSAL && (!ANY || p.causal != 0);
  const bool has_bias = HAS_BIAS && (!ANY || p.m.bias != nullptr);
  const bool has_seg = HAS_SEG && (!ANY || p.m.q_ids != nullptr);

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  float* rows_s = reinterpret_cast<float*>(smem + C::kRowOff);
  void* bias_s = smem + C::kBiasOff;
  const uint32_t k_s = base, v_s = base + C::kVOff;
  const uint32_t q_s = base + C::kQOff, g_s = base + C::kGOff;
  const uint32_t kv_full = base + C::kBarOff;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * C::kStages;
  const uint32_t bias_full = empty0 + 8 * C::kStages, bias_empty = bias_full + 8;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / p.n_kt, kt = blockIdx.x % p.n_kt;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = kt * kBK;

  if (tid == 0) {
    s9::mbar_init(kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      s9::mbar_init(full0 + 8 * s, 128);  // TMA's arrival + 127 row stores
      s9::mbar_init(empty0 + 8 * s, kConsumers);
    }
    if (has_bias) {
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

  // The query tiles this block visits, the same walk in every role: all of
  // them; from the first that reaches the key tile when causal; the range
  // whose segment ids overlap this key tile's, less the disjoint tiles;
  // under position masks, those pos_pair does not skip (none when the whole
  // key tile lies past valid_len).
  const int n_qt = (p.Lq + BQ - 1) / BQ;
  int it_begin = 0, it_end = n_qt;
  if (causal) it_begin = k0 / BQ;
  int q_off0 = 0, q_off1 = 0, k_lo = 0, k_hi = 0;
  if (POS) {
    q_off0 = p.pos.q_off[0];
    q_off1 = p.pos.q_off[1];
    pos_bounds(k0, kBK, p.pos.k_off[0], p.pos.k_off[1], p.pos.seg_k, p.Lk,
               k_lo, k_hi);
    if (p.pos.has_valid && k_lo >= p.pos.valid_len) it_end = 0;
  }
  // pos_pair of query tile it with this key tile: 0 skip, 1 visible, 2 masked
  auto pos_state = [&](int it) {
    int q_lo, q_hi;
    pos_bounds(it * BQ, BQ, q_off0, q_off1, p.pos.seg_q, p.Lq, q_lo, q_hi);
    return pos_pair(p.pos, q_lo, q_hi, k_lo, k_hi);
  };
  const int* k_bound = nullptr;
  const int* q_bounds = nullptr;
  if (has_seg) {
    const int kv_tile = b * p.n_kt + kt;
    it_begin = max(it_begin, p.m.lo[kv_tile]);
    it_end = min(it_end, p.m.hi[kv_tile] + 1);
    k_bound = p.m.kv_bounds + 2 * kv_tile;
    q_bounds = p.m.q_bounds + 2 * b * n_qt;
  }

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      s9::mbar_expect_tx(kv_full, 2 * C::kKBytes);
      for (int c = 0; c < C::kChunks; ++c) {
        s9::tma_load_4d(k_s + c * C::kKChunk, &tk, kv_full, c * C::W, k0, h,
                        b);
        s9::tma_load_4d(v_s + c * C::kKChunk, &tv, kv_full, c * C::W, k0, h,
                        b);
      }
    }
    const float* lse_b = p.lse + static_cast<long long>(bh) * p.Lq;
    const float* dl_b = p.delta + static_cast<long long>(bh) * p.Lq;
    const int* qid_b =
        has_seg ? p.m.q_ids + static_cast<long long>(b) * p.Lq : nullptr;
    const long long bias_base = has_bias ? b * p.m.bs[0] + h * p.m.bs[1] : 0;
    int stage = 0;
    uint32_t phase = 0, bias_phase = 0;
    for (int it = it_begin; it < it_end; ++it) {
      if (has_seg && !seg_overlap(k_bound, q_bounds + 2 * it)) continue;
      if (POS && pos_state(it) == 0) continue;
      const int q0 = it * BQ;
      const uint32_t full = full0 + 8 * stage;
      s9::mbar_wait(empty0 + 8 * stage, phase ^ 1);
      if (tid < BQ) {  // the tile's row statistics, stored before arriving
        float* rs = rows_s + stage * C::kRowFloats;
        const int q = q0 + tid;
        const bool in = q < p.Lq;
        rs[tid] = in ? lse_b[q] * kLog2e : kPadLse;
        rs[BQ + tid] = in ? dl_b[q] : 0.f;
        if (has_seg)
          reinterpret_cast<int*>(rs)[2 * BQ + tid] = in ? qid_b[q] : -1;
      }
      if (tid == 0) {
        s9::mbar_expect_tx(full, 2 * C::kQBytes);
        const uint32_t off = stage * C::kQBytes;
        for (int c = 0; c < C::kChunks; ++c) {
          s9::tma_load_4d(q_s + off + c * C::kQChunk, &tq, full, c * C::W, q0,
                          h, b);
          s9::tma_load_4d(g_s + off + c * C::kQChunk, &tg, full, c * C::W, q0,
                          h, b);
        }
      } else {
        s9::mbar_arrive(full);
      }
      if (HAS_BIAS && has_bias) {
        s9::mbar_wait(bias_empty, bias_phase ^ 1);
        if (p.m.bias_bf16)
          s9::stage_bias<BQ, kBK>(static_cast<__nv_bfloat16*>(bias_s), p.m,
                                  bias_base, q0, k0, p.Lq, p.Lk, tid,
                                  bias_full);
        else
          s9::stage_bias<BQ, kBK>(static_cast<float*>(bias_s), p.m,
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
    const int cw = (tid - 128) / 128;  // key rows 64*cw .. 64*cw + 63
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl0 = 64 * cw + 16 * warp + g, rl1 = rl0 + 8;  // tile rows
    const int key0 = k0 + rl0, key1 = k0 + rl1;
    int kid0 = -2, kid1 = -2;  // segment ids of this thread's two keys
    if (has_seg) {
      const int* ids = p.m.kv_ids + static_cast<long long>(b) * p.Lk;
      if (key0 < p.Lk) kid0 = ids[key0];
      if (key1 < p.Lk) kid1 = ids[key1];
    }
    // K7: the positions of this thread's two keys and whether any query
    // could see them (index < Lk, position < valid_len)
    int kpos0 = 0, kpos1 = 0;
    bool kvis0 = true, kvis1 = true;
    if (POS) {
      kpos0 = pos_of(key0, p.pos.k_off[0], p.pos.k_off[1], p.pos.seg_k);
      kpos1 = pos_of(key1, p.pos.k_off[0], p.pos.k_off[1], p.pos.seg_k);
      kvis0 = key0 < p.Lk && (!p.pos.has_valid || kpos0 < p.pos.valid_len);
      kvis1 = key1 < p.Lk && (!p.pos.has_valid || kpos1 < p.pos.valid_len);
    }
    // exp(x) = exp2(x log2 e); without a bias the scale is folded in too
    const float c = has_bias ? kLog2e : p.scale * kLog2e;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    float s[BQ / 2], dp[BQ / 2];
    const uint32_t row_off = cw * 64 * C::W * 2;  // this group's K, V rows

    s9::mbar_wait(kv_full, 0);  // also when no tile is visited: TMA is done
    int stage = 0;
    uint32_t phase = 0, bias_phase = 0;
    for (int it = it_begin; it < it_end; ++it) {
      if (has_seg && !seg_overlap(k_bound, q_bounds + 2 * it)) continue;
      const int state = POS ? pos_state(it) : 1;
      if (state == 0) continue;
      const int q0 = it * BQ;
      // Which per-logit masks this tile needs.
      bool need_mask = state == 2;
      if (causal) need_mask = k0 + 64 * cw + 63 > q0;
      if (has_seg) {
        const int* qb = q_bounds + 2 * it;
        need_mask = need_mask || !(k_bound[0] == k_bound[1] &&
                                   qb[0] == qb[1] && qb[0] == k_bound[0]);
      }
      const uint32_t qs = q_s + stage * C::kQBytes;
      const uint32_t gs = g_s + stage * C::kQBytes;
      s9::mbar_wait(full0 + 8 * stage, phase);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries each, over the
      // whole head dim.
      s9::fence_regs(s);
      s9::fence_regs(dp);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk * 16 / C::W) * C::kKChunk + row_off +
                             (kk * 16 % C::W) * 2;
        const uint32_t qoff =
            (kk * 16 / C::W) * C::kQChunk + (kk * 16 % C::W) * 2;
        s9::wgmma_ss<BQ>(s, s9::smem_desc(k_s + off, 16, C::kAtom, C::kLayout),
                         s9::smem_desc(qs + qoff, 16, C::kAtom, C::kLayout),
                         kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk * 16 / C::W) * C::kKChunk + row_off +
                             (kk * 16 % C::W) * 2;
        const uint32_t qoff =
            (kk * 16 / C::W) * C::kQChunk + (kk * 16 % C::W) * 2;
        s9::wgmma_ss<BQ>(dp,
                         s9::smem_desc(v_s + off, 16, C::kAtom, C::kLayout),
                         s9::smem_desc(gs + qoff, 16, C::kAtom, C::kLayout),
                         kk > 0);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(s);
      s9::fence_regs(dp);
      if (HAS_BIAS && has_bias) s9::mbar_wait(bias_full, bias_phase);

      // P^T = exp(logit - lse), selected to 0 where hidden, and
      // dS^T = P^T (dP^T - delta), both to bf16 A fragments in registers.
      const float* rs = rows_s + stage * C::kRowFloats;
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int col = 8 * j + 2 * t;  // this thread's queries col, col + 1
        const float2 lse2 = *reinterpret_cast<const float2*>(rs + col);
        const float2 dl2 = *reinterpret_cast<const float2*>(rs + BQ + col);
        int2 qid2 = make_int2(-1, -1);
        if (has_seg && need_mask)
          qid2 = *reinterpret_cast<const int2*>(rs + 2 * BQ + col);
        int qpos[2] = {0, 0};  // K7: positions of the two queries
        if (POS && need_mask && p.pos.causal) {
          qpos[0] = pos_of(q0 + col, q_off0, q_off1, p.pos.seg_q);
          qpos[1] = pos_of(q0 + col + 1, q_off0, q_off1, p.pos.seg_q);
        }
        float pr[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = col + (e & 1);
          float x = s[4 * j + e];
          bool visible = true;
          if (HAS_BIAS && has_bias) {  // logit = scale * s + bias, in fp32
            x = fmaf(x, p.scale, bias_elem<kBK>(bias_s, p.m.bias_bf16, qc,
                                                e < 2 ? rl0 : rl1));
            visible = x > kNegInf;
          }
          if (CAUSAL && causal && need_mask)
            visible = visible && (e < 2 ? key0 : key1) <= q0 + qc;
          if (HAS_SEG && has_seg && need_mask)
            visible = visible && (e < 2 ? kid0 : kid1) ==
                                     ((e & 1) ? qid2.y : qid2.x);
          if (POS && need_mask) {
            visible = visible && (e < 2 ? kvis0 : kvis1);
            if (p.pos.causal)
              visible = visible && (e < 2 ? kpos0 : kpos1) <= qpos[e & 1];
          }
          float pv = s9::exp2_approx(fmaf(x, c, -((e & 1) ? lse2.y : lse2.x)));
          if (kSelect && !visible) pv = 0.f;  // selected, not multiplied
          pr[e] = pv;
          ds[e] = pv * (dp[4 * j + e] - ((e & 1) ? dl2.y : dl2.x));
        }
        pa[j / 2][(j & 1) * 2] = s9::pack_bf16(pr[0], pr[1]);
        pa[j / 2][(j & 1) * 2 + 1] = s9::pack_bf16(pr[2], pr[3]);
        da[j / 2][(j & 1) * 2] = s9::pack_bf16(ds[0], ds[1]);
        da[j / 2][(j & 1) * 2 + 1] = s9::pack_bf16(ds[2], ds[3]);
      }
      if (HAS_BIAS && has_bias) {
        s9::mbar_arrive(bias_empty);
        bias_phase ^= 1;
      }

      // dV += P^T dO, dK += dS^T Q: dO and Q MN-major, the k-step kk is
      // queries 16kk .. 16kk + 15.
      s9::fence_regs(dv);
      s9::fence_regs(dk);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        s9::wgmma_rs<DP>(dv, pa[kk],
                         s9::smem_desc(gs + kk * 16 * C::W * 2, C::kQChunk,
                                       C::kAtom, C::kLayout),
                         1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        s9::wgmma_rs<DP>(dk, da[kk],
                         s9::smem_desc(qs + kk * 16 * C::W * 2, C::kQChunk,
                                       C::kAtom, C::kLayout),
                         1);
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(dv);
      s9::fence_regs(dk);
      s9::mbar_arrive(empty0 + 8 * stage);  // Q, dO and rows of this stage
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue: dK * scale and dV in bf16 through their strides; key rows
    // past Lk are not written.
    __nv_bfloat16* kb = p.dk + b * p.dks[0] + h * p.dks[1];
    __nv_bfloat16* vb = p.dv + b * p.dvs[0] + h * p.dvs[1];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < p.d) {
        if (key0 < p.Lk) {
          *reinterpret_cast<__nv_bfloat162*>(kb + key0 * p.dks[2] + col) =
              __floats2bfloat162_rn(dk[4 * j] * p.scale,
                                    dk[4 * j + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(vb + key0 * p.dvs[2] + col) =
              __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
        }
        if (key1 < p.Lk) {
          *reinterpret_cast<__nv_bfloat162*>(kb + key1 * p.dks[2] + col) =
              __floats2bfloat162_rn(dk[4 * j + 2] * p.scale,
                                    dk[4 * j + 3] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(vb + key1 * p.dvs[2] + col) =
              __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
        }
      }
    }
  }
}

// The kernel body of K4 above DP = 128 (POS = false) and K7 there (POS =
// true, no other mask): one block per (b*h, 64 keys), the consumers
// splitting each 64-query tile for S^T and dP^T and the columns for dK and
// dV (the design notes at the top of the file).
template <int DP, bool CAUSAL, bool HAS_BIAS, bool HAS_SEG, bool POS,
          bool ANY>
__device__ __forceinline__ void flash_bwd_dkv_wide_body(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tg, const Params& p) {
  using C = Cfg<DP, HAS_BIAS>;
  constexpr int BQ = C::kBQ, kBK = C::kBK, DC = C::kDC;
  constexpr int kHQ = BQ / 2;  // queries of one consumer: S^T is m64 n32
  constexpr bool kSelect = CAUSAL || HAS_BIAS || HAS_SEG || POS;
  static_assert(C::kWide && kBK == 64 && BQ == 64, "the wide form");
  static_assert(!POS || !(CAUSAL || HAS_BIAS || HAS_SEG), "K7's masks");
  const bool causal = CAUSAL && (!ANY || p.causal != 0);
  const bool has_bias = HAS_BIAS && (!ANY || p.m.bias != nullptr);
  const bool has_seg = HAS_SEG && (!ANY || p.m.q_ids != nullptr);

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  float* rows_s = reinterpret_cast<float*>(smem + C::kRowOff);
  void* bias_s = smem + C::kBiasOff;
  const uint32_t k_s = base, v_s = base + C::kVOff;
  const uint32_t q_s = base + C::kQOff, g_s = base + C::kGOff;
  const uint32_t p_s = base + C::kPOff, d_s = p_s + C::kPBytes;
  const uint32_t kv_full = base + C::kBarOff;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * C::kStages;
  const uint32_t bias_full = empty0 + 8 * C::kStages, bias_empty = bias_full + 8;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / p.n_kt, kt = blockIdx.x % p.n_kt;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = kt * kBK;

  if (tid == 0) {
    s9::mbar_init(kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      s9::mbar_init(full0 + 8 * s, 128);  // TMA's arrival + 127 row stores
      s9::mbar_init(empty0 + 8 * s, kConsumers);
    }
    if (has_bias) {
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

  // The query tiles this block visits, the same walk in every role: all of
  // them; from the first that reaches the key tile when causal; the range
  // whose segment ids overlap this key tile's, less the disjoint tiles;
  // under position masks, those pos_pair does not skip (none when the whole
  // key tile lies past valid_len).
  const int n_qt = (p.Lq + BQ - 1) / BQ;
  int it_begin = 0, it_end = n_qt;
  if (causal) it_begin = k0 / BQ;
  int q_off0 = 0, q_off1 = 0, k_lo = 0, k_hi = 0;
  if (POS) {
    q_off0 = p.pos.q_off[0];
    q_off1 = p.pos.q_off[1];
    pos_bounds(k0, kBK, p.pos.k_off[0], p.pos.k_off[1], p.pos.seg_k, p.Lk,
               k_lo, k_hi);
    if (p.pos.has_valid && k_lo >= p.pos.valid_len) it_end = 0;
  }
  // pos_pair of query tile it with this key tile: 0 skip, 1 visible, 2 masked
  auto pos_state = [&](int it) {
    int q_lo, q_hi;
    pos_bounds(it * BQ, BQ, q_off0, q_off1, p.pos.seg_q, p.Lq, q_lo, q_hi);
    return pos_pair(p.pos, q_lo, q_hi, k_lo, k_hi);
  };
  const int* k_bound = nullptr;
  const int* q_bounds = nullptr;
  if (has_seg) {
    const int kv_tile = b * p.n_kt + kt;
    it_begin = max(it_begin, p.m.lo[kv_tile]);
    it_end = min(it_end, p.m.hi[kv_tile] + 1);
    k_bound = p.m.kv_bounds + 2 * kv_tile;
    q_bounds = p.m.q_bounds + 2 * b * n_qt;
  }

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      s9::mbar_expect_tx(kv_full, 2 * C::kKBytes);
      for (int c = 0; c < C::kChunks; ++c) {
        s9::tma_load_4d(k_s + c * C::kKChunk, &tk, kv_full, c * C::W, k0, h,
                        b);
        s9::tma_load_4d(v_s + c * C::kKChunk, &tv, kv_full, c * C::W, k0, h,
                        b);
      }
    }
    const float* lse_b = p.lse + static_cast<long long>(bh) * p.Lq;
    const float* dl_b = p.delta + static_cast<long long>(bh) * p.Lq;
    const int* qid_b =
        has_seg ? p.m.q_ids + static_cast<long long>(b) * p.Lq : nullptr;
    const long long bias_base = has_bias ? b * p.m.bs[0] + h * p.m.bs[1] : 0;
    int stage = 0;
    uint32_t phase = 0, bias_phase = 0;
    for (int it = it_begin; it < it_end; ++it) {
      if (has_seg && !seg_overlap(k_bound, q_bounds + 2 * it)) continue;
      if (POS && pos_state(it) == 0) continue;
      const int q0 = it * BQ;
      const uint32_t full = full0 + 8 * stage;
      s9::mbar_wait(empty0 + 8 * stage, phase ^ 1);
      if (tid < BQ) {  // the tile's row statistics, stored before arriving
        float* rs = rows_s + stage * C::kRowFloats;
        const int q = q0 + tid;
        const bool in = q < p.Lq;
        rs[tid] = in ? lse_b[q] * kLog2e : kPadLse;
        rs[BQ + tid] = in ? dl_b[q] : 0.f;
        if (has_seg)
          reinterpret_cast<int*>(rs)[2 * BQ + tid] = in ? qid_b[q] : -1;
      }
      if (tid == 0) {
        s9::mbar_expect_tx(full, 2 * C::kQBytes);
        const uint32_t off = stage * C::kQBytes;
        for (int c = 0; c < C::kChunks; ++c) {
          s9::tma_load_4d(q_s + off + c * C::kQChunk, &tq, full, c * C::W, q0,
                          h, b);
          s9::tma_load_4d(g_s + off + c * C::kQChunk, &tg, full, c * C::W, q0,
                          h, b);
        }
      } else {
        s9::mbar_arrive(full);
      }
      if (HAS_BIAS && has_bias) {
        s9::mbar_wait(bias_empty, bias_phase ^ 1);
        if (p.m.bias_bf16)
          s9::stage_bias<BQ, kBK>(static_cast<__nv_bfloat16*>(bias_s), p.m,
                                  bias_base, q0, k0, p.Lq, p.Lk, tid,
                                  bias_full);
        else
          s9::stage_bias<BQ, kBK>(static_cast<float*>(bias_s), p.m,
                                  bias_base, q0, k0, p.Lq, p.Lk, tid,
                                  bias_full);
        bias_phase ^= 1;
      }
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // --------------------------------------------------------------- consumers
  s9::reg_alloc<kConsumerRegs>();
  const int cw = (tid - 128) / 128;  // queries 32cw .. of a tile, columns DC cw ..
  const int warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = 16 * warp + g, rl1 = rl0 + 8;  // key rows of the tile
  const int key0 = k0 + rl0, key1 = k0 + rl1;
  int kid0 = -2, kid1 = -2;  // segment ids of this thread's two keys
  if (has_seg) {
    const int* ids = p.m.kv_ids + static_cast<long long>(b) * p.Lk;
    if (key0 < p.Lk) kid0 = ids[key0];
    if (key1 < p.Lk) kid1 = ids[key1];
  }
  // K7: the positions of this thread's two keys and whether any query
  // could see them (index < Lk, position < valid_len)
  int kpos0 = 0, kpos1 = 0;
  bool kvis0 = true, kvis1 = true;
  if (POS) {
    kpos0 = pos_of(key0, p.pos.k_off[0], p.pos.k_off[1], p.pos.seg_k);
    kpos1 = pos_of(key1, p.pos.k_off[0], p.pos.k_off[1], p.pos.seg_k);
    kvis0 = key0 < p.Lk && (!p.pos.has_valid || kpos0 < p.pos.valid_len);
    kvis1 = key1 < p.Lk && (!p.pos.has_valid || kpos1 < p.pos.valid_len);
  }
  // exp(x) = exp2(x log2 e); without a bias the scale is folded in too
  const float c = has_bias ? kLog2e : p.scale * kLog2e;
  float dk[DC / 2], dv[DC / 2];  // columns DC cw .. DC cw + DC - 1
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[kHQ / 2], dp[kHQ / 2];
  const uint32_t q_rows = kHQ * cw * C::W * 2;  // this group's query rows
  const uint32_t cols = cw * (DC / C::W) * C::kQChunk;  // its columns
  unsigned char* pt = smem + C::kPOff;  // P^T, then dS^T

  s9::mbar_wait(kv_full, 0);  // also when no tile is visited: TMA is done
  int stage = 0;
  uint32_t phase = 0, bias_phase = 0;
  for (int it = it_begin; it < it_end; ++it) {
    if (has_seg && !seg_overlap(k_bound, q_bounds + 2 * it)) continue;
    const int state = POS ? pos_state(it) : 1;
    if (state == 0) continue;
    const int q0 = it * BQ;
    const int qh0 = q0 + kHQ * cw;  // this group's first query
    // Which per-logit masks this tile needs.
    bool need_mask = state == 2;
    if (causal) need_mask = k0 + kBK - 1 > qh0;
    if (has_seg) {
      const int* qb = q_bounds + 2 * it;
      need_mask = need_mask || !(k_bound[0] == k_bound[1] &&
                                 qb[0] == qb[1] && qb[0] == k_bound[0]);
    }
    const uint32_t qs = q_s + stage * C::kQBytes;
    const uint32_t gs = g_s + stage * C::kQBytes;
    s9::mbar_wait(full0 + 8 * stage, phase);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x this group's 32 queries
    // each, over the whole head dim.
    s9::fence_regs(s);
    s9::fence_regs(dp);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off =
          (kk * 16 / C::W) * C::kKChunk + (kk * 16 % C::W) * 2;
      const uint32_t qoff = (kk * 16 / C::W) * C::kQChunk + q_rows +
                            (kk * 16 % C::W) * 2;
      s9::wgmma_ss<kHQ>(s, s9::smem_desc(k_s + off, 16, C::kAtom, C::kLayout),
                        s9::smem_desc(qs + qoff, 16, C::kAtom, C::kLayout),
                        kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off =
          (kk * 16 / C::W) * C::kKChunk + (kk * 16 % C::W) * 2;
      const uint32_t qoff = (kk * 16 / C::W) * C::kQChunk + q_rows +
                            (kk * 16 % C::W) * 2;
      s9::wgmma_ss<kHQ>(dp,
                        s9::smem_desc(v_s + off, 16, C::kAtom, C::kLayout),
                        s9::smem_desc(gs + qoff, 16, C::kAtom, C::kLayout),
                        kk > 0);
    }
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
    s9::fence_regs(s);
    s9::fence_regs(dp);
    if (HAS_BIAS && has_bias) s9::mbar_wait(bias_full, bias_phase);

    // P^T = exp(logit - lse), selected to 0 where hidden, and
    // dS^T = P^T (dP^T - delta), both packed to bf16 pairs of queries.
    const float* rs = rows_s + stage * C::kRowFloats;
    uint32_t pp[kHQ / 8][2], dd[kHQ / 8][2];  // [j][key row rl0 | rl1]
#pragma unroll
    for (int j = 0; j < kHQ / 8; ++j) {
      const int col = kHQ * cw + 8 * j + 2 * t;  // queries col, col + 1
      const float2 lse2 = *reinterpret_cast<const float2*>(rs + col);
      const float2 dl2 = *reinterpret_cast<const float2*>(rs + BQ + col);
      int2 qid2 = make_int2(-1, -1);
      if (has_seg && need_mask)
        qid2 = *reinterpret_cast<const int2*>(rs + 2 * BQ + col);
      int qpos[2] = {0, 0};  // K7: positions of the two queries
      if (POS && need_mask && p.pos.causal) {
        qpos[0] = pos_of(q0 + col, q_off0, q_off1, p.pos.seg_q);
        qpos[1] = pos_of(q0 + col + 1, q_off0, q_off1, p.pos.seg_q);
      }
      float pr[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = col + (e & 1);
        float x = s[4 * j + e];
        bool visible = true;
        if (HAS_BIAS && has_bias) {  // logit = scale * s + bias, in fp32
          x = fmaf(x, p.scale, bias_elem<kBK>(bias_s, p.m.bias_bf16, qc,
                                              e < 2 ? rl0 : rl1));
          visible = x > kNegInf;
        }
        if (CAUSAL && causal && need_mask)
          visible = visible && (e < 2 ? key0 : key1) <= q0 + qc;
        if (HAS_SEG && has_seg && need_mask)
          visible = visible && (e < 2 ? kid0 : kid1) ==
                                   ((e & 1) ? qid2.y : qid2.x);
        if (POS && need_mask) {
          visible = visible && (e < 2 ? kvis0 : kvis1);
          if (p.pos.causal)
            visible = visible && (e < 2 ? kpos0 : kpos1) <= qpos[e & 1];
        }
        float pv = s9::exp2_approx(fmaf(x, c, -((e & 1) ? lse2.y : lse2.x)));
        if (kSelect && !visible) pv = 0.f;  // selected, not multiplied
        pr[e] = pv;
        ds[e] = pv * (dp[4 * j + e] - ((e & 1) ? dl2.y : dl2.x));
      }
      pp[j][0] = s9::pack_bf16(pr[0], pr[1]);
      pp[j][1] = s9::pack_bf16(pr[2], pr[3]);
      dd[j][0] = s9::pack_bf16(ds[0], ds[1]);
      dd[j][1] = s9::pack_bf16(ds[2], ds[3]);
    }
    if (HAS_BIAS && has_bias) {
      s9::mbar_arrive(bias_empty);
      bias_phase ^= 1;
    }

    // Both groups' halves into the P^T and dS^T tiles: key row r, queries
    // 8u .. 8u + 7 (16 bytes) at unit u ^ (r % 8) of the row, once the
    // other group's dV / dK have read the last tile's (barrier 3), handed to
    // wgmma (barrier 4).
    s9::named_barrier_sync(3, kConsumers);
#pragma unroll
    for (int j = 0; j < kHQ / 8; ++j) {
      const int u = kHQ / 8 * cw + j;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? rl1 : rl0;
        const int at = r * 128 + ((u ^ (r & 7)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(pt + at) = pp[j][half];
        *reinterpret_cast<uint32_t*>(pt + C::kPBytes + at) = dd[j][half];
      }
    }
    s9::fence_proxy_async();
    s9::named_barrier_sync(4, kConsumers);

    // dV += P^T dO, dK += dS^T Q over this group's columns: P^T and dS^T
    // K-major from the tiles, dO and Q MN-major from the chunk of column
    // DC cw, the k-step kk is queries 16kk .. 16kk + 15.
    s9::fence_regs(dv);
    s9::fence_regs(dk);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      s9::wgmma_ss<DC, 1>(dv, s9::smem_desc(p_s + kk * 32, 16, 1024, 1),
                          s9::smem_desc(gs + cols + kk * 16 * C::W * 2,
                                        C::kQChunk, C::kAtom, C::kLayout),
                          1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      s9::wgmma_ss<DC, 1>(dk, s9::smem_desc(d_s + kk * 32, 16, 1024, 1),
                          s9::smem_desc(qs + cols + kk * 16 * C::W * 2,
                                        C::kQChunk, C::kAtom, C::kLayout),
                          1);
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
    s9::fence_regs(dv);
    s9::fence_regs(dk);
    s9::mbar_arrive(empty0 + 8 * stage);  // Q, dO and rows of this stage
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // Epilogue: dK * scale and dV in bf16 through their strides; key rows
  // past Lk are not written.
  __nv_bfloat16* kb = p.dk + b * p.dks[0] + h * p.dks[1];
  __nv_bfloat16* vb = p.dv + b * p.dvs[0] + h * p.dvs[1];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    const int col = DC * cw + 8 * j + 2 * t;
    if (col < p.d) {
      if (key0 < p.Lk) {
        *reinterpret_cast<__nv_bfloat162*>(kb + key0 * p.dks[2] + col) =
            __floats2bfloat162_rn(dk[4 * j] * p.scale,
                                  dk[4 * j + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(vb + key0 * p.dvs[2] + col) =
            __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
      }
      if (key1 < p.Lk) {
        *reinterpret_cast<__nv_bfloat162*>(kb + key1 * p.dks[2] + col) =
            __floats2bfloat162_rn(dk[4 * j + 2] * p.scale,
                                  dk[4 * j + 3] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(vb + key1 * p.dvs[2] + col) =
            __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// K4.
template <int DP, bool CAUSAL, bool HAS_BIAS, bool HAS_SEG, bool ANY = false>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ Params p) {
  if constexpr (Cfg<DP, HAS_BIAS>::kWide)
    flash_bwd_dkv_wide_body<DP, CAUSAL, HAS_BIAS, HAS_SEG, false, ANY>(
        tq, tk, tv, tg, p);
  else
    flash_bwd_dkv_body<DP, CAUSAL, HAS_BIAS, HAS_SEG, false, ANY>(tq, tk, tv,
                                                                  tg, p);
}

// K7: the position masks under a global lse.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_pos_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tg,
                              const __grid_constant__ Params p) {
  if constexpr (Cfg<DP, false>::kWide)
    flash_bwd_dkv_wide_body<DP, false, false, false, true, false>(tq, tk, tv,
                                                                  tg, p);
  else
    flash_bwd_dkv_body<DP, false, false, false, true>(tq, tk, tv, tg, p);
}

// The q, k, v and dO tensor maps, then `kernel` on one block per (b*h, key
// tile of Cfg's kBK keys); sets p.n_kt.
template <int DP, typename Kernel>
cudaError_t launch_on(Kernel kernel, int smem, const void* q, const void* k,
                      const void* v, const void* g, int B,
                      const long long* st, Params p, cudaStream_t stream) {
  using C = Cfg<DP, false>;
  p.n_kt = (p.Lk + C::kBK - 1) / C::kBK;
  const CUtensorMapSwizzle sw =
      C::W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err =
      s9::make_map(&tq, q, p.d, p.Lq, p.H, B, st, C::W, C::kBQ, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tk, k, p.d, p.Lk, p.H, B, st + 3, C::W, C::kBK, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tv, v, p.d, p.Lk, p.H, B, st + 6, C::W, C::kBK, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tg, g, p.d, p.Lq, p.H, B, st + 9, C::W, C::kBQ, sw);
  if (err != cudaSuccess) return err;
  return s9::launch_kernel(kernel, B * p.H * p.n_kt, kThreads, smem, stream,
                           tq, tk, tv, tg, p);
}

template <int DP, bool CAUSAL = false, bool HAS_BIAS = false,
          bool HAS_SEG = false, bool ANY = false>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, int B, const long long* st,
                   const Params& p, cudaStream_t stream) {
  return launch_on<DP>(
      flash_bwd_dkv_sm90_kernel<DP, CAUSAL, HAS_BIAS, HAS_SEG, ANY>,
      Cfg<DP, HAS_BIAS>::kSmemBytes, q, k, v, g, B, st, p, stream);
}

// K7 at padded head dim DP.
template <int DP>
cudaError_t launch_pos(const void* q, const void* k, const void* v,
                       const void* g, int B, const long long* st,
                       const Params& p, cudaStream_t stream) {
  return launch_on<DP>(flash_bwd_pos_dkv_sm90_kernel<DP>,
                       Cfg<DP, false>::kSmemBytes, q, k, v, g, B, st, p,
                       stream);
}

// K4 at padded head dim DP in the form code = 4*causal + 2*has_bias +
// has_seg: no mask (code 0) on its own instantiation; at DP = 64 and 128
// each mask form on its own, at other widths the ANY instantiation.
template <int DP>
cudaError_t launch_width(int code, const void* q, const void* k,
                         const void* v, const void* g, int B,
                         const long long* st, const Params& p,
                         cudaStream_t s) {
  if (code == 0) return launch<DP>(q, k, v, g, B, st, p, s);
  if constexpr (DP == 64 || DP == 128) {
    switch (code) {
#define FDSD_FORM(CODE, CA, BI, SE) \
  case CODE:                        \
    return launch<DP, CA, BI, SE>(q, k, v, g, B, st, p, s);
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
  } else {
    return launch<DP, true, true, true, true>(q, k, v, g, B, st, p, s);
  }
}

// The padded width of head dim d (1 to 256): d rounded up to 16, and above
// 128 to 32, so that each consumer's half of the columns is whole 16-column
// chunks.
inline int padded_width(int d) {
  return d <= 128 ? (d + 15) / 16 * 16 : (d + 31) / 32 * 32;
}

// The explicit instantiations of one width DP, K4's launch_width<DP> and
// K7's launch_pos<DP> (P: empty, or `extern` for their declarations); each
// width is instantiated in one of the flash_attention_bwd_sm90_w*.cu files.
#define FDSD_K4_WIDTH_(P, DP)                                              \
  P template cudaError_t launch_width<DP>(                                 \
      int, const void*, const void*, const void*, const void*, int,        \
      const long long*, const Params&, cudaStream_t);                      \
  P template cudaError_t launch_pos<DP>(const void*, const void*,          \
                                        const void*, const void*, int,     \
                                        const long long*, const Params&,   \
                                        cudaStream_t);
#define FDSD_K4_WIDTH(DP) FDSD_K4_WIDTH_(, DP)
#define FDSD_K4_WIDTHS(X)                                                  \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(160) X(192) X(224) \
  X(256)
#define FDSD_K4_EXTERN(DP) FDSD_K4_WIDTH_(extern, DP)
FDSD_K4_WIDTHS(FDSD_K4_EXTERN)
#undef FDSD_K4_EXTERN

}  // namespace fdsd::k4
