// Flash-attention backward above head dim 256 for Hopper (sm_90a) on TMA and
// wgmma: bf16 in and out, fp32 softmax reconstruction and accumulators. K3
// (dq, and dbias) and K4 (dk, dv) at the padded widths DP = 384 (head dims
// 257 to 384) and 512 (385 to 512), without a mask and in every mask form
// (causal, an additive bias, segment ids and their combinations), and K6
// (dq) and K7 (dk, dv) under the position masks at the same widths. The
// kernel and its launch templates live here; the C entries of K3 / K6 and
// K4 / K7 (flash_attention_dq_sm90.cu, flash_attention_bwd_sm90.cu) send
// head dims above 256 here, and flash_attention_wide_bwd_sm90_w*.cu
// instantiate the two widths apart, so that the build compiles them in
// parallel.
//
// Replaces, above head dim 256 (the VAEs' one-head mid attention at 512:
// SD1's decoder and encoder at (B, 1, 4096, 4096, 512), SD3's; the joint
// attention and the ring hop at heads above 256), the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel_pos
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel_pos
// in every form of theirs. It recomputes the probabilities under the
// forward's lse (K6 / K7: the caller's global one, merged over every key
// block), P = exp(scale Q K^T + bias - lse), selected to 0 where a mask
// hides the key (never multiplied: a row that saw no key has lse = -1e30),
// with delta = rowsum(dO * out) computed by the caller:
//   dS = P * (dO V^T - delta),  dQ = scale dS K,
//   dV = P^T dO,  dK = scale dS^T Q;
// with a bias that needs a gradient, K3 also writes dbias = dS, fp32 (B, H,
// Lq, Lk): every tile exactly once, zeros where a tile is skipped. The TPU's
// sequential grid axis is a loop inside the block.
//
// What bounds it on the H100: operations (three L^2 d products for dq, four
// for dk / dv), thousands of flop per byte at the VAEs' shapes.
//
// Design. The gradients are one computation with the roles of the axes
// swapped: a cluster pair owns 64 "rows" and walks tiles of 32 "columns" of
// the other axis, computes X = A1 B1^T and Y = A2 B2^T (64 x 32 each), forms
// P and dS from them and accumulates over the columns:
//   dq    (K3 / K6): rows queries, A1 Q, A2 dO, B1 K, B2 V;
//                    X = S, Y = dP, dQ += dS K;
//   dk dv (K4 / K7): rows keys, A1 K, A2 V, B1 Q, B2 dO;
//                    X = S^T, Y = dP^T, dK += dS^T Q, dV += P^T dO.
// A row tile's accumulators of 64 x DP fp32 take DP / 2 registers a thread
// over two warpgroups, dK and dV together DP, more than a thread may hold;
// so the head dim is split across a cluster of two blocks on two SMs
// (__cluster_dims__(2, 1, 1)): block r owns columns [r DH, (r + 1) DH), DH =
// DP / 2, of every operand and output. X and Y reduce over all of d: each
// block computes its partial over its DH columns, the pair swaps the
// partials (pair_swap.cuh: each consumer thread stores its own from its
// registers into the other block's shared memory with st.async, counted on
// that block's barrier, so no consumer waits on the other SM) and each
// block adds the other's to its own, so both hold the same X and Y, and the
// same P and dS; every other product is one block's own. dk and dv are one
// launch, one pair a 64-key tile holding both accumulators, S^T computed
// once a tile: four L^2 d products, not five.
// One block of three warpgroups:
//  - a producer warpgroup gives up its registers (setmaxnreg 40). Thread 0
//    issues TMA: A1 and A2 once (DH columns, 32 KB each at DH 256), then B1
//    and B2 tiles of 32 rows (16 KB each at DH 256) through a ring of
//    kStages stages (3 at DP 512, 4 at 384) of full / empty mbarriers.
//    Boxes are 64 columns with 128-byte swizzle; the columns past the head
//    dim read as TMA's zeros, rows past L as zeros. Thread 32 is the swap's
//    helper (it arms the barrier of each tile's incoming partials and frees
//    `in` for the other block once read); dq has a second channel, thread
//    96's.
//    Warp 2 (dk / dv) writes the column tile's lse (times log2 e; past Lq
//    +1e30) and delta into the stage beside B1 / B2 and arrives on its full
//    barrier: 64 floats a tile, not a global read per logit.
//  - two consumer warpgroups (setmaxnreg 232), in one of two ways:
//    dq: ping-pong. Consumer w takes the pair's visible tiles j with j % 2
//    == w, all 32 columns of each: X, then Y over the block's DH columns
//    (wgmma chains of DH / 16 m64n32k16 SS), the swap on its own channel in
//    two halves (X's partial travels while Y runs, and P is formed from X
//    while Y's travels: the swap is bound by the bytes it moves), P and dS
//    in registers, and dQ += dS K as two m64nDHk16 RS wgmmas (dS the
//    A fragment, K MN-major as it lies) into a dQ of its own (DH / 2
//    registers); the two dQ are added through shared memory at the end.
//    The consumers share no tile, so one's tensor-core work runs while the
//    other forms its P and dS: a warpgroup that issues a chain of wgmmas
//    waits in the issue for most of their run (clock64 stamps: ~1,550 of
//    ~3,000 cycles a tile with both consumers on one tile), so consumers
//    in lockstep leave the tensor cores idle while both form P and dS.
//    dk dv: lockstep. Consumer 0 computes X, consumer 1 Y, each over the
//    block's DH columns (m64n32k16 SS), and pushes it (into `out` for the
//    other consumer, into the other block's `in`); after the pull each
//    forms P and dS of its 16 of the tile's 32 columns from the two sums
//    and writes dS^T and P^T in bf16 into a shared 64 x 64 T tile (the
//    128-byte swizzled K-major layout wgmma reads: dS^T in columns 0 - 31,
//    P^T in 32 - 63); after a named barrier consumer 0 runs dK += dS^T Q,
//    consumer 1 dV += P^T dO (m64nDHk16 SS over both k-steps, Q and dO
//    MN-major; DH / 2 accumulator registers each, which is why dk / dv
//    cannot give each consumer whole tiles). T is double-buffered, so one
//    barrier a tile keeps a consumer from writing a tile the other may
//    still read. The tiles are software-pipelined around the swap: tile
//    j's partial is pushed, tile j - 1's accumulation and tile j + 1's
//    partial are issued, and only then is tile j's swap waited for; no
//    accumulator is read while a wgmma is in flight (ptxas would serialize
//    them). Three stages hold tiles j - 1, j and j + 1.
//  - lse and delta: of the rows, in registers (dq); of the columns, from the
//    stage (dk / dv). Query rows past Lq get lse = +1e30 (P = 0) and are not
//    written; a query column past Lq and a key past Lk are selected to P = 0.
//  - masks (the ANY instantiation, every path chosen per launch): the
//    position masks of pos_tile.cuh (two offset segments a side, valid_len,
//    causal by position; K3 / K4's causal is the same predicate with
//    offsets 0, key <= query from index 0) judge each (row tile, column
//    tile) pair by pos_pair, called with the query tile's and the key
//    tile's ranges whichever axis the rows are: a pair that shows nothing is
//    skipped by both blocks of the pair alike, a partly visible one masked
//    per logit; the bias is read from global memory into each logit (scale
//    s + bias in fp32; a bias of -1e30 or -inf hides the key); segment ids
//    walk the tile range [lo, hi] of mask.cuh at (64 rows, 32 columns), skip
//    a tile whose id range is disjoint and compare ids per logit.
// dq and dk (times scale) and dv are written in bf16 through their strides,
// each block its DH columns; rows whose tiles were all skipped as 0 (dk / dv
// of keys no query sees too); columns past d are not written. dbias is
// written by block 0 of the pair alone. Both blocks meet at a cluster
// barrier before they exit, so that neither leaves while the other's copy
// into it is in flight.
//
// Shared memory a block (A1, A2, two T tiles, the swap's `in` and `out` (dq:
// one `in` a channel), the stages with their statistics, the barriers, the
// alignment): 214,920 B at DP 512, 198,808 B at 384.

#pragma once

#include "mask.cuh"
#include "pair_swap.cuh"
#include "pos_tile.cuh"
#include "sm90.cuh"

namespace fdsd::kw {

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
constexpr int W = 64;             // columns per swizzle row
constexpr int kBR = 64, kBC = 32;  // rows a block pair, columns a tile
constexpr int kThreads = 384;     // producer warpgroup + two consumers
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr uint32_t kAtom = 8 * W * 2;  // 8 rows of a chunk
constexpr int kAChunk = kBR * W * 2, kBChunk = kBC * W * 2;
constexpr int kTBytes = kBR * W * 2;      // one T buffer: 64 x 64 bf16
constexpr int kXBytes = 2 * kBR * kBC * 4;  // the partials X, Y of a tile
constexpr int kStatBytes = 2 * kBC * 4;   // a column tile's lse, delta
constexpr int kSmemLimit = 232448;

template <int DP>
struct Cfg {
  static constexpr int kDH = DP / 2;  // this block's columns
  static constexpr int kChunks = kDH / W;
  static constexpr int kABytes = kBR * kDH * 2, kBBytes = kBC * kDH * 2;
  static constexpr int kStageBytes = 2 * kBBytes;  // B1, B2
  static constexpr int kA2Off = kABytes, kTOff = 2 * kABytes;
  static constexpr int kInOff = kTOff + 2 * kTBytes;
  static constexpr int kOutOff = kInOff + kXBytes;
  static constexpr int kStageOff = kOutOff + kXBytes;
  // as many stages as fit beside the rest, at most 4 (each with its
  // statistics and its full / empty barriers); A full and the swap's
  // barriers; the alignment
  static constexpr int kRoom =
      kSmemLimit - kStageOff - 8 * (1 + 2 * kSwapBars) - 1024;
  static constexpr int kFit = kRoom / (kStageBytes + kStatBytes + 16);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kStatOff = kStageOff + kStages * kStageBytes;
  static constexpr int kBarOff = kStatOff + kStages * kStatBytes;
  static constexpr int kBars = 1 + 2 * kStages + 2 * kSwapBars;
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(kStages >= 3, "a pipelined ring");
  static_assert(DP % 128 == 0 && DP <= 512, "width");
  // dq's epilogue adds the two consumers' dQ through the stages: half of
  // the columns of each, 64 rows
  static_assert(2 * kBR * (kDH / 2) * 4 <= kStages * kStageBytes, "dq sum");
};

struct Params {
  __nv_bfloat16* o0;  // dq, or dk
  __nv_bfloat16* o1;  // dv
  float* dbias;       // dq with a bias that needs a gradient, or null
  const float* lse;   // (B, H, Lq)
  const float* delta;  // (B, H, Lq)
  int B, H, Lq, Lk, d;
  int n_rt;    // row tiles of 64 per (b, h)
  int k4;      // 1: dk and dv (rows keys; the DKV kernel), 0: dq
  long long o0s[3], o1s[3];  // outputs' (batch, head, seq) element strides
  float scale;
  PosArgs pos;  // ANY: the position masks (K3 / K4: null offsets, read as 0)
  MaskArgs m;  // ANY: the bias and the segment arrays at (64, 32) tiles
};

template <int DP, bool ANY, bool DKV>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    flash_bwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap ta1,
                               const __grid_constant__ CUtensorMap ta2,
                               const __grid_constant__ CUtensorMap tb1,
                               const __grid_constant__ CUtensorMap tb2,
                               const __grid_constant__ Params p) {
  using C = Cfg<DP>;
  constexpr int DH = C::kDH, S = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t a1_s = base, a2_s = base + C::kA2Off;
  const uint32_t t_s = base + C::kTOff;
  const uint32_t in_s = base + C::kInOff, out_s = base + C::kOutOff;
  const uint32_t stage_s = base + C::kStageOff;
  float* stats = reinterpret_cast<float*>(smem + C::kStatOff);
  const uint32_t a_full = base + C::kBarOff;
  const uint32_t full0 = a_full + 8, empty0 = full0 + 8 * S;
  const uint32_t xbars = empty0 + 8 * S;  // the swap's

  const int tid = threadIdx.x;
  const int c0 = static_cast<int>(s9::cluster_rank()) * DH;  // first column
  const int tile = static_cast<int>(blockIdx.x) / 2;
  constexpr bool rows_q = !DKV;  // rows are queries (dq) or keys
  const int bh = tile / p.n_rt;
  int rt = tile % p.n_rt;
  const bool causal = ANY && p.pos.causal != 0;
  const bool has_valid = ANY && p.pos.has_valid != 0;
  const bool masked = causal || has_valid;  // positions matter
  const bool has_bias = ANY && p.m.bias != nullptr;
  const bool has_seg = ANY && p.m.q_ids != nullptr;
  if (causal && rows_q) rt = p.n_rt - 1 - rt;  // the longest rows first
  const int b = bh / p.H, h = bh % p.H;
  const int r0_tile = rt * kBR;
  const int n_rows = rows_q ? p.Lq : p.Lk, n_cols = rows_q ? p.Lk : p.Lq;
  const int n_ct = (n_cols + kBC - 1) / kBC;
  // The offsets, read where a mask needs positions (null reads as 0).
  int q_off0 = 0, q_off1 = 0, k_off0 = 0, k_off1 = 0;
  if (masked && p.pos.q_off != nullptr) {
    q_off0 = p.pos.q_off[0];
    q_off1 = p.pos.q_off[1];
  }
  if (masked && p.pos.k_off != nullptr) {
    k_off0 = p.pos.k_off[0];
    k_off1 = p.pos.k_off[1];
  }

  // The column tiles the pair visits, the same walk in both blocks and
  // every role: those pos_pair does not skip (the query tile and the key
  // tile passed as such whichever axis the rows are); the range whose
  // segment ids overlap this row tile's, less the disjoint tiles inside it.
  int ct_begin = 0, ct_end = n_ct;
  const int* row_bound = nullptr;
  const int* col_bounds = nullptr;
  if (has_seg) {
    const int seg_tile = b * p.n_rt + rt;
    ct_begin = max(ct_begin, p.m.lo[seg_tile]);
    ct_end = min(ct_end, p.m.hi[seg_tile] + 1);
    row_bound = (rows_q ? p.m.q_bounds : p.m.kv_bounds) + 2 * seg_tile;
    col_bounds = (rows_q ? p.m.kv_bounds : p.m.q_bounds) + 2 * b * n_ct;
  }
  // what the (row tile, column tile ct) pair needs: 0 skip, 1 visible, 2
  // masked per logit by position
  auto pair = [&](int ct) {
    if (ct < ct_begin || ct >= ct_end ||
        (has_seg && !seg_overlap(row_bound, col_bounds + 2 * ct)))
      return 0;
    if (!masked) return 1;
    const int q0 = rows_q ? r0_tile : ct * kBC, nq = rows_q ? kBR : kBC;
    const int k0 = rows_q ? ct * kBC : r0_tile, nk = rows_q ? kBC : kBR;
    int q_lo, q_hi, k_lo, k_hi;
    pos_bounds(q0, nq, q_off0, q_off1, p.pos.seg_q, p.Lq, q_lo, q_hi);
    pos_bounds(k0, nk, k_off0, k_off1, p.pos.seg_k, p.Lk, k_lo, k_hi);
    return pos_pair(p.pos, q_lo, q_hi, k_lo, k_hi);
  };
  // the first column tile from ct on that the pair visits; ct_end if none
  auto visible = [&](int ct) {
    while (ct < ct_end && pair(ct) == 0) ++ct;
    return ct;
  };

  if (tid == 0) {
    s9::mbar_init(a_full, 1);
    for (int s = 0; s < S; ++s) {
      s9::mbar_init(full0 + 8 * s, rows_q ? 1 : 1 + 32);  // + warp 2 (dk dv)
      // dq: the one consumer of the tile; dk / dv: both
      s9::mbar_init(empty0 + 8 * s, rows_q ? 128 : kConsumers);
    }
    // dq: one swap channel a consumer; dk / dv: one for both
    fdsd::swap_init(xbars, rows_q ? 128 : kConsumers);
    fdsd::swap_init(xbars + 8 * kSwapBars, 128);
    s9::mbar_init_fence();
  } else if (tid == 32) {  // fetch the descriptors while barriers are set up
    s9::prefetch_tensormap(&ta1);
    s9::prefetch_tensormap(&ta2);
    s9::prefetch_tensormap(&tb1);
    s9::prefetch_tensormap(&tb2);
  }
  // both blocks' barriers are set up before either arrives on the other's
  s9::cluster_sync();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      s9::mbar_expect_tx(a_full, 2 * C::kABytes);
      for (int c = 0; c < C::kChunks; ++c) {
        s9::tma_load_4d(a1_s + c * kAChunk, &ta1, a_full, c0 + c * W,
                        r0_tile, h, b);
        s9::tma_load_4d(a2_s + c * kAChunk, &ta2, a_full, c0 + c * W,
                        r0_tile, h, b);
      }
      int st = 0;
      uint32_t ph = 0;
      for (int ct = visible(ct_begin); ct < ct_end; ct = visible(ct + 1)) {
        const uint32_t full = full0 + 8 * st;
        const uint32_t sb = stage_s + st * C::kStageBytes;
        s9::mbar_wait(empty0 + 8 * st, ph ^ 1);
        s9::mbar_expect_tx(full, C::kStageBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          s9::tma_load_4d(sb + c * kBChunk, &tb1, full, c0 + c * W, ct * kBC,
                          h, b);
          s9::tma_load_4d(sb + C::kBBytes + c * kBChunk, &tb2, full,
                          c0 + c * W, ct * kBC, h, b);
        }
        if (++st == S) {
          st = 0;
          ph ^= 1;
        }
      }
    } else if (tid == 32 || (rows_q && tid == 96)) {
      // the swap's helper of channel 0 (dq: the even tiles; dk / dv: every
      // tile) or 1 (dq: the odd tiles)
      const int ch = tid == 96;
      int tiles = 0;
      for (int ct = visible(ct_begin); ct < ct_end; ct = visible(ct + 1))
        ++tiles;
      if (rows_q) tiles = (tiles + 1 - ch) / 2;
      fdsd::swap_helper(xbars + ch * 8 * kSwapBars, tiles, kXBytes,
                        rows_q ? 2 : 1);
    } else if (!rows_q && tid >= 64 && tid < 96) {
      // dk / dv: the column tile's lse (times log2 e) and delta, one query
      // a lane, into the stage's statistics
      const int lane = tid - 64;
      const long long bq = static_cast<long long>(bh) * p.Lq;
      int st = 0;
      uint32_t ph = 0;
      for (int ct = visible(ct_begin); ct < ct_end; ct = visible(ct + 1)) {
        const int q = ct * kBC + lane;
        s9::mbar_wait(empty0 + 8 * st, ph ^ 1);
        stats[st * 2 * kBC + lane] =
            (q < p.Lq ? p.lse[bq + q] : kPadLse) * kLog2e;
        stats[st * 2 * kBC + kBC + lane] = q < p.Lq ? p.delta[bq + q] : 0.f;
        s9::mbar_arrive(full0 + 8 * st);
        if (++st == S) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    // ----------------------------------------------------------- consumers
    s9::reg_alloc<kConsumerRegs>();
    const int cw = (tid - 128) / 128;
    const int i = (tid - 128) % 128;
    const int warp = i / 32, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl0 = 16 * warp + g, rl1 = rl0 + 8;  // tile rows
    const int r0 = r0_tile + rl0, r1 = r0_tile + rl1;
    const long long bq = static_cast<long long>(bh) * p.Lq;  // lse, delta
    // dq: the lse (times log2 e) and delta of this thread's two query rows
    float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;
    if (rows_q) {
      lse0 = (r0 < p.Lq ? p.lse[bq + r0] : kPadLse) * kLog2e;
      lse1 = (r1 < p.Lq ? p.lse[bq + r1] : kPadLse) * kLog2e;
      dl0 = r0 < p.Lq ? p.delta[bq + r0] : 0.f;
      dl1 = r1 < p.Lq ? p.delta[bq + r1] : 0.f;
    }
    // ANY: the segment ids of this thread's two rows and of the other axis
    const int* col_ids = nullptr;
    int rid0 = -1, rid1 = -1;
    if (has_seg) {
      const int* q_ids = p.m.q_ids + static_cast<long long>(b) * p.Lq;
      const int* kv_ids = p.m.kv_ids + static_cast<long long>(b) * p.Lk;
      const int* row_ids = rows_q ? q_ids : kv_ids;
      col_ids = rows_q ? kv_ids : q_ids;
      if (r0 < n_rows) rid0 = row_ids[r0];
      if (r1 < n_rows) rid1 = row_ids[r1];
    }
    const long long bias_base = has_bias ? b * p.m.bs[0] + h * p.m.bs[1] : 0;
    // ANY: the positions of this thread's two rows (queries for dq, keys
    // for dk / dv; rows past L are not written, whatever they see)
    int rpos0 = 0, rpos1 = 0;
    if (masked) {
      const int off0 = rows_q ? q_off0 : k_off0;
      const int off1 = rows_q ? q_off1 : k_off1;
      const int seg = rows_q ? p.pos.seg_q : p.pos.seg_k;
      rpos0 = pos_of(r0, off0, off1, seg);
      rpos1 = pos_of(r1, off0, off1, seg);
    }
    // exp(x) = exp2(x log2 e); without a bias the scale is folded in too
    const float c = has_bias ? kLog2e : p.scale * kLog2e;
    // P = exp(logit - lse) at this thread's row e < 2 ? r0 : r1 and column
    // col of a tile in pair state `state`, from the logit sum s over all of
    // d; selected to 0 where hidden (lq: the query's lse times log2 e).
    auto prob = [&](float s, int e, int col, int state, float lq) {
      const int row = e < 2 ? r0 : r1;
      const int qi = rows_q ? row : col, ki = rows_q ? col : row;
      bool vis = qi < p.Lq && ki < p.Lk;
      if (has_bias) {  // logit = scale * s + bias, in fp32
        s = fmaf(s, p.scale,
                 vis ? fdsd::load_bias(p.m, bias_base, qi, ki) : 0.f);
        vis = vis && s > kNegInf;
      }
      if (state == 2) {  // a partly visible pair: by position
        const int cpos = pos_of(col, rows_q ? k_off0 : q_off0,
                                rows_q ? k_off1 : q_off1,
                                rows_q ? p.pos.seg_k : p.pos.seg_q);
        const int rpos = e < 2 ? rpos0 : rpos1;
        const int qpos = rows_q ? rpos : cpos, kpos = rows_q ? cpos : rpos;
        if (has_valid) vis = vis && kpos < p.pos.valid_len;
        if (causal) vis = vis && kpos <= qpos;
      }
      if (has_seg)
        vis = vis && col < n_cols && col_ids[col] == (e < 2 ? rid0 : rid1);
      const float pv = s9::exp2_approx(fmaf(s, c, -lq));
      return vis ? pv : 0.f;  // selected
    };
    // prob on a tile without a bias, segment ids or a partly visible
    // position pair, where only the ends of the axes hide a logit; the
    // test is warp-uniform and taken outside the loops over a thread's
    // logits, so that those loops do not carry the masks' code
    auto plain_tile = [&](int state) {
      return !has_bias && !has_seg && state == 1;
    };
    auto prob_plain = [&](float s, int e, int col, float lq) {
      const int row = e < 2 ? r0 : r1;
      const int qi = rows_q ? row : col, ki = rows_q ? col : row;
      const float pv = s9::exp2_approx(fmaf(s, c, -lq));
      return qi < p.Lq && ki < p.Lk ? pv : 0.f;  // selected
    };
    float acc[DH / 2];  // dq, or dk (consumer 0) / dv (consumer 1)
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) acc[j] = 0.f;

    if constexpr (rows_q) {
      // --------------------------------------------------- dq: ping-pong
      // Consumer cw takes the pair's visible tiles j with j % 2 == cw, all
      // 32 columns of each: X and Y (two wgmma chains over the block's DH
      // columns), the swap on its own channel, P and dS in registers, dQ +=
      // dS K as two m64nDHk16 RS wgmmas into its own dQ. The two consumers
      // share no tile, so one's tensor-core work runs while the other forms
      // its P and dS; their dQ are added at the end.
      const uint32_t my_in = in_s + cw * kXBytes;
      const uint32_t my_bars = xbars + cw * 8 * kSwapBars;
      fdsd::SwapPeer peer(my_in, my_bars);
      // dbias: block 0 of the pair writes every tile of its rows once, the
      // skipped ones as 0: the consumer of each visible tile the skipped
      // ones before it, consumer 0 those after the last
      float* db = ANY && has_bias && p.dbias != nullptr && c0 == 0
                      ? p.dbias + bq * p.Lk
                      : nullptr;
      auto write_db = [&](const float (&x)[kBC / 2], int col0) {
#pragma unroll
        for (int j = 0; j < kBC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r0 : r1;
            const int col = col0 + 8 * j + 2 * t + (e & 1);
            if (row < p.Lq && col < p.Lk)
              db[static_cast<long long>(row) * p.Lk + col] = x[4 * j + e];
          }
      };
      auto zeros = [&](int from, int to) {
        if (db == nullptr) return;
        float z[kBC / 2];
#pragma unroll
        for (int e = 0; e < kBC / 2; ++e) z[e] = 0.f;
        for (int ct = from; ct < to; ++ct) write_db(z, ct * kBC);
      };
      float x[kBC / 2], y[kBC / 2];  // X (then dS) and Y of a tile
      s9::mbar_wait(a_full, 0);  // also when no tile is visited: TMA is done
      int last = -1, j = 0;
      for (int ct = visible(ct_begin); ct < ct_end;
           ct = visible(ct + 1), ++j) {
        const bool mine = j % 2 == cw;
        if (mine) zeros(last + 1, ct);
        last = ct;
        if (!mine) continue;
        const int st = j % S;
        s9::mbar_wait(full0 + 8 * st, (j / S) & 1);
        const uint32_t sb = stage_s + st * C::kStageBytes;
        // X = Q K^T over the block's columns; its partial goes to the other
        // block while Y = dO V^T runs (float4 f of thread i at (f 128 + i)
        // 16 of the channel's `in`, Y after X, each half on its barrier)
        s9::fence_regs(x);
        s9::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t chunk = kk * 16 / W, off = (kk * 16 % W) * 2;
          s9::wgmma_ss<kBC>(
              x, s9::smem_desc(a1_s + chunk * kAChunk + off, 16, kAtom, 1),
              s9::smem_desc(sb + chunk * kBChunk + off, 16, kAtom, 1),
              kk > 0);
        }
        s9::wgmma_commit();
        s9::wgmma_wait<0>();
        s9::fence_regs(x);
        peer.wait_free(my_bars);
#pragma unroll
        for (int f = 0; f < kBC / 8; ++f)
          s9::st_async_v4(peer.in + (f * 128 + i) * 16, x[4 * f],
                          x[4 * f + 1], x[4 * f + 2], x[4 * f + 3],
                          peer.full);
        s9::fence_regs(y);
        s9::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t chunk = kk * 16 / W, off = (kk * 16 % W) * 2;
          s9::wgmma_ss<kBC>(
              y, s9::smem_desc(a2_s + chunk * kAChunk + off, 16, kAtom, 1),
              s9::smem_desc(sb + C::kBBytes + chunk * kBChunk + off, 16,
                            kAtom, 1),
              kk > 0);
        }
        s9::wgmma_commit();
        s9::wgmma_wait<0>();
        s9::fence_regs(y);
#pragma unroll
        for (int f = 0; f < kBC / 8; ++f)
          s9::st_async_v4(peer.in + kXBytes / 2 + (f * 128 + i) * 16,
                          y[4 * f], y[4 * f + 1], y[4 * f + 2], y[4 * f + 3],
                          peer.full_y);
        // P from X over all of d (own + other in block 0, other + own in
        // block 1: the same two values, the same sum) while the other's Y
        // may still be on its way; then dS = P (dP - delta) in place of X,
        // its bf16 pairs the A fragments of the two k-steps of dS K
        const int state = pair(ct);
        peer.wait_first(my_bars);
#pragma unroll
        for (int f = 0; f < kBC / 8; ++f) {
          const float4 u = s9::ld_shared_v4(my_in + (f * 128 + i) * 16);
          x[4 * f] += u.x;
          x[4 * f + 1] += u.y;
          x[4 * f + 2] += u.z;
          x[4 * f + 3] += u.w;
        }
        if (plain_tile(state)) {
#pragma unroll
          for (int jj = 0; jj < kBC / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[4 * jj + e] = prob_plain(x[4 * jj + e], e,
                                         ct * kBC + 8 * jj + 2 * t + (e & 1),
                                         e < 2 ? lse0 : lse1);
        } else {
#pragma unroll
          for (int jj = 0; jj < kBC / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[4 * jj + e] = prob(x[4 * jj + e], e,
                                   ct * kBC + 8 * jj + 2 * t + (e & 1),
                                   state, e < 2 ? lse0 : lse1);
        }
        peer.wait_second(my_bars);
#pragma unroll
        for (int f = 0; f < kBC / 8; ++f) {
          const float4 w =
              s9::ld_shared_v4(my_in + kXBytes / 2 + (f * 128 + i) * 16);
          y[4 * f] += w.x;
          y[4 * f + 1] += w.y;
          y[4 * f + 2] += w.z;
          y[4 * f + 3] += w.w;
        }
        s9::mbar_arrive(my_bars + 24);  // in_read
        uint32_t frag[kBC / 16][4];
#pragma unroll
        for (int jj = 0; jj < kBC / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[4 * jj + e] *= y[4 * jj + e] - (e < 2 ? dl0 : dl1);
          frag[jj / 2][(jj & 1) * 2] = s9::pack_bf16(x[4 * jj], x[4 * jj + 1]);
          frag[jj / 2][(jj & 1) * 2 + 1] =
              s9::pack_bf16(x[4 * jj + 2], x[4 * jj + 3]);
        }
        if (db != nullptr) write_db(x, ct * kBC);
        // dQ += dS K: K MN-major, the k-step kk is keys 16kk .. 16kk + 15
        s9::fence_regs(acc);
        s9::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBC / 16; ++kk)
          s9::wgmma_rs<DH>(acc, frag[kk],
                           s9::smem_desc(sb + kk * 16 * W * 2, kBChunk, kAtom,
                                         1),
                           1);
        s9::wgmma_commit();
        s9::wgmma_wait<0>();
        s9::fence_regs(acc);
        s9::mbar_arrive(empty0 + 8 * st);  // K and V of this stage are read
      }
      if (cw == 0) zeros(last + 1, n_ct);
      // dQ = the two consumers' sums: each hands the other the half of the
      // columns it does not write, through the stages (all read by now)
      const uint32_t red = stage_s;
      s9::named_barrier_sync(1, kConsumers);
#pragma unroll
      for (int jq = 0; jq < DH / 8; ++jq) {
        const int jj = jq % (DH / 16);
        if ((jq < DH / 16) != (cw == 0))
          s9::st_shared_v4(red + (cw * (DH / 16) + jj) * 2048 + i * 16,
                           acc[4 * jq], acc[4 * jq + 1], acc[4 * jq + 2],
                           acc[4 * jq + 3]);
      }
      s9::named_barrier_sync(1, kConsumers);
#pragma unroll
      for (int jq = 0; jq < DH / 8; ++jq) {
        const int jj = jq % (DH / 16);
        if ((jq < DH / 16) == (cw == 0)) {
          const float4 o =
              s9::ld_shared_v4(red + ((1 - cw) * (DH / 16) + jj) * 2048 +
                               i * 16);
          acc[4 * jq] += o.x;
          acc[4 * jq + 1] += o.y;
          acc[4 * jq + 2] += o.z;
          acc[4 * jq + 3] += o.w;
        }
      }
    } else {
      // ------------------------------------------- dk / dv: lockstep pair
      const uint32_t out_ready = xbars + 16, in_read = xbars + 24;
      fdsd::SwapPeer peer(in_s, xbars);
      // X (consumer 0) or Y (consumer 1), this block's part
      float xy[kBC / 2];
      const uint32_t xa_s = cw == 0 ? a1_s : a2_s;
      const uint32_t xb_off = cw == 0 ? 0 : C::kBBytes;

      // This consumer's partial X or Y of the tile on stage st, over the
      // block's columns, issued and committed, not waited for.
      auto issue_xy = [&](int st) {
        const uint32_t sb = stage_s + st * C::kStageBytes + xb_off;
        s9::fence_regs(xy);
        s9::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t chunk = kk * 16 / W, off = (kk * 16 % W) * 2;
          s9::wgmma_ss<kBC>(
              xy, s9::smem_desc(xa_s + chunk * kAChunk + off, 16, kAtom, 1),
              s9::smem_desc(sb + chunk * kBChunk + off, 16, kAtom, 1),
              kk > 0);
        }
        s9::wgmma_commit();
      };
      // xy into this consumer's half of this block's `out` (for the other
      // consumer) and of the other block's `in`: float4 f of thread i at
      // (f 128 + i) 16
      auto push = [&]() {
#pragma unroll
        for (int f = 0; f < kBC / 8; ++f)
          s9::st_shared_v4(out_s + cw * (kXBytes / 2) + (f * 128 + i) * 16,
                           xy[4 * f], xy[4 * f + 1], xy[4 * f + 2],
                           xy[4 * f + 3]);
        s9::mbar_arrive(out_ready);
        peer.wait_free(xbars);
#pragma unroll
        for (int f = 0; f < kBC / 8; ++f)
          s9::st_async_v4(peer.in + cw * (kXBytes / 2) + (f * 128 + i) * 16,
                          xy[4 * f], xy[4 * f + 1], xy[4 * f + 2],
                          xy[4 * f + 3], peer.full);
      };
      // X and Y over all of d at this consumer's 16 columns (fragment
      // groups 2cw, 2cw + 1): this block's from `out` once both consumers
      // pushed, the other's from `in` once its stores landed; own + other
      // in block 0, other + own in block 1: the same two values, the same
      // sum.
      float sx[8], sy[8];
      auto pull = [&]() {
        s9::mbar_wait(out_ready, peer.pulls);
        peer.wait_full(xbars);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint32_t at = ((2 * cw + u) * 128 + i) * 16;
          const float4 xo = s9::ld_shared_v4(out_s + at);
          const float4 xi = s9::ld_shared_v4(in_s + at);
          const float4 yo = s9::ld_shared_v4(out_s + kXBytes / 2 + at);
          const float4 yi = s9::ld_shared_v4(in_s + kXBytes / 2 + at);
          sx[4 * u] = xo.x + xi.x;
          sx[4 * u + 1] = xo.y + xi.y;
          sx[4 * u + 2] = xo.z + xi.z;
          sx[4 * u + 3] = xo.w + xi.w;
          sy[4 * u] = yo.x + yi.x;
          sy[4 * u + 1] = yo.y + yi.y;
          sy[4 * u + 2] = yo.z + yi.z;
          sy[4 * u + 3] = yo.w + yi.w;
        }
        s9::mbar_arrive(in_read);
      };
      // dK += dS^T Q (consumer 0) or dV += P^T dO (consumer 1) of the tile
      // on stage st (T buffer tb) over both k-steps, issued and committed.
      auto issue_acc = [&](int st, uint32_t tb) {
        const uint32_t sb = stage_s + st * C::kStageBytes;
        s9::fence_regs(acc);
        s9::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBC / 16; ++kk)
          s9::wgmma_ss<DH, 1>(
              acc, s9::smem_desc(tb + cw * 64 + kk * 32, 16, kAtom, 1),
              s9::smem_desc(sb + cw * C::kBBytes + kk * 16 * W * 2, kBChunk,
                            kAtom, 1),
              1);
        s9::wgmma_commit();
      };

      s9::mbar_wait(a_full, 0);  // also when no tile is visited: TMA is done
      int ct = visible(ct_begin);
      int st = 0, buf = 0, st_prev = -1;
      uint32_t ph = 0;
      if (ct < ct_end) {
        s9::mbar_wait(full0, 0);
        issue_xy(0);
        s9::wgmma_wait<0>();
        s9::fence_regs(xy);
      }
      // The tiles are software-pipelined around the swap: tile j's partial
      // goes to the other block, tile j - 1's accumulation and tile j + 1's
      // partial go to the tensor cores, and only then is tile j's swap
      // waited for. No accumulator is read while a wgmma is in flight
      // (ptxas would serialize them).
      while (ct < ct_end) {
        const int cn = visible(ct + 1);
        int sn = st + 1;
        uint32_t pn = ph;
        if (sn == S) {
          sn = 0;
          pn ^= 1;
        }
        push();
        if (st_prev >= 0) issue_acc(st_prev, t_s + (buf ^ 1) * kTBytes);
        if (cn < ct_end) {
          s9::mbar_wait(full0 + 8 * sn, pn);
          issue_xy(sn);
        }
        pull();

        // P and dS = P (dP - delta) at this consumer's 16 columns, under
        // the columns' lse and delta from the stage
        const int state = pair(ct);
        const float* cst = stats + st * 2 * kBC;
        float ds[8], pr[8];
        if (plain_tile(state)) {
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int lc = 16 * cw + 8 * u + 2 * t + (e & 1);  // column
              pr[4 * u + e] =
                  prob_plain(sx[4 * u + e], e, ct * kBC + lc, cst[lc]);
            }
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int lc = 16 * cw + 8 * u + 2 * t + (e & 1);
              pr[4 * u + e] =
                  prob(sx[4 * u + e], e, ct * kBC + lc, state, cst[lc]);
            }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int lc = 16 * cw + 8 * u + 2 * t + (e & 1);
            ds[4 * u + e] = pr[4 * u + e] * (sy[4 * u + e] - cst[kBC + lc]);
          }
        s9::wgmma_wait<0>();  // the last tile's accumulation, the next partial
        s9::fence_regs(acc);
        s9::fence_regs(xy);
        if (st_prev >= 0) s9::mbar_arrive(empty0 + 8 * st_prev);

        // dS^T (units 2cw + u) and P^T (units 4 + 2cw + u) in bf16 into
        // this tile's T buffer, row r at unit u ^ (r % 8). The other
        // consumer's accumulation of two tiles ago, the last to read this
        // buffer, is done: it waited for it before the last barrier.
        unsigned char* tm = smem + C::kTOff + buf * kTBytes;
        auto put = [&](int r, int unit, float lo, float hi) {
          *reinterpret_cast<__nv_bfloat162*>(
              tm + r * 128 + ((unit ^ (r & 7)) << 4) + 4 * t) =
              __floats2bfloat162_rn(lo, hi);
        };
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          put(rl0, 2 * cw + u, ds[4 * u], ds[4 * u + 1]);
          put(rl1, 2 * cw + u, ds[4 * u + 2], ds[4 * u + 3]);
          put(rl0, 4 + 2 * cw + u, pr[4 * u], pr[4 * u + 1]);
          put(rl1, 4 + 2 * cw + u, pr[4 * u + 2], pr[4 * u + 3]);
        }
        s9::fence_proxy_async();  // T's stores, visible to wgmma
        // T is whole, and both consumers pulled: `out` may take the next
        // push
        s9::named_barrier_sync(1, kConsumers);
        st_prev = st;
        ct = cn;
        st = sn;
        ph = pn;
        buf ^= 1;
      }
      if (st_prev >= 0) {  // the last tile's accumulation
        issue_acc(st_prev, t_s + (buf ^ 1) * kTBytes);
        s9::wgmma_wait<0>();
        s9::fence_regs(acc);
        s9::mbar_arrive(empty0 + 8 * st_prev);
      }
    }

    // Epilogue: dq / dk times scale, dv as it is, in bf16 through the
    // output's strides, this block's columns (dq: this consumer's half);
    // rows past L and columns past d are not written.
    const bool dv = !rows_q && cw == 1;
    const float mul = dv ? 1.f : p.scale;
    __nv_bfloat16* out = dv ? p.o1 : p.o0;
    const long long* os = dv ? p.o1s : p.o0s;
    __nv_bfloat16* ob = out + b * os[0] + h * os[1];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (rows_q && (j < DH / 16) != (cw == 0)) continue;
      const int col = c0 + 8 * j + 2 * t;
      if (col >= p.d) continue;
      if (r0 < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * os[2] + col) =
            __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
      if (r1 < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * os[2] + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
  }
  // neither block leaves while the other may still copy into it
  s9::cluster_sync();
}

// One launch at width DP: K3 (k4 = 0; maps q, dO as A, k, v as B) or K4
// (k4 = 1; maps k, v as A, q, dO as B), two blocks (one cluster) a row tile;
// each role is a kernel of its own (DKV), so that neither carries the
// other's code.
// strides: (batch, head, seq) element strides of q, k, v, dO (12 values).
template <int DP>
cudaError_t launch(bool any, const void* q, const void* k, const void* v,
                   const void* g, const long long* st, Params p,
                   cudaStream_t stream) {
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const bool k4 = p.k4 != 0;
  const void* a1 = k4 ? k : q;
  const void* a2 = k4 ? v : g;
  const void* b1 = k4 ? q : k;
  const void* b2 = k4 ? g : v;
  const long long* sa1 = k4 ? st + 3 : st;
  const long long* sa2 = k4 ? st + 6 : st + 9;
  const long long* sb1 = k4 ? st : st + 3;
  const long long* sb2 = k4 ? st + 9 : st + 6;
  const int la = k4 ? p.Lk : p.Lq, lb = k4 ? p.Lq : p.Lk;
  p.n_rt = (la + kBR - 1) / kBR;
  CUtensorMap ta1, ta2, tb1, tb2;
  cudaError_t err = s9::make_map(&ta1, a1, p.d, la, p.H, p.B, sa1, W, kBR, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&ta2, a2, p.d, la, p.H, p.B, sa2, W, kBR, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tb1, b1, p.d, lb, p.H, p.B, sb1, W, kBC, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tb2, b2, p.d, lb, p.H, p.B, sb2, W, kBC, sw);
  if (err != cudaSuccess) return err;
  const int blocks = 2 * p.B * p.H * p.n_rt;
  const auto kernel =
      any ? (k4 ? flash_bwd_wide_sm90_kernel<DP, true, true>
                : flash_bwd_wide_sm90_kernel<DP, true, false>)
          : (k4 ? flash_bwd_wide_sm90_kernel<DP, false, true>
                : flash_bwd_wide_sm90_kernel<DP, false, false>);
  return s9::launch_kernel(kernel, blocks, kThreads, Cfg<DP>::kSmemBytes,
                           stream, ta1, ta2, tb1, tb2, p);
}

// The explicit instantiation of launch<DP> (P: empty, or `extern` for its
// declaration); each width in one flash_attention_wide_bwd_sm90_w*.cu.
#define FDSD_KW_WIDTH_(P, DP)                                              \
  P template cudaError_t launch<DP>(bool, const void*, const void*,       \
                                    const void*, const void*,             \
                                    const long long*, Params,             \
                                    cudaStream_t);
#define FDSD_KW_WIDTH(DP) FDSD_KW_WIDTH_(, DP)
FDSD_KW_WIDTH_(extern, 384)
FDSD_KW_WIDTH_(extern, 512)

// K3 / K6 (k4 = 0) or K4 / K7 above head dim 256: d a multiple of 8 from
// 264 to 512, at DP = 384 up to 384, else 512. strides: (batch, head, seq)
// of q, k, v, dO, then of the outputs (dq; or dk, dv), then the bias's 4
// (K3 / K4). pos: the position masks (K6 / K7), or offsets null with seg_q
// = Lq, seg_k = Lk and causal the flag of K3 / K4.
inline cudaError_t launch_wide(int k4, const void* q, const void* k,
                               const void* v, const void* g, void* o0,
                               void* o1, void* dbias, const void* lse,
                               const void* delta, const void* bias,
                               int bias_bf16, const void* q_ids,
                               const void* kv_ids, const void* q_bounds,
                               const void* kv_bounds, const void* lo,
                               const void* hi, int B, int H, int Lq, int Lk,
                               int d, const long long* strides, float scale,
                               const PosArgs& pos, cudaStream_t stream) {
  if (d <= 256 || d > 512 || d % 8 != 0) return cudaErrorInvalidValue;
  Params p = {};
  p.o0 = static_cast<__nv_bfloat16*>(o0);
  p.o1 = static_cast<__nv_bfloat16*>(o1);
  p.dbias = bias != nullptr ? static_cast<float*>(dbias) : nullptr;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.k4 = k4;
  p.pos = pos;
  for (int i = 0; i < 3; ++i) {
    p.o0s[i] = strides[12 + i];
    p.o1s[i] = k4 ? strides[15 + i] : 0;
  }
  p.scale = scale;
  if (bias != nullptr || q_ids != nullptr)  // K6 / K7 pass no bias strides
    p.m = fdsd::make_mask_args(bias, strides + (k4 ? 18 : 15), bias_bf16,
                               q_ids, kv_ids, q_bounds, kv_bounds, lo, hi);
  const bool any = pos.causal != 0 || pos.has_valid != 0 ||
                   bias != nullptr || q_ids != nullptr;
  return d <= 384 ? launch<384>(any, q, k, v, g, strides, p, stream)
                  : launch<512>(any, q, k, v, g, strides, p, stream);
}

}  // namespace fdsd::kw
