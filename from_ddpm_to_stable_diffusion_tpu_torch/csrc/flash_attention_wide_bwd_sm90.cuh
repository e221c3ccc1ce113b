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
// Design. The three gradients are one computation with the roles of the
// axes swapped: a block owns 64 "rows" and walks tiles of 32 "columns" of
// the other axis, computes X = A1 B1^T and Y = A2 B2^T (64 x 32 each), forms
// T from them in registers and accumulates T B over the columns:
//   dq  (role kDQ): rows queries, A1 Q, A2 dO, B1 K, B2 V; T = dS, B = K;
//   dk  (role kDK): rows keys,    A1 K, A2 V,  B1 Q, B2 dO; T = dS^T, B = Q;
//   dv  (role kDV): rows keys,    A1 K,        B1 Q, B2 dO; T = P^T, B = dO.
// The accumulator of 64 rows x DP columns would take DP / 2 registers a
// thread over two warpgroups, 256 at DP 512, more than a thread may hold
// beside anything else, so each consumer warpgroup owns half of the columns
// (DP / 4 registers). For dk / dv that still leaves two accumulators, so K4
// runs them as two roles of one launch, one block each per 64-key tile: the
// dv block computes S^T and P^T only, the dk block S^T and dP^T too; S^T is
// computed twice a key tile (five L^2 d products where four are needed),
// which is what keeps every accumulator in registers without a cluster and
// without a second kernel. (A cluster pair swapping S^T / dP^T partials, as
// the fp32 kernels up to 256 do, was the other way; it moves the partials
// through the bulk-copy unit every tile and is not needed for a simple
// kernel that is right.)
// One block of three warpgroups per (role, b*h, 64 rows):
//  - a producer warpgroup gives up its registers (setmaxnreg 40); one thread
//    issues TMA: A1 and A2 once (64 KB each at DP 512; dv needs no A2), then
//    B1 and B2 tiles of 32 rows (32 KB each) on one single-stage full /
//    empty mbarrier pair. Boxes are 64 columns with 128-byte swizzle; the
//    columns past the head dim read as TMA's zeros, rows past L as zeros.
//  - two consumer warpgroups (setmaxnreg 232) split X and Y by columns:
//    each computes its 16 of the tile's 32 columns over the full d (wgmma
//    m64n16k16 SS, both operands K-major as TMA wrote them), so X and Y are
//    computed once a tile; each writes its half of T in bf16 into a shared
//    (64 x 64) tile in the 128-byte swizzled K-major layout wgmma reads
//    (only its first 32 columns used), fences it to the async proxy, and
//    after a named barrier runs acc[:, its DP / 2 columns] += T B with B
//    MN-major from the tile as it lies (m64n(DP/2)k16 SS, two k-steps). T is
//    double-buffered, so one barrier a tile keeps a consumer from writing a
//    tile the other may still read.
//  - lse and delta: of the rows, in registers (dq); of the columns, read per
//    logit from global memory (dk / dv). Query rows past Lq get lse = +1e30
//    (P = 0) and are not written; a query column past Lq and a key past Lk
//    are selected to P = 0.
//  - masks (the ANY instantiation, every path chosen per launch): the
//    position masks of pos_tile.cuh (two offset segments a side, valid_len,
//    causal by position; K3 / K4's causal is the same predicate with
//    offsets 0, key <= query from index 0) judge each (row tile, column
//    tile) pair by pos_pair, called with the query tile's and the key
//    tile's ranges whichever axis the rows are, in every role: a pair that
//    shows nothing is skipped, a partly visible one masked per logit; the
//    bias is read from global memory into each logit (scale s + bias in
//    fp32; a bias of -1e30 or -inf hides the key); segment ids walk the
//    tile range [lo, hi] of mask.cuh at (64 rows, 32 columns), skip a tile
//    whose id range is disjoint and compare ids per logit.
// dq and dk (times scale) and dv are written in bf16 through their strides;
// rows whose tiles were all skipped as 0 (a dk / dv block whose keys no
// query sees writes its zeros too); columns past d are not written.

#pragma once

#include "mask.cuh"
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
constexpr int kBR = 64, kBC = 32;  // rows a block, columns a tile
constexpr int kThreads = 384;     // producer warpgroup + two consumers
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr uint32_t kAtom = 8 * W * 2;  // 8 rows of a chunk
constexpr int kAChunk = kBR * W * 2, kBChunk = kBC * W * 2;
constexpr int kTBytes = kBR * W * 2;  // one T buffer: 64 x 64 bf16
enum Role { kDQ = 0, kDK = 1, kDV = 2 };

template <int DP>
struct Cfg {
  static constexpr int kChunks = DP / W;
  static constexpr int kABytes = kBR * DP * 2, kBBytes = kBC * DP * 2;
  static constexpr int kA2Off = kABytes, kB1Off = 2 * kABytes;
  static constexpr int kB2Off = kB1Off + kBBytes, kTOff = kB2Off + kBBytes;
  static constexpr int kBarOff = kTOff + 2 * kTBytes;
  static constexpr int kBars = 3;  // A full; B full, B empty
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static constexpr int kNC = DP / 2;  // output columns a consumer
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(DP % 128 == 0 && DP <= 512, "width");
};

struct Params {
  __nv_bfloat16* o0;  // dq, or dk
  __nv_bfloat16* o1;  // dv
  float* dbias;       // dq with a bias that needs a gradient, or null
  const float* lse;   // (B, H, Lq)
  const float* delta;  // (B, H, Lq)
  int B, H, Lq, Lk, d;
  int n_rt;    // row tiles of 64 per (b, h)
  int k4;      // 1: roles dk and dv (a launch of twice the blocks), 0: dq
  long long o0s[3], o1s[3];  // outputs' (batch, head, seq) element strides
  float scale;
  PosArgs pos;  // ANY: the position masks (K3 / K4: null offsets, read as 0)
  MaskArgs m;  // ANY: the bias and the segment arrays at (64, 32) tiles
};

template <int DP, bool ANY>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap ta1,
                           const __grid_constant__ CUtensorMap ta2,
                           const __grid_constant__ CUtensorMap tb1,
                           const __grid_constant__ CUtensorMap tb2,
                           const __grid_constant__ Params p) {
  using C = Cfg<DP>;
  constexpr int NC = C::kNC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t a1_s = base, a2_s = base + C::kA2Off;
  const uint32_t b1_s = base + C::kB1Off, b2_s = base + C::kB2Off;
  const uint32_t t_s = base + C::kTOff;
  const uint32_t a_full = base + C::kBarOff, b_full = a_full + 8;
  const uint32_t b_empty = b_full + 8;

  const int tid = threadIdx.x;
  const int per_role = p.B * p.H * p.n_rt;
  const int role = p.k4 ? kDK + static_cast<int>(blockIdx.x) / per_role : kDQ;
  const int rest = static_cast<int>(blockIdx.x) % per_role;
  const int bh = rest / p.n_rt;
  int rt = rest % p.n_rt;
  const bool rows_q = role == kDQ;  // rows are queries (dq) or keys
  const bool need_y = role != kDV;  // Y = A2 B2^T: dP (dq) or dP^T (dk)
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

  // The column tiles this block visits, the same walk in every role: those
  // pos_pair does not skip (the query tile and the key tile passed as such
  // whichever axis the rows are); the range whose segment ids overlap this
  // row tile's, less the disjoint tiles inside it.
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

  if (tid == 0) {
    s9::mbar_init(a_full, 1);
    s9::mbar_init(b_full, 1);
    s9::mbar_init(b_empty, kConsumers);
    s9::mbar_init_fence();
  } else if (tid == 32) {  // fetch the descriptors while barriers are set up
    s9::prefetch_tensormap(&ta1);
    s9::prefetch_tensormap(&ta2);
    s9::prefetch_tensormap(&tb1);
    s9::prefetch_tensormap(&tb2);
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      s9::mbar_expect_tx(a_full, (need_y ? 2 : 1) * C::kABytes);
      for (int c = 0; c < C::kChunks; ++c) {
        s9::tma_load_4d(a1_s + c * kAChunk, &ta1, a_full, c * W, r0_tile, h,
                        b);
        if (need_y)
          s9::tma_load_4d(a2_s + c * kAChunk, &ta2, a_full, c * W, r0_tile,
                          h, b);
      }
      uint32_t phase = 0;
      for (int ct = ct_begin; ct < ct_end; ++ct) {
        if (pair(ct) == 0) continue;
        const int c0 = ct * kBC;
        s9::mbar_wait(b_empty, phase ^ 1);
        s9::mbar_expect_tx(b_full, 2 * C::kBBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          s9::tma_load_4d(b1_s + c * kBChunk, &tb1, b_full, c * W, c0, h, b);
          s9::tma_load_4d(b2_s + c * kBChunk, &tb2, b_full, c * W, c0, h, b);
        }
        phase ^= 1;
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  s9::reg_alloc<kConsumerRegs>();
  const int cw = (tid - 128) / 128;  // columns 16cw .. of a tile, NC cw .. of d
  const int warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = 16 * warp + g, rl1 = rl0 + 8;  // tile rows
  const int r0 = r0_tile + rl0, r1 = r0_tile + rl1;
  const long long bq = static_cast<long long>(bh) * p.Lq;  // lse, delta
  const float* lse_b = p.lse + bq;
  const float* dl_b = p.delta + bq;
  // dq: the lse (times log2 e) and delta of this thread's two query rows
  float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  if (rows_q) {
    lse0 = (r0 < p.Lq ? lse_b[r0] : kPadLse) * kLog2e;
    lse1 = (r1 < p.Lq ? lse_b[r1] : kPadLse) * kLog2e;
    dl0 = r0 < p.Lq ? dl_b[r0] : 0.f;
    dl1 = r1 < p.Lq ? dl_b[r1] : 0.f;
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
  // ANY: the positions of this thread's two rows (queries for dq, keys for
  // dk / dv; rows past L are not written, whatever they see)
  int rpos0 = 0, rpos1 = 0;
  if (masked) {
    const int off0 = rows_q ? q_off0 : k_off0, off1 = rows_q ? q_off1 : k_off1;
    const int seg = rows_q ? p.pos.seg_q : p.pos.seg_k;
    rpos0 = pos_of(r0, off0, off1, seg);
    rpos1 = pos_of(r1, off0, off1, seg);
  }
  // exp(x) = exp2(x log2 e); without a bias the scale is folded in too
  const float c = has_bias ? kLog2e : p.scale * kLog2e;
  // dbias (dq): every tile of this block's rows is written, skipped ones 0
  float* db = ANY && rows_q && has_bias && p.dbias != nullptr
                  ? p.dbias + bq * p.Lk
                  : nullptr;
  auto write_db = [&](const float (&x)[8], int c0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = c0 + 16 * cw + 8 * j + 2 * t + (e & 1);
        if (row < p.Lq && col < p.Lk)
          db[static_cast<long long>(row) * p.Lk + col] = x[4 * j + e];
      }
  };

  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  float x[8], y[8];  // X and Y of this thread's 16 columns, then T
  const uint32_t bx_s = role == kDV ? b2_s : b1_s;  // B of acc += T B

  s9::mbar_wait(a_full, 0);  // also when no tile is visited: TMA is done
  uint32_t phase = 0;
  int buf = 0;
  const int ct_first = db != nullptr ? 0 : ct_begin;
  const int ct_last = db != nullptr ? n_ct : ct_end;
  for (int ct = ct_first; ct < ct_last; ++ct) {
    const int c0 = ct * kBC;
    const int state = pair(ct);
    if (state == 0) {
      if (db != nullptr) {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = 0.f;
        write_db(x, c0);
      }
      continue;
    }
    s9::mbar_wait(b_full, phase);

    // X = A1 B1^T and Y = A2 B2^T for columns 16cw .. 16cw + 15 of the tile.
    s9::fence_regs(x);
    s9::fence_regs(y);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t chunk = kk * 16 / W, off = (kk * 16 % W) * 2;
      s9::wgmma_ss<16>(
          x, s9::smem_desc(a1_s + chunk * kAChunk + off, 16, kAtom, 1),
          s9::smem_desc(b1_s + chunk * kBChunk + cw * 16 * W * 2 + off, 16,
                        kAtom, 1),
          kk > 0);
    }
    if (need_y) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t chunk = kk * 16 / W, off = (kk * 16 % W) * 2;
        s9::wgmma_ss<16>(
            y, s9::smem_desc(a2_s + chunk * kAChunk + off, 16, kAtom, 1),
            s9::smem_desc(b2_s + chunk * kBChunk + cw * 16 * W * 2 + off, 16,
                          kAtom, 1),
            kk > 0);
      }
    }
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
    s9::fence_regs(x);
    s9::fence_regs(y);

    // P = exp(logit - lse), selected to 0 where hidden; T = P (dv) or
    // dS = P (dP - delta), in place of X; its bf16 pairs into this group's
    // half of the T tile: row r, columns 8u .. 8u + 7 at unit u ^ (r % 8).
    const uint32_t tb = t_s + buf * kTBytes;
    unsigned char* tile = smem + C::kTOff + buf * kTBytes;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = c0 + 16 * cw + 8 * j + 2 * t + (e & 1);
        const int qi = rows_q ? row : col, ki = rows_q ? col : row;
        float lg = x[4 * j + e];
        bool visible = qi < p.Lq && ki < p.Lk;
        if (has_bias) {  // logit = scale * s + bias, in fp32
          lg = fmaf(lg, p.scale,
                    visible ? fdsd::load_bias(p.m, bias_base, qi, ki) : 0.f);
          visible = visible && lg > kNegInf;
        }
        if (state == 2) {  // a partly visible pair: by position
          const int cpos = pos_of(col, rows_q ? k_off0 : q_off0,
                                  rows_q ? k_off1 : q_off1,
                                  rows_q ? p.pos.seg_k : p.pos.seg_q);
          const int rpos = e < 2 ? rpos0 : rpos1;
          const int qpos = rows_q ? rpos : cpos, kpos = rows_q ? cpos : rpos;
          if (has_valid) visible = visible && kpos < p.pos.valid_len;
          if (causal) visible = visible && kpos <= qpos;
        }
        if (has_seg)
          visible = visible && col < n_cols &&
                    col_ids[col] == (e < 2 ? rid0 : rid1);
        float lq, dq_;
        if (rows_q) {
          lq = e < 2 ? lse0 : lse1;
          dq_ = e < 2 ? dl0 : dl1;
        } else {
          lq = (qi < p.Lq ? lse_b[qi] : kPadLse) * kLog2e;
          dq_ = need_y && qi < p.Lq ? dl_b[qi] : 0.f;
        }
        float pv = s9::exp2_approx(fmaf(lg, c, -lq));
        if (!visible) pv = 0.f;  // selected
        x[4 * j + e] = need_y ? pv * (y[4 * j + e] - dq_) : pv;
      }
      const int u = 2 * cw + j;
      *reinterpret_cast<__nv_bfloat162*>(
          tile + rl0 * 128 + ((u ^ (rl0 & 7)) << 4) + 4 * t) =
          __floats2bfloat162_rn(x[4 * j], x[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(
          tile + rl1 * 128 + ((u ^ (rl1 & 7)) << 4) + 4 * t) =
          __floats2bfloat162_rn(x[4 * j + 2], x[4 * j + 3]);
    }
    if (db != nullptr) write_db(x, c0);
    s9::fence_proxy_async();  // T's stores, visible to wgmma
    s9::named_barrier_sync(1, kConsumers);

    // acc[:, NC cw ..] += T B: T K-major, B MN-major; the k-step kk is
    // columns 16kk .. 16kk + 15 of the tile.
    s9::fence_regs(acc);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk)
      s9::wgmma_ss<NC, 1>(
          acc, s9::smem_desc(tb + kk * 32, 16, kAtom, 1),
          s9::smem_desc(bx_s + (NC / W) * cw * kBChunk + kk * 16 * W * 2,
                        kBChunk, kAtom, 1),
          1);
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
    s9::fence_regs(acc);
    s9::mbar_arrive(b_empty);  // B1 and B2 are read
    phase ^= 1;
    buf ^= 1;
  }

  // Epilogue: dq / dk times scale, dv as it is, in bf16 through the
  // output's strides; rows past L and columns past d are not written.
  const float mul = role == kDV ? 1.f : p.scale;
  __nv_bfloat16* out = role == kDV ? p.o1 : p.o0;
  const long long* os = role == kDV ? p.o1s : p.o0s;
  __nv_bfloat16* ob = out + b * os[0] + h * os[1];
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = NC * cw + 8 * j + 2 * t;
    if (col >= p.d) continue;
    if (r0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * os[2] + col) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (r1 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * os[2] + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// One launch at width DP: K3 (k4 = 0; maps q, dO as A, k, v as B) or K4
// (k4 = 1; maps k, v as A, q, dO as B). strides: (batch, head, seq) element
// strides of q, k, v, dO (12 values).
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
  const int blocks = (k4 ? 2 : 1) * p.B * p.H * p.n_rt;
  return any ? s9::launch_kernel(flash_bwd_wide_sm90_kernel<DP, true>, blocks,
                                 kThreads, Cfg<DP>::kSmemBytes, stream, ta1,
                                 ta2, tb1, tb2, p)
             : s9::launch_kernel(flash_bwd_wide_sm90_kernel<DP, false>,
                                 blocks, kThreads, Cfg<DP>::kSmemBytes,
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
