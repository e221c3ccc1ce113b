// The fp32 flash backward above head dim 256: K3 (dq, and dbias) and K4
// (dk, dv) on fp32 inputs on the tensor cores at the padded widths DP = 384
// (head dims 257 to 384) and 512 (385 to 512), without a mask and in every
// mask form (causal, a bias with dbias, segment ids; ANY), and K6 (dq) and
// K7 (dk, dv) under the position masks (ANY), on the split terms the
// pre-pass of flash_f32_bwd.cu writes. The dispatch and the C
// entries are flash_f32_bwd.cu's; each width is instantiated in its own
// flash_f32_bwd_w*.cu.
//
// Replaces, for fp32 q, k, v, dO above head dim 256 (the VAEs' one-head mid
// attention at 512 in fp32, SD1's default decode dtype), the Pallas TPU
// kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel_pos
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel_pos
// under Precision.HIGHEST (K6 / K7 under the caller's global lse and
// delta). The contract and the numerical plan are those of
// the kernels up to 256 (flash_f32_bwd.cu): the three-term TF32 split on
// every product, P and dS fp32 and selected to 0 where hidden, query rows
// past Lq at lse = +1e30, dq, dk, dv fp32, the same pre-pass and workspace.
//
// What bounds it on the H100: operations (3 Lq Lk d multiply-adds for dq, 4
// for dk / dv, three TF32 passes each at 495 TFLOP/s).
//
// Why streaming. The kernels up to 256 keep both terms of a 64-row operand
// resident, 1 KB a column, on a cluster of two blocks that split the
// columns: at DP 512 each block's half of Q and dO alone would take 256 KB.
// A cluster of four, each block a quarter of the columns, would swap three
// partials a tile through the bulk-copy unit. These kernels keep nothing
// resident instead: every operand streams through the fp32 forward's ring
// of three 64 KB slots (flash_f32_fwd_wide.cuh, whose layout, slot sizes
// and S chunk they share), so one block does all of a tile's work with no
// exchange between SMs, at the cost the header of flash_f32_bwd.cuh works
// out: the row operand is read again from L2 for every column tile.
//
// Design. The three gradients are one computation with the axes' roles
// swapped (as the bf16 kernel above 256, flash_attention_wide_bwd_sm90.cuh):
// a block owns 64 rows and walks tiles of 64 columns of the other axis,
//   dq  (rows queries): X = Q K^T, Y = dO V^T, T = dS,   acc += T K;
//   dk  (rows keys):    X = K Q^T, Y = V dO^T, T = dS^T, acc += T Q;
//   dv  (rows keys):    X = K Q^T,             T = P^T,  acc += T dO;
// K4 runs dk and dv as two roles of one launch, one block each per 64-key
// tile, so that each block holds one accumulator of 64 x DP fp32 over its
// two consumers (DP / 4 registers a thread); X = S^T is computed twice a key
// tile. One block of a producer warpgroup and two consumer warpgroups:
//  - the producer thread streams, for each column tile, the hi / lo terms of
//    the row and column operands of X in chunks of 64 columns of d, then
//    those of Y (dq, dk), then the transposed terms of acc's B operand (K^T,
//    Q^T or dO^T: positions permuted within groups of 8) in DP / 128 pieces
//    of 64 rows of d a consumer, through the three slots with full / empty
//    mbarriers;
//  - the two consumers split X and Y by columns (32 each: m64n32k8 SS, each
//    chunk of 64 columns of d into a fresh accumulator added in registers:
//    no chain longer than 3 x 64 / 8 = 24), form T in registers from the
//    lse and delta (of the rows in registers for dq, of the columns read
//    per logit for dk / dv), write T's hi / lo terms into the shared 64 x 64
//    tile (the positions in the transposed terms' order), meet at a named
//    barrier, and each runs acc[:, its DP / 2 columns] += T B over the
//    pieces (m64n64k8 SS, three passes, each piece into a fresh
//    accumulator); a second named barrier before T is written keeps a
//    consumer from overwriting the tile the other still reads.
//  - masks (ANY: the position masks of pos_tile.cuh, two offset segments a
//    side, valid_len and causal by position, judged per (query tile, key
//    tile) pair by tile_pair whichever axis the rows are and per logit on a
//    partly visible pair (K3 / K4's causal: offsets 0); an fp32 bias read
//    per logit from global memory, a logit at -1e30 or -inf hidden, segment
//    ids walking the tile range [lo, hi] of mask.cuh at (64, 64) and
//    compared per logit) and dbias (dq: dS for every tile of the block's
//    rows, zeros where a tile is skipped), as the bf16 kernel above 256.

#pragma once

#include "../mask.cuh"
#include "../sm90.cuh"
#include "flash_f32_bwd.cuh"
#include "flash_f32_fwd_wide.cuh"

namespace fdsd::f32bwd {

namespace stream {
constexpr int kBR = 64, kBC = 64;  // rows a block, columns a tile
constexpr int kThreads = 384, kConsumers = 256, kConsumerRegs = 232;
enum Role { kDQ = 0, kDK = 1, kDV = 2 };
template <int N>
using Steps = std::integral_constant<int, N>;
}  // namespace stream

// The maps: ta1 / ta2 the row operand's terms of X / Y, tb1 / tb2 the
// column operand's (boxes of 32 columns x 64 rows), tt1 / tt2 the
// transposed terms of acc's B operand for dq and dk / for dv (boxes of 32
// positions x 64 rows of d). p.o1 == nullptr: dq; else dk (blocks of the
// first half) and dv.
template <int DP, bool ANY>
__global__ void __launch_bounds__(stream::kThreads, 1)
flash_bwd_f32_stream_kernel(const __grid_constant__ CUtensorMap ta1,
                            const __grid_constant__ CUtensorMap ta2,
                            const __grid_constant__ CUtensorMap tb1,
                            const __grid_constant__ CUtensorMap tb2,
                            const __grid_constant__ CUtensorMap tt1,
                            const __grid_constant__ CUtensorMap tt2,
                            const __grid_constant__ Params p) {
  using namespace stream;
  using C = fdsd::f32fwd::WideCfg<DP>;
  constexpr int kVR = C::kVRows;
  static_assert(C::kBK == kBC && C::kBQ == kBR, "the forward's tiles");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t t_s = base + C::kPOff;  // T hi, T lo: 16 KB each
  const uint32_t full0 = base + C::kBarOff, empty0 = full0 + 8 * C::kSlots;

  const int tid = threadIdx.x;
  const bool k4 = p.o1 != nullptr;
  const int per_role = p.B * p.H * p.n_tiles;
  const int role = k4 ? kDK + static_cast<int>(blockIdx.x) / per_role : kDQ;
  const int rest = static_cast<int>(blockIdx.x) % per_role;
  const int bh = rest / p.n_tiles;
  int rt = rest % p.n_tiles;
  const bool rows_q = role == kDQ;
  const bool need_y = role != kDV;
  const bool causal = ANY && p.pos.causal != 0;
  const bool masked = causal || (ANY && p.pos.has_valid != 0);
  const bool has_bias = ANY && p.m.bias != nullptr;
  const bool has_seg = ANY && p.m.q_ids != nullptr;
  const Offsets offs(p.pos, masked);  // positions matter only to a mask
  if (causal && rows_q) rt = p.n_tiles - 1 - rt;  // the longest rows first
  const int b = bh / p.H, h = bh % p.H;
  const int r0_tile = rt * kBR;
  const int n_rows = rows_q ? p.Lq : p.Lk, n_cols = rows_q ? p.Lk : p.Lq;
  const int n_ct = (n_cols + kBC - 1) / kBC;
  const CUtensorMap* tt = role == kDV ? &tt2 : &tt1;

  // The column tiles this block visits, the same walk in every role (as the
  // bf16 kernel above 256): those tile_pair does not skip, the query tile
  // and the key tile passed as such whichever axis the rows are; the range
  // whose segment ids overlap this row tile's, less the disjoint tiles.
  int ct_begin = 0, ct_end = n_ct;
  const int* row_bound = nullptr;
  const int* col_bounds = nullptr;
  if (has_seg) {
    const int seg_tile = b * p.n_tiles + rt;
    ct_begin = max(ct_begin, p.m.lo[seg_tile]);
    ct_end = min(ct_end, p.m.hi[seg_tile] + 1);
    row_bound = (rows_q ? p.m.q_bounds : p.m.kv_bounds) + 2 * seg_tile;
    col_bounds = (rows_q ? p.m.kv_bounds : p.m.q_bounds) + 2 * b * n_ct;
  }
  // 0 skip, 1 visible, 2 masked per logit by position
  auto pair = [&](int ct) {
    if (ct < ct_begin || ct >= ct_end ||
        (has_seg && !seg_overlap(row_bound, col_bounds + 2 * ct)))
      return 0;
    return rows_q ? tile_pair(p, offs, masked, r0_tile, kBR, ct * kBC, kBC)
                  : tile_pair(p, offs, masked, ct * kBC, kBC, r0_tile, kBR);
  };

  if (tid == 0) {
    for (int s = 0; s < C::kSlots; ++s) {
      s9::mbar_init(full0 + 8 * s, 1);
      s9::mbar_init(empty0 + 8 * s, kConsumers);
    }
    s9::mbar_init_fence();
  } else if (tid == 32) {
    s9::prefetch_tensormap(&ta1);
    s9::prefetch_tensormap(&ta2);
    s9::prefetch_tensormap(&tb1);
    s9::prefetch_tensormap(&tb2);
    s9::prefetch_tensormap(tt);
  }
  __syncthreads();

  int slot = 0;
  uint32_t phase = 0;
  auto next = [&]() {
    if (++slot == C::kSlots) {
      slot = 0;
      phase ^= 1;
    }
  };

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid != 0) return;
    for (int ct = ct_begin; ct < ct_end; ++ct) {
      if (pair(ct) == 0) continue;
      const int c0 = ct * kBC;
      for (int pass = 0; pass < (need_y ? 2 : 1); ++pass) {  // X, then Y
        const CUtensorMap* ta = pass == 0 ? &ta1 : &ta2;
        const CUtensorMap* tb = pass == 0 ? &tb1 : &tb2;
        for (int c = 0; c < C::kSChunks; ++c) {
          const int halves = min(2, (DP - 64 * c) / 32);
          const uint32_t full = full0 + 8 * slot;
          const uint32_t sb = base + slot * C::kSlotBytes;
          s9::mbar_wait(empty0 + 8 * slot, phase ^ 1);
          s9::mbar_expect_tx(full, 4 * halves * C::kChunk);
          for (int term = 0; term < 2; ++term)
            for (int half = 0; half < halves; ++half) {
              const uint32_t at =
                  sb + term * 2 * C::kChunk + half * C::kChunk;
              s9::tma_load_4d(at, ta, full, 64 * c + 32 * half, r0_tile, h,
                              b + term * p.B);
              s9::tma_load_4d(at + 4 * C::kChunk, tb, full,
                              64 * c + 32 * half, c0, h, b + term * p.B);
            }
          next();
        }
      }
      for (int j = 0; j < C::kVSlots; ++j) {  // acc's B: transposed terms
        const uint32_t full = full0 + 8 * slot;
        const uint32_t sb = base + slot * C::kSlotBytes;
        s9::mbar_wait(empty0 + 8 * slot, phase ^ 1);
        s9::mbar_expect_tx(full, 8 * C::kVChunk);
        for (int w = 0; w < 2; ++w)
          for (int term = 0; term < 2; ++term)
            for (int kc = 0; kc < 2; ++kc)
              s9::tma_load_4d(
                  sb + (2 * w + term) * 2 * C::kVChunk + kc * C::kVChunk, tt,
                  full, c0 + 32 * kc, DP / 2 * w + kVR * j, h,
                  b + term * p.B);
        next();
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  s9::reg_alloc<kConsumerRegs>();
  const int cw = (tid - 128) / 128;  // columns 32cw .. of a tile, DP/2 cw ..
  const int warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = 16 * warp + g, rl1 = rl0 + 8;  // tile rows
  const int r0 = r0_tile + rl0, r1 = r0_tile + rl1;
  const long long bq = static_cast<long long>(bh) * p.Lq;
  const float* lse_b = p.lse + bq;
  const float* dl_b = p.delta + bq;
  float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;  // dq: of the rows
  if (rows_q) {
    lse0 = (r0 < p.Lq ? lse_b[r0] : kPadLse) * kLog2e;
    lse1 = (r1 < p.Lq ? lse_b[r1] : kPadLse) * kLog2e;
    dl0 = r0 < p.Lq ? dl_b[r0] : 0.f;
    dl1 = r1 < p.Lq ? dl_b[r1] : 0.f;
  }
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
  const float c = has_bias ? kLog2e : p.scale * kLog2e;
  // dq: the positions of this thread's two query rows (rows past Lq are not
  // written, whatever they see)
  int qpos0 = 0, qpos1 = 0;
  if (masked && rows_q) {
    qpos0 = pos_of(r0, offs.q0, offs.q1, p.pos.seg_q);
    qpos1 = pos_of(r1, offs.q0, offs.q1, p.pos.seg_q);
  }
  float* db = ANY && rows_q && has_bias && p.ds != nullptr ? p.ds + bq * p.Lk
                                                           : nullptr;
  auto write_db = [&](const float (&x)[16], int c0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = c0 + 32 * cw + 8 * j + 2 * t + (e & 1);
        if (row < p.Lq && col < p.Lk)
          db[static_cast<long long>(row) * p.Lk + col] = x[4 * j + e];
      }
  };

  float o[C::kVSlots][kVR / 2];  // output columns DP/2 cw + kVR j ..
#pragma unroll
  for (int j = 0; j < C::kVSlots; ++j)
#pragma unroll
    for (int i = 0; i < kVR / 2; ++i) o[j][i] = 0.f;
  float x[16], y[16], part[16];  // X, Y of this thread's 32 columns

  // X (or Y) over the chunks of d, each chunk into a fresh accumulator.
  auto product = [&](float (&acc)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    auto chunk = [&](auto steps) {
      const uint32_t sb = base + slot * C::kSlotBytes;
      s9::mbar_wait(full0 + 8 * slot, phase);
      fdsd::f32fwd::s_chunk<decltype(steps)::value>(part, sb, cw);
      s9::mbar_arrive(empty0 + 8 * slot);
      next();
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += part[i];
    };
    for (int cc = 0; cc < DP / 64; ++cc) chunk(Steps<8>());
  };

  const int ct_first = db != nullptr ? 0 : ct_begin;
  const int ct_last = db != nullptr ? n_ct : ct_end;
  for (int ct = ct_first; ct < ct_last; ++ct) {
    const int c0 = ct * kBC;
    const int state = pair(ct);
    if (state == 0) {
      if (db != nullptr) {
#pragma unroll
        for (int i = 0; i < 16; ++i) x[i] = 0.f;
        write_db(x, c0);
      }
      continue;
    }
    product(x);
    if (need_y) product(y);

    // P = exp(logit - lse), selected to 0 where hidden; T = P (dv) or
    // dS = P (dP - delta), in place of X.
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = c0 + 32 * cw + 8 * j + 2 * t + (e & 1);
        const int qi = rows_q ? row : col, ki = rows_q ? col : row;
        float lg = x[4 * j + e];
        bool visible = qi < p.Lq && ki < p.Lk;
        if (has_bias) {  // logit = scale * s + bias, in fp32
          lg = fmaf(lg, p.scale,
                    visible ? fdsd::load_bias(p.m, bias_base, qi, ki) : 0.f);
          visible = visible && lg > kNegInf;
        }
        if (state == 2 && visible) {  // a partly visible pair: by position
          const int qpos = rows_q ? (e < 2 ? qpos0 : qpos1)
                                  : pos_of(qi, offs.q0, offs.q1, p.pos.seg_q);
          visible = pos_sees(p, offs, qpos, ki);
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
    if (db != nullptr) write_db(x, c0);

    // T's hi / lo terms into this group's half of the T tile: column 2t of
    // a group of 8 at position t, 2t + 1 at t + 4 (the transposed terms'
    // order); row r, positions 4u .. 4u + 3 of a chunk at unit u ^ (r % 8),
    // once the other consumer has read the last tile's T.
    s9::named_barrier_sync(1, kConsumers);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? rl0 : rl1, u = 2 * j + (e & 1);
        unsigned char* at = smem + C::kPOff + cw * C::kChunk + r * 128 +
                            ((u ^ (r & 7)) << 4) + 4 * t;
        const uint32_t hi = s9::to_tf32(x[4 * j + e]);
        *reinterpret_cast<uint32_t*>(at) = hi;
        *reinterpret_cast<uint32_t*>(at + 2 * C::kChunk) =
            s9::to_tf32(x[4 * j + e] - __uint_as_float(hi));
      }
    s9::fence_proxy_async();  // T's stores, visible to wgmma
    s9::named_barrier_sync(2, kConsumers);

    // acc[:, DP/2 cw + kVR j ..] += T B over the pieces, three passes each,
    // into a fresh accumulator added to acc in registers.
#pragma unroll
    for (int j = 0; j < C::kVSlots; ++j) {
      const uint32_t sb = base + slot * C::kSlotBytes + cw * 4 * C::kVChunk;
      float piece[kVR / 2];
      s9::mbar_wait(full0 + 8 * slot, phase);
      s9::fence_regs(piece);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBC / 8; ++kk) {
        const uint32_t off = (kk / 4) * C::kChunk + (kk % 4) * 32;
        const uint32_t voff = (kk / 4) * C::kVChunk + (kk % 4) * 32;
        const uint64_t th = s9::smem_desc(t_s + off, 16, 1024, 1);
        const uint64_t tl =
            s9::smem_desc(t_s + 2 * C::kChunk + off, 16, 1024, 1);
        const uint64_t bh_ = s9::smem_desc(sb + voff, 16, 1024, 1);
        const uint64_t bl =
            s9::smem_desc(sb + 2 * C::kVChunk + voff, 16, 1024, 1);
        s9::wgmma_tf32_ss<kVR>(piece, tl, bh_, kk > 0);
        s9::wgmma_tf32_ss<kVR>(piece, th, bl, 1);
        s9::wgmma_tf32_ss<kVR>(piece, th, bh_, 1);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(piece);
      s9::mbar_arrive(empty0 + 8 * slot);
      next();
#pragma unroll
      for (int i = 0; i < kVR / 2; ++i) o[j][i] += piece[i];
    }
  }

  // Epilogue: dq / dk times scale, dv as it is, fp32 through the output's
  // strides; rows past L and columns past d are not written.
  const float mul = role == kDV ? 1.f : p.scale;
  float* out = role == kDV ? p.o1 : p.o0;
  const long long* os = role == kDV ? p.o1s : p.o0s;
  float* ob = out + b * os[0] + h * os[1] + r0 * os[2];
#pragma unroll
  for (int j = 0; j < C::kVSlots; ++j)
#pragma unroll
    for (int i = 0; i < kVR / 8; ++i) {
      const int col = DP / 2 * cw + kVR * j + 8 * i + 2 * t;
      if (col >= p.d) continue;
      if (r0 < n_rows)
        *reinterpret_cast<float2*>(ob + col) =
            make_float2(o[j][4 * i] * mul, o[j][4 * i + 1] * mul);
      if (r1 < n_rows)
        *reinterpret_cast<float2*>(ob + 8 * os[2] + col) =
            make_float2(o[j][4 * i + 2] * mul, o[j][4 * i + 3] * mul);
    }
}

// K3 (p.o1 null) or K4 at padded width DP (384, 512) on terms the pre-pass
// has written into the workspace w; p.n_tiles is set here. K4 launches the
// dk and the dv blocks together.
template <int DP, bool ANY>
cudaError_t run_stream(const Work& w, Params p, cudaStream_t s) {
  using C = fdsd::f32fwd::WideCfg<DP>;
  const bool k4 = p.o1 != nullptr;
  const int la = k4 ? p.Lk : p.Lq, lb = k4 ? p.Lq : p.Lk;
  CUtensorMap ta1, ta2, tb1, tb2, tt1, tt2;
  cudaError_t err = rows_map(&ta1, k4 ? w.k : w.q, p.B, p.H, la, p.d, 32,
                             stream::kBR);
  if (err == cudaSuccess)
    err = rows_map(&ta2, k4 ? w.v : w.g, p.B, p.H, la, p.d, 32, stream::kBR);
  if (err == cudaSuccess)
    err = rows_map(&tb1, k4 ? w.q : w.k, p.B, p.H, lb, p.d, 32, stream::kBC);
  if (err == cudaSuccess)
    err = rows_map(&tb2, k4 ? w.g : w.v, p.B, p.H, lb, p.d, 32, stream::kBC);
  if (err == cudaSuccess)
    err = transposed_map(&tt1, k4 ? w.qt : w.kt, p.B, p.H, lb, p.d, 32,
                         C::kVRows);
  if (err == cudaSuccess)
    err = transposed_map(&tt2, k4 ? w.gt : w.kt, p.B, p.H, lb, p.d, 32,
                         C::kVRows);
  if (err != cudaSuccess) return err;
  p.n_tiles = (la + stream::kBR - 1) / stream::kBR;
  return s9::launch_kernel(flash_bwd_f32_stream_kernel<DP, ANY>,
                           (k4 ? 2 : 1) * p.B * p.H * p.n_tiles,
                           stream::kThreads, C::kSmemBytes, s, ta1, ta2, tb1,
                           tb2, tt1, tt2, p);
}

// The instantiations of one width, without a mask and ANY (P: empty, or
// `extern` for their declarations); each width in one flash_f32_bwd_w*.cu.
#define FDSD_F32_BWD_STREAM(P, DP)                                          \
  P template cudaError_t run_stream<DP, false>(const Work&, Params,         \
                                               cudaStream_t);               \
  P template cudaError_t run_stream<DP, true>(const Work&, Params,          \
                                              cudaStream_t);
FDSD_F32_BWD_STREAM(extern, 384)
FDSD_F32_BWD_STREAM(extern, 512)

}  // namespace fdsd::f32bwd
