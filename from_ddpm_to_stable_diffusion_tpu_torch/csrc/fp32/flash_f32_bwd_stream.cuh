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
// Design. The gradients are one computation with the axes' roles swapped
// (as the bf16 kernel above 256, flash_attention_wide_bwd_sm90.cuh): a
// cluster pair owns 64 rows and walks tiles of 64 columns of the other axis,
//   dq    (rows queries): X = Q K^T, Y = dO V^T, dQ += dS K;
//   dk dv (rows keys):    X = K Q^T, Y = V dO^T, dK += dS^T Q, dV += P^T dO.
// The head dim is split across a cluster of two blocks on two SMs
// (__cluster_dims__(2, 1, 1)): block r owns columns [r DH, (r + 1) DH), DH =
// DP / 2, of every operand and output, streams only those, and computes X
// and Y over them; the pair swaps the partials (pair_swap.cuh: each
// consumer thread stores its own from its registers into the other block's
// shared memory with st.async, counted on that block's barrier) and both
// blocks add the same two values. dk and dv are one pair a 64-key tile holding both
// accumulators: S^T is computed once and K and Q streamed once a tile, four
// products where one block a role took five. Nothing stays resident: the
// kernels up to 256 keep the row operand's terms resident at 1 KB a column,
// which at DH 256 would take 256 KB; a cluster of four keeping them at DH =
// 128 a block would swap three partials a tile.
// One block of a producer warpgroup and two consumer warpgroups:
//  - the producer's thread 0 streams, for each column tile, the hi / lo
//    terms of the row and column operands of X in chunks of kCW columns of
//    d, then those of Y, then the transposed terms of the accumulations' B
//    operands (K^T for dq; Q^T, then dO^T for dk / dv: positions permuted
//    within groups of 8) in pieces of kVR rows of d a consumer, through a
//    ring of four 32 KB slots of full / empty mbarriers (chunks of 32
//    columns, pieces of 32 rows; for dq two 64 KB slots, chunks of 64,
//    measured no faster: `PERF.md` §6, PR 29); thread 32 is the swap's
//    helper; warp 2
//    (dk / dv) writes the column tile's lse (times log2 e; past Lq +1e30)
//    and delta into shared memory once a tile (two entries with full /
//    empty barriers), not a global read per logit.
//  - the two consumers split X and Y by columns (32 each: m64n32k8 SS, each
//    chunk into a fresh accumulator added in registers: no chain longer
//    than 3 x 32 / 8 = 12), push them, and pull the other block's; they form
//    T in registers (dq: dS; dk / dv: dS^T and P^T), write its hi / lo
//    terms into the shared T tiles (64 x 64 each, positions in the
//    transposed terms' order), meet at a named barrier, and each runs
//    acc[:, its DH / 2 columns] += T B over the pieces (m64nkVRk8 SS, three
//    passes, each piece into a fresh accumulator): dq one accumulator,
//    dk / dv two (DH / 2 registers a thread at DH 256).
//    The tiles are software-pipelined around the swap: tile j's X and Y
//    are pushed, tile j - 1's accumulations run, and only then are tile j's
//    partials pulled; a named barrier before T is written keeps a consumer
//    from overwriting the tile the other still reads.
//  - masks (ANY: the position masks of pos_tile.cuh, two offset segments a
//    side, valid_len and causal by position, judged per (query tile, key
//    tile) pair by tile_pair whichever axis the rows are and per logit on a
//    partly visible pair (K3 / K4's causal: offsets 0); an fp32 bias read
//    per logit from global memory, a logit at -1e30 or -inf hidden, segment
//    ids walking the tile range [lo, hi] of mask.cuh at (64, 64) and
//    compared per logit) and dbias (dq: dS for every tile of the block's
//    rows, zeros where a tile is skipped, written by block 0 of the pair),
//    as the bf16 kernel above 256. Both blocks of a pair skip the same
//    tiles and meet at a cluster barrier before they exit.
// Shared memory a block (slots, T tiles, the swap's `in`, the statistics,
// the barriers, the alignment): dq 198,792 B, dk / dv 231,560 B at both
// widths.

#pragma once

#include "../mask.cuh"
#include "../pair_swap.cuh"
#include "../sm90.cuh"
#include "flash_f32_bwd.cuh"

namespace fdsd::f32bwd {

namespace stream {
constexpr int kBR = 64, kBC = 64;  // rows a block pair, columns a tile
constexpr int kThreads = 384, kConsumers = 256, kConsumerRegs = 232;
constexpr int kChunk = 64 * 128;  // 64 rows x 32 fp32 columns (128 B)
constexpr int kTTerm = 2 * kChunk;  // one term of a 64 x 64 T tile
constexpr int kXBytes = 2 * kBR * kBC * 4;  // the partials X, Y of a tile
constexpr int kStatEntries = 2;  // the column tiles' lse, delta (dk / dv)

template <int DP, bool DKV>
struct Cfg {
  static constexpr int kDH = DP / 2;  // this block's columns
  static constexpr int kSlotBytes = 32768;
  static constexpr int kCW = kSlotBytes / 1024;  // columns of d a chunk
  static constexpr int kXSlots = kDH / kCW;       // chunks a product
  static constexpr int kVMax = kCW;               // rows of d a piece, at most
  static constexpr int kVSlots = (kDH / 2 + kVMax - 1) / kVMax;
  static constexpr int kVR = kDH / 2 / kVSlots;  // rows of d a piece
  static constexpr int kVChunk = kVR * 128;      // kVR rows x 32 positions
  static constexpr int kTOff = 0;  // T: dS (dS^T) hi, lo; dk / dv P^T hi, lo
  static constexpr int kTBytes = (DKV ? 2 : 1) * 2 * kTTerm;
  static constexpr int kInOff = kTOff + kTBytes;
  static constexpr int kStatOff = kInOff + kXBytes;
  static constexpr int kStatBytes = kStatEntries * 2 * kBC * 4;
  static constexpr int kSlotOff = kStatOff + kStatBytes;
  // as many slots as fit beside the rest, at most 4; the barriers: full,
  // empty per slot; the statistics' full, empty per entry; the swap's
  static constexpr int kFixedBars = 2 * kStatEntries + kSwapBars;
  static constexpr int kRoom =
      kSmemLimit - kSlotOff - 8 * kFixedBars - 1024;
  static constexpr int kFit = kRoom / (kSlotBytes + 16);
  static constexpr int kSlots = kFit < 4 ? kFit : 4;
  static constexpr int kBarOff = kSlotOff + kSlots * kSlotBytes;
  static constexpr int kBars = 2 * kSlots + kFixedBars;
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
  static_assert(kSlots >= 2, "a pipelined ring");
  static_assert(kDH % kCW == 0 && kVR % 8 == 0 && 8 * kVChunk <= kSlotBytes,
                "width");
};
}  // namespace stream

// The maps: ta1 / ta2 the row operand's terms of X / Y, tb1 / tb2 the
// column operand's (boxes of 32 columns x 64 rows), tt1 / tt2 the
// transposed terms of the B operands of dQ or dK / of dV (boxes of 32
// positions x kVR rows of d). DKV: rows keys, dk and dv; else dq.
template <int DP, bool ANY, bool DKV>
__global__ void __cluster_dims__(2, 1, 1)
    __launch_bounds__(stream::kThreads, 1)
    flash_bwd_f32_stream_kernel(const __grid_constant__ CUtensorMap ta1,
                                const __grid_constant__ CUtensorMap ta2,
                                const __grid_constant__ CUtensorMap tb1,
                                const __grid_constant__ CUtensorMap tb2,
                                const __grid_constant__ CUtensorMap tt1,
                                const __grid_constant__ CUtensorMap tt2,
                                const __grid_constant__ Params p) {
  using namespace stream;
  using C = Cfg<DP, DKV>;
  constexpr int DH = C::kDH, kVR = C::kVR, kCW = C::kCW;
  constexpr int kTerm = 64 * kCW * 4;  // one term of a chunk's operand
  constexpr int kAccs = DKV ? 2 : 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t t_s = base + C::kTOff;
  const uint32_t in_s = base + C::kInOff;
  const uint32_t slot_s = base + C::kSlotOff;
  float* stats = reinterpret_cast<float*>(smem + C::kStatOff);
  const uint32_t full0 = base + C::kBarOff, empty0 = full0 + 8 * C::kSlots;
  const uint32_t sfull0 = empty0 + 8 * C::kSlots;
  const uint32_t sempty0 = sfull0 + 8 * kStatEntries;
  const uint32_t xbars = sempty0 + 8 * kStatEntries;  // the swap's

  const int tid = threadIdx.x;
  const int c0 = static_cast<int>(s9::cluster_rank()) * DH;  // first column
  const int tile = static_cast<int>(blockIdx.x) / 2;
  const int bh = tile / p.n_tiles;
  int rt = tile % p.n_tiles;
  constexpr bool rows_q = !DKV;
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

  // The column tiles the pair visits, the same walk in both blocks and
  // every role: those tile_pair does not skip, the query tile and the key
  // tile passed as such whichever axis the rows are; the range whose
  // segment ids overlap this row tile's, less the disjoint tiles.
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
  // the first column tile from ct on that the pair visits; ct_end if none
  auto visible = [&](int ct) {
    while (ct < ct_end && pair(ct) == 0) ++ct;
    return ct;
  };

  if (tid == 0) {
    for (int s = 0; s < C::kSlots; ++s) {
      s9::mbar_init(full0 + 8 * s, 1);
      s9::mbar_init(empty0 + 8 * s, kConsumers);
    }
    for (int s = 0; s < kStatEntries; ++s) {
      s9::mbar_init(sfull0 + 8 * s, 32);
      s9::mbar_init(sempty0 + 8 * s, kConsumers);
    }
    fdsd::swap_init(xbars, kConsumers);
    s9::mbar_init_fence();
  } else if (tid == 32) {
    s9::prefetch_tensormap(&ta1);
    s9::prefetch_tensormap(&ta2);
    s9::prefetch_tensormap(&tb1);
    s9::prefetch_tensormap(&tb2);
    s9::prefetch_tensormap(&tt1);
    if (DKV) s9::prefetch_tensormap(&tt2);
  }
  // both blocks' barriers are set up before either arrives on the other's
  s9::cluster_sync();

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
    if (tid == 0) {
      // X and Y of column tile ct: the row and column operands' terms,
      // chunk by chunk of this block's columns
      auto load_xy = [&](int ct) {
        for (int pass = 0; pass < 2; ++pass) {
          const CUtensorMap* ta = pass == 0 ? &ta1 : &ta2;
          const CUtensorMap* tb = pass == 0 ? &tb1 : &tb2;
          for (int c = 0; c < C::kXSlots; ++c) {
            const uint32_t full = full0 + 8 * slot;
            const uint32_t sb = slot_s + slot * C::kSlotBytes;
            s9::mbar_wait(empty0 + 8 * slot, phase ^ 1);
            s9::mbar_expect_tx(full, 4 * kTerm);
            for (int term = 0; term < 2; ++term)
              for (int half = 0; half < kCW / 32; ++half) {
                const int x = c0 + kCW * c + 32 * half;
                const uint32_t at = sb + term * kTerm + half * kChunk;
                s9::tma_load_4d(at, ta, full, x, r0_tile, h, b + term * p.B);
                s9::tma_load_4d(at + 2 * kTerm, tb, full, x, ct * kBC, h,
                                b + term * p.B);
              }
            next();
          }
        }
      };
      // the B operands' transposed terms of column tile ct, piece by piece
      auto load_b = [&](int ct) {
        for (int a = 0; a < kAccs; ++a) {
          const CUtensorMap* tt = a == 0 ? &tt1 : &tt2;
          for (int j = 0; j < C::kVSlots; ++j) {
            const uint32_t full = full0 + 8 * slot;
            const uint32_t sb = slot_s + slot * C::kSlotBytes;
            s9::mbar_wait(empty0 + 8 * slot, phase ^ 1);
            s9::mbar_expect_tx(full, 8 * C::kVChunk);
            for (int w = 0; w < 2; ++w)
              for (int term = 0; term < 2; ++term)
                for (int kc = 0; kc < 2; ++kc)
                  s9::tma_load_4d(
                      sb + (2 * w + term) * 2 * C::kVChunk + kc * C::kVChunk,
                      tt, full, ct * kBC + 32 * kc,
                      c0 + DH / 2 * w + kVR * j, h, b + term * p.B);
            next();
          }
        }
      };
      // tile j's X and Y, then tile j - 1's B: the consumers' order
      int prev = -1;
      for (int ct = visible(ct_begin); ct < ct_end; ct = visible(ct + 1)) {
        load_xy(ct);
        if (prev >= 0) load_b(prev);
        prev = ct;
      }
      if (prev >= 0) load_b(prev);
    } else if (tid == 32) {
      int tiles = 0;
      for (int ct = visible(ct_begin); ct < ct_end; ct = visible(ct + 1))
        ++tiles;
      fdsd::swap_helper(xbars, tiles, kXBytes);
    } else if (DKV && tid >= 64 && tid < 96) {
      // the column tile's lse (times log2 e) and delta, two queries a lane
      const int lane = tid - 64;
      const long long bq = static_cast<long long>(bh) * p.Lq;
      int e = 0;
      uint32_t ph = 0;
      for (int ct = visible(ct_begin); ct < ct_end; ct = visible(ct + 1)) {
        s9::mbar_wait(sempty0 + 8 * e, ph ^ 1);
        float* st = stats + e * 2 * kBC;
        for (int u = 0; u < 2; ++u) {
          const int lc = lane + 32 * u, q = ct * kBC + lc;
          st[lc] = (q < p.Lq ? p.lse[bq + q] : kPadLse) * kLog2e;
          st[kBC + lc] = q < p.Lq ? p.delta[bq + q] : 0.f;
        }
        s9::mbar_arrive(sfull0 + 8 * e);
        if (++e == kStatEntries) {
          e = 0;
          ph ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    // ----------------------------------------------------------- consumers
    s9::reg_alloc<kConsumerRegs>();
    const int ci = tid - 128;
    const int cw = ci / 128;  // columns 32cw .. of a tile, DH/2 cw .. of d
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl0 = 16 * warp + g, rl1 = rl0 + 8;  // tile rows
    const int r0 = r0_tile + rl0, r1 = r0_tile + rl1;
    const long long bq = static_cast<long long>(bh) * p.Lq;
    float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;  // dq: of the rows
    if (rows_q) {
      lse0 = (r0 < p.Lq ? p.lse[bq + r0] : kPadLse) * kLog2e;
      lse1 = (r1 < p.Lq ? p.lse[bq + r1] : kPadLse) * kLog2e;
      dl0 = r0 < p.Lq ? p.delta[bq + r0] : 0.f;
      dl1 = r1 < p.Lq ? p.delta[bq + r1] : 0.f;
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
    // dq: the positions of this thread's two query rows (rows past Lq are
    // not written, whatever they see)
    int qpos0 = 0, qpos1 = 0;
    if (masked && rows_q) {
      qpos0 = pos_of(r0, offs.q0, offs.q1, p.pos.seg_q);
      qpos1 = pos_of(r1, offs.q0, offs.q1, p.pos.seg_q);
    }
    // dbias (dq): block 0 of the pair writes every tile of its rows once,
    // the skipped ones as 0
    float* db = ANY && rows_q && has_bias && p.ds != nullptr && c0 == 0
                    ? p.ds + bq * p.Lk
                    : nullptr;
    auto write_db = [&](const float (&x)[16], int col0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1;
          const int col = col0 + 32 * cw + 8 * j + 2 * t + (e & 1);
          if (row < p.Lq && col < p.Lk)
            db[static_cast<long long>(row) * p.Lk + col] = x[4 * j + e];
        }
    };
    auto zeros = [&](int from, int to) {
      if (db == nullptr) return;
      float z[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) z[e] = 0.f;
      for (int ct = from; ct < to; ++ct) write_db(z, ct * kBC);
    };

    const uint32_t in_read = xbars + 24;
    fdsd::SwapPeer peer(in_s, xbars);
    // dQ or dK (o[0]) and dV (o[1]): output columns DH/2 cw + kVR j ..
    float o[kAccs][C::kVSlots][kVR / 2];
#pragma unroll
    for (int a = 0; a < kAccs; ++a)
#pragma unroll
      for (int j = 0; j < C::kVSlots; ++j)
#pragma unroll
        for (int i = 0; i < kVR / 2; ++i) o[a][j][i] = 0.f;
    float x[16], y[16], part[16];  // X, Y of this thread's 32 columns

    // X (or Y) over this block's chunks of d, each chunk into a fresh
    // accumulator: row operand hi, lo, then column operand hi, lo (this
    // consumer's 32 columns at rows 32cw ..) in the slot.
    auto product = [&](float (&acc)[16]) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      for (int cc = 0; cc < C::kXSlots; ++cc) {
        const uint32_t sb = slot_s + slot * C::kSlotBytes;
        s9::mbar_wait(full0 + 8 * slot, phase);
        s9::fence_regs(part);
        s9::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kCW / 8; ++kk) {
          const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
          const uint32_t ka = sb + 2 * kTerm + off + cw * 32 * 128;
          const uint64_t qh = s9::smem_desc(sb + off, 16, 1024, 1);
          const uint64_t ql = s9::smem_desc(sb + kTerm + off, 16, 1024, 1);
          const uint64_t kh = s9::smem_desc(ka, 16, 1024, 1);
          const uint64_t kl = s9::smem_desc(ka + kTerm, 16, 1024, 1);
          s9::wgmma_tf32_ss<32>(part, ql, kh, kk > 0);
          s9::wgmma_tf32_ss<32>(part, qh, kl, 1);
          s9::wgmma_tf32_ss<32>(part, qh, kh, 1);
        }
        s9::wgmma_commit();
        s9::wgmma_wait<0>();
        s9::fence_regs(part);
        s9::mbar_arrive(empty0 + 8 * slot);
        next();
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] += part[i];
      }
    };
    // acc a [:, DH/2 cw + kVR j ..] += T B over the pieces, three passes
    // each, into a fresh accumulator added in registers; T a's terms at
    // t_s + 2 kTTerm a (dq / dk: dS or dS^T; dv: P^T).
    auto accumulate = [&]() {
#pragma unroll
      for (int a = 0; a < kAccs; ++a)
#pragma unroll
        for (int j = 0; j < C::kVSlots; ++j) {
          const uint32_t sb =
              slot_s + slot * C::kSlotBytes + cw * 4 * C::kVChunk;
          const uint32_t ta = t_s + a * 2 * kTTerm;
          float piece[kVR / 2];
          s9::mbar_wait(full0 + 8 * slot, phase);
          s9::fence_regs(piece);
          s9::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBC / 8; ++kk) {
            const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
            const uint32_t voff = (kk / 4) * C::kVChunk + (kk % 4) * 32;
            const uint64_t th = s9::smem_desc(ta + off, 16, 1024, 1);
            const uint64_t tl = s9::smem_desc(ta + kTTerm + off, 16, 1024, 1);
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
          for (int i = 0; i < kVR / 2; ++i) o[a][j][i] += piece[i];
        }
    };

    int prev = -1, se = 0;
    uint32_t sph = 0;  // the statistics' entry and parity
    int ct = visible(ct_begin);
    zeros(0, ct);
    while (ct < ct_end) {
      product(x);
      product(y);
      // this tile's partials into the other block's `in`: float4 f of
      // consumer thread ci at (f 256 + ci) 16
      peer.wait_free(xbars);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        s9::st_async_v4(peer.in + (f * 256 + ci) * 16, x[4 * f],
                        x[4 * f + 1], x[4 * f + 2], x[4 * f + 3], peer.full);
        s9::st_async_v4(peer.in + ((4 + f) * 256 + ci) * 16, y[4 * f],
                        y[4 * f + 1], y[4 * f + 2], y[4 * f + 3], peer.full);
      }
      if (prev >= 0) accumulate();  // the last tile's, while the copy runs
      // the other block's partials: own + other in block 0, other + own in
      // block 1, the same two values, the same sum
      peer.wait_full(xbars);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float4 u = s9::ld_shared_v4(in_s + (f * 256 + ci) * 16);
        const float4 w = s9::ld_shared_v4(in_s + ((4 + f) * 256 + ci) * 16);
        x[4 * f] += u.x;
        x[4 * f + 1] += u.y;
        x[4 * f + 2] += u.z;
        x[4 * f + 3] += u.w;
        y[4 * f] += w.x;
        y[4 * f + 1] += w.y;
        y[4 * f + 2] += w.z;
        y[4 * f + 3] += w.w;
      }
      s9::mbar_arrive(in_read);

      // P = exp(logit - lse), selected to 0 where hidden; dS = P (dP -
      // delta) in place of Y, P (dk / dv) in place of X.
      const int state = pair(ct);
      const int c0t = ct * kBC;
      const float* cst = stats + se * 2 * kBC;  // dk / dv: of the columns
      if (DKV) s9::mbar_wait(sfull0 + 8 * se, sph);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1;
          const int lc = 32 * cw + 8 * j + 2 * t + (e & 1);  // tile column
          const int col = c0t + lc;
          const int qi = rows_q ? row : col, ki = rows_q ? col : row;
          float lg = x[4 * j + e];
          bool visible_ = qi < p.Lq && ki < p.Lk;
          if (has_bias) {  // logit = scale * s + bias, in fp32
            lg = fmaf(lg, p.scale,
                      visible_ ? fdsd::load_bias(p.m, bias_base, qi, ki)
                               : 0.f);
            visible_ = visible_ && lg > kNegInf;
          }
          if (state == 2 && visible_) {  // a partly visible pair: by position
            const int qpos = rows_q ? (e < 2 ? qpos0 : qpos1)
                                    : pos_of(qi, offs.q0, offs.q1,
                                             p.pos.seg_q);
            visible_ = pos_sees(p, offs, qpos, ki);
          }
          if (has_seg)
            visible_ = visible_ && col < n_cols &&
                       col_ids[col] == (e < 2 ? rid0 : rid1);
          const float lq = rows_q ? (e < 2 ? lse0 : lse1) : cst[lc];
          const float dq_ = rows_q ? (e < 2 ? dl0 : dl1) : cst[kBC + lc];
          float pv = s9::exp2_approx(fmaf(lg, c, -lq));
          if (!visible_) pv = 0.f;  // selected
          x[4 * j + e] = pv;
          y[4 * j + e] = pv * (y[4 * j + e] - dq_);
        }
      if (DKV) {
        s9::mbar_arrive(sempty0 + 8 * se);
        if (++se == kStatEntries) {
          se = 0;
          sph ^= 1;
        }
      }
      if (db != nullptr) write_db(y, c0t);
      const int cn = visible(ct + 1);
      zeros(ct + 1, cn);

      // T's hi / lo terms (dS, or dS^T; and P^T) into this group's half of
      // the T tiles: column 2t of a group of 8 at position t, 2t + 1 at
      // t + 4 (the transposed terms' order); row r, positions 4u .. 4u + 3
      // of a chunk at unit u ^ (r % 8), once the other consumer has read
      // the last tile's T.
      s9::named_barrier_sync(1, kConsumers);
#pragma unroll
      for (int a = 0; a < kAccs; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e < 2 ? rl0 : rl1, u = 2 * j + (e & 1);
            const float v = a == 0 ? y[4 * j + e] : x[4 * j + e];
            unsigned char* at = smem + C::kTOff + a * 2 * kTTerm +
                                cw * kChunk + r * 128 +
                                ((u ^ (r & 7)) << 4) + 4 * t;
            const uint32_t hi = s9::to_tf32(v);
            *reinterpret_cast<uint32_t*>(at) = hi;
            *reinterpret_cast<uint32_t*>(at + kTTerm) =
                s9::to_tf32(v - __uint_as_float(hi));
          }
      s9::fence_proxy_async();  // T's stores, visible to wgmma
      s9::named_barrier_sync(2, kConsumers);
      prev = ct;
      ct = cn;
    }
    if (prev >= 0) accumulate();
    zeros(ct_end, n_ct);

    // Epilogue: dq / dk times scale, dv as it is, fp32 through the output's
    // strides, this block's columns; rows past L and columns past d are not
    // written.
#pragma unroll
    for (int a = 0; a < kAccs; ++a) {
      const float mul = a == 1 ? 1.f : p.scale;
      float* out = a == 1 ? p.o1 : p.o0;
      const long long* os = a == 1 ? p.o1s : p.o0s;
      float* ob = out + b * os[0] + h * os[1] + r0 * os[2];
#pragma unroll
      for (int j = 0; j < C::kVSlots; ++j)
#pragma unroll
        for (int i = 0; i < kVR / 8; ++i) {
          const int col = c0 + DH / 2 * cw + kVR * j + 8 * i + 2 * t;
          if (col >= p.d) continue;
          if (r0 < n_rows)
            *reinterpret_cast<float2*>(ob + col) = make_float2(
                o[a][j][4 * i] * mul, o[a][j][4 * i + 1] * mul);
          if (r1 < n_rows)
            *reinterpret_cast<float2*>(ob + 8 * os[2] + col) = make_float2(
                o[a][j][4 * i + 2] * mul, o[a][j][4 * i + 3] * mul);
        }
    }
  }
  // neither block leaves while the other may still copy into it
  s9::cluster_sync();
}

// K3 (p.o1 null) or K4 at padded width DP (384, 512) on terms the pre-pass
// has written into the workspace w; p.n_tiles is set here. Two blocks (one
// cluster) a 64-row tile; K4's dk and dv in one launch.
template <int DP, bool ANY, bool DKV>
cudaError_t run_stream_role(const Work& w, Params p, cudaStream_t s) {
  using C = stream::Cfg<DP, DKV>;
  const int la = DKV ? p.Lk : p.Lq, lb = DKV ? p.Lq : p.Lk;
  CUtensorMap ta1, ta2, tb1, tb2, tt1, tt2;
  cudaError_t err = rows_map(&ta1, DKV ? w.k : w.q, p.B, p.H, la, p.d, 32,
                             stream::kBR);
  if (err == cudaSuccess)
    err = rows_map(&ta2, DKV ? w.v : w.g, p.B, p.H, la, p.d, 32, stream::kBR);
  if (err == cudaSuccess)
    err = rows_map(&tb1, DKV ? w.q : w.k, p.B, p.H, lb, p.d, 32, stream::kBC);
  if (err == cudaSuccess)
    err = rows_map(&tb2, DKV ? w.g : w.v, p.B, p.H, lb, p.d, 32, stream::kBC);
  if (err == cudaSuccess)
    err = transposed_map(&tt1, DKV ? w.qt : w.kt, p.B, p.H, lb, p.d, 32,
                         C::kVR);
  if (err == cudaSuccess)
    err = transposed_map(&tt2, DKV ? w.gt : w.kt, p.B, p.H, lb, p.d, 32,
                         C::kVR);
  if (err != cudaSuccess) return err;
  p.n_tiles = (la + stream::kBR - 1) / stream::kBR;
  return s9::launch_kernel(flash_bwd_f32_stream_kernel<DP, ANY, DKV>,
                           2 * p.B * p.H * p.n_tiles, stream::kThreads,
                           C::kSmemBytes, s, ta1, ta2, tb1, tb2, tt1, tt2, p);
}

template <int DP, bool ANY>
cudaError_t run_stream(const Work& w, Params p, cudaStream_t s) {
  return p.o1 != nullptr ? run_stream_role<DP, ANY, true>(w, p, s)
                         : run_stream_role<DP, ANY, false>(w, p, s);
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
