// The fp32 flash backward's kernels (flash_f32_bwd.cu holds the dispatch and
// the C entries): K3 (dq) and K4 (dk, dv) on fp32 inputs on the tensor
// cores, up to DP = 128 on one block a tile (flash_bwd_dq_f32_kernel,
// flash_bwd_dkv_f32_kernel; their design notes are in flash_f32_bwd.cu),
// and at the padded widths DP = 160, 192, 224, 256 (the head dim rounded up
// to 32, the columns past d read as TMA's zeros and not written) on a
// cluster of two blocks, below: without a mask, masked (causal, K6 / K7's
// position masks) and ANY (a bias with dbias, segment ids, causal; AnyMasks).
// Each width above 128, and the ANY form at every width, is instantiated in
// its own flash_f32_bwd_w*.cu, so that the build compiles them in
// parallel.
//
// Replaces, for fp32 q, k, v, dO at those head dims, the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel
// under Precision.HIGHEST (tiny-SD's UNet in fp32: d = 160 five times a
// step at `channel: 320`, 192 once at `channel: 96`). The contract and the
// numerical plan are those of the kernels up to 128 (flash_f32_bwd.cu): the
// three-term TF32 split on all five products, P and dS fp32 and selected to
// 0 where hidden, query rows past Lq at lse = +1e30, dq, dk, dv fp32, the
// same split pre-pass and workspace.
//
// What bounds them on the H100: operations, as up to 128 (3 Lq Lk d
// multiply-adds for dq, 4 for dk/dv, three TF32 passes each at 495 TFLOP/s).
// What stopped the kernels up to 128 here is shared memory: their block keeps
// both terms of a 64-row operand resident (Q and dO for dq, K and V for
// dk/dv), 1 KB a column, 256 KB at DP = 256 against the 232,448 B a block may
// take. Of the two ways around that wall, streaming that operand in column
// chunks would reload it from L2 for every key (query) tile: 2 x 64 x DP x 8
// bytes a tile beside 18 x 64 x BK x DP operations, ~0.03 B/FLOP, more L2
// traffic than the tensor cores' rate leaves room for. So these kernels split
// the columns instead, across a cluster of two blocks on two SMs, which
// doubles the shared memory: block r of the pair owns columns [r DP/2,
// (r + 1) DP/2) of every operand and output (DH = DP / 2 <= 128, the widths
// the kernels up to 128 run at), keeps only its half of the resident
// operand, streams only its half of the others, and accumulates only its
// half of dQ (or dK and dV). S = Q K^T and dP = dO V^T (S^T and dP^T for
// dk/dv) reduce over all of d: each block computes its partial over its DH
// columns (a chain of 3 DH / 8 <= 48 wgmmas, as up to 128), the pair swaps
// partials through shared memory (Exchange below), and each adds the other's
// to its own in registers, rounded to nearest; both add the same two values,
// so both hold the same S and dP, and the same P and dS. Every other product
// is one block's own: dQ += dS K (dV += P^T dO, dK += dS^T Q) over its DH
// columns, each tile into a fresh accumulator (chunks of DH / 2 columns for
// dk/dv), so no chain of wgmmas into one accumulator is longer than 48.
//
// The swap is what the design is built around. On the H100 a consumer
// warpgroup that stores its partials into the other SM's shared memory
// (st.shared::cluster) and signals it with remote mbarrier arrivals stalls
// on those remote operations for about as long as the tile's tensor-core
// work. So no consumer thread touches the other SM: it writes
// its partials into its own shared memory, and one thread of the producer
// warpgroup moves them with the bulk-copy unit (cp.async.bulk
// shared::cluster, completion counted on the receiver's mbarrier) and does
// the cross-block signalling. The tiles are software-pipelined around it:
// the next tile's S and dP run on the tensor cores while this tile's
// partials come in and its P and dS are formed, and the next tile's
// partials are pushed while this tile's dQ (dK) runs; a tile's partials are
// copied out of registers before any other wgmma is in flight (ptxas
// serializes the wgmmas when a live accumulator is read meanwhile).
//
// Each block is one producer warpgroup (TMA in thread 0, the swap in thread
// 32) and one consumer warpgroup:
//  - dq: 64 queries a block pair; Q and dO halves resident; K and V halves
//    in tiles of 32 keys (16 above DP 192) on ring A, the K^T half on ring B.
//  - dk/dv: 64 keys a block pair, the keys as wgmma's M; K and V halves
//    resident; Q and dO halves in tiles of 32 queries (16 above DP 160) on
//    ring A, Q^T and dO^T halves on ring B.
// Ring A runs a tile ahead of ring B, with two stages where they fit (the
// partials then pushed from the stage just read, handed back to the
// producer once copied), else one and a push buffer of its own; ring B has
// two stages where they fit. Shared memory a block (tiles, the other's
// partials, the push buffer): dq 221,184 / 229,376 / 208,896 / 221,184 B,
// dk/dv 221,184 / 204,800 / 208,896 / 212,992 B at DP = 160 / 192 / 224 /
// 256.

#pragma once

#include <type_traits>

#include "../mask.cuh"
#include "../pos_tile.cuh"
#include "../sm90.cuh"

namespace fdsd::f32bwd {

namespace s9 = fdsd::sm90;
using fdsd::PosArgs;
using fdsd::pos_bounds;
using fdsd::pos_of;
using fdsd::pos_pair;

constexpr float kNegInf = -1e30f;
constexpr float kPadLse = 1e30f;  // query rows past Lq: P = 0
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPasses = 3;  // TF32 wgmma passes per product
static_assert(kPasses == 3, "lo hi + hi lo + hi hi");
constexpr int kProducerRegs = 40;
constexpr int kSmemLimit = 232448;

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
  int d;               // the head dim; columns d .. DP - 1 are padding
  long long o0s[3], o1s[3];   // outputs' (batch, head, seq) strides
  float scale;
  PosArgs pos;  // MASKED only; null offsets read as 0
  MaskArgs m;   // ANY only: the fp32 bias and the segment arrays
  float* ds;    // ANY dq with a bias: dbias = dS, fp32 (B, H, Lq, Lk)
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

// The masks of the ANY form, each where the launch asks for it (p.m): an
// fp32 bias read through its strides and added to the scaled logit (a logit
// at -1e30 or -inf is hidden); segment ids (a pair of different ids is
// hidden, a tile pair whose id ranges are disjoint, or whose other tile is
// outside the block's range [lo, hi] of mask.cuh, skipped, at the kernel's
// own tiles); and for K3 dbias = dS, fp32 (B, H, Lq, Lk), every tile of the
// block's rows written once (zeros where a tile is skipped), so the caller
// reduces it without a memset. Without ANY every member folds away.
template <bool ANY>
struct AnyMasks {
  bool has_bias = false, has_seg = false;
  int b = 0;
  long long bias_base = 0;

  __device__ __forceinline__ AnyMasks(const Params& p, int bb, int h) {
    if (ANY) {
      has_bias = p.m.bias != nullptr;
      has_seg = p.m.q_ids != nullptr;
      b = bb;
      bias_base = has_bias ? bb * p.m.bs[0] + h * p.m.bs[1] : 0;
    }
  }
  // exp(logit) = exp2(logit c): the scale folded in, or, with a bias, the
  // logits scaled first
  __device__ __forceinline__ float c(const Params& p) const {
    return ANY && has_bias ? kLog2e : p.scale * kLog2e;
  }
  // the bias at (row, key); 0 past Lq or Lk, and without a bias. The
  // kernels fetch a tile's before waiting for its operands, so that the
  // loads' latency hides behind the copy and the products.
  __device__ __forceinline__ float bias(const Params& p, int row,
                                        int key) const {
    return ANY && has_bias && row < p.Lq && key < p.Lk
               ? load_bias(p.m, bias_base, row, key)
               : 0.f;
  }
  // scale s + b (b from bias()), in fp32; s as it is without a bias
  __device__ __forceinline__ float logit(const Params& p, float s,
                                         float b) const {
    return ANY && has_bias ? fmaf(s, p.scale, b) : s;
  }
  __device__ __forceinline__ int q_id(const Params& p, int row) const {
    return ANY && has_seg && row < p.Lq ? p.m.q_ids[b * p.Lq + row] : -1;
  }
  __device__ __forceinline__ int k_id(const Params& p, int key) const {
    return ANY && has_seg && key < p.Lk ? p.m.kv_ids[b * p.Lk + key] : -2;
  }
  // is the logit x (bias added) of a pair with ids qid, kid visible?
  __device__ __forceinline__ bool sees(float x, int qid, int kid) const {
    return (!has_bias || x > kNegInf) && (!has_seg || qid == kid);
  }
  // tile_pair, and the segment ids: 0 skip, 1 visible, 2 masked per logit;
  // over_q: the grid runs over query tiles (K3), else over key tiles (K4)
  __device__ __forceinline__ int pair(const Params& p, const Offsets& o,
                                      bool masked, int q0, int bq, int k0,
                                      int bk, bool over_q) const {
    int state = tile_pair(p, o, masked, q0, bq, k0, bk);
    if (ANY && has_seg && state != 0) {
      const int qi = q0 / bq, ki = k0 / bk;
      const int nq = (p.Lq + bq - 1) / bq, nk = (p.Lk + bk - 1) / bk;
      const int self = over_q ? b * nq + qi : b * nk + ki;
      const int other = over_q ? ki : qi;
      state = other >= p.m.lo[self] && other <= p.m.hi[self] &&
                      seg_overlap(p.m.q_bounds + 2 * (b * nq + qi),
                                  p.m.kv_bounds + 2 * (b * nk + ki))
                  ? 2
                  : 0;
    }
    return state;
  }
  // this (b, h)'s dbias, or null
  __device__ __forceinline__ float* dbias(const Params& p, int bh) const {
    return ANY && has_bias && p.ds != nullptr
               ? p.ds + static_cast<long long>(bh) * p.Lq * p.Lk
               : nullptr;
  }
  __device__ __forceinline__ void write(const Params& p, float* db, int row,
                                        int key, float v) const {
    if (row < p.Lq && key < p.Lk)
      db[static_cast<long long>(row) * p.Lk + key] = v;
  }
  // zeros at this thread's rows r0, r1 and keys k0 + 8j + 2t + u of a
  // skipped tile of BK keys
  template <int BK>
  __device__ __forceinline__ void write_zeros(const Params& p, float* db,
                                              int r0, int r1, int k0,
                                              int t) const {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        write(p, db, r0, k0 + 8 * j + 2 * t + u, 0.f);
        write(p, db, r1, k0 + 8 * j + 2 * t + u, 0.f);
      }
  }
};

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
// `during()` runs while the first chunk is on the tensor cores; it must touch
// no wgmma accumulator (ptxas serializes the wgmmas if it does).
struct Nothing {
  __device__ __forceinline__ void operator()() const {}
};
template <typename TT, int DP, int NC, int KS, typename During = Nothing>
__device__ __forceinline__ void accum_rs(float (&acc)[DP / 2],
                                         const uint32_t (&hi)[KS][4],
                                         const uint32_t (&lo)[KS][4],
                                         uint32_t ts,
                                         During during = During()) {
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
    if (nc == 0) during();
    s9::wgmma_wait<0>();
    s9::fence_regs(part);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[nc * (NC / 2) + i] += part[i];
  }
}

// The split terms in the workspace (flash_f32_bwd.cu's carve): q, k, v, dO
// as (2, B, H, L, d) rows, k^T (2, B, H, d, Lk8), q^T and dO^T
// (2, B, H, d, Lq8).
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

// A rows map (d, L, H, 2B) with a box of W columns x `rows`.
inline cudaError_t rows_map(CUtensorMap* map, const float* terms, int B,
                            int H, int L, int d, int W, int rows) {
  const long long st[3] = {static_cast<long long>(H) * L * d,
                           static_cast<long long>(L) * d, d};
  return s9::make_map(map, terms, d, L, H, 2 * B, st, W, rows,
                      W == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
                      CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// A transposed map (L8, d, H, 2B) with a box of W positions x `rows` rows of
// d; rows past d are zeros.
inline cudaError_t transposed_map(CUtensorMap* map, const float* terms,
                                  int B, int H, int L, int d, int W,
                                  int rows) {
  const int l8 = (L + 7) / 8 * 8;
  const long long st[3] = {static_cast<long long>(H) * d * l8,
                           static_cast<long long>(d) * l8, l8};
  return s9::make_map(map, terms, l8, d, H, 2 * B, st, W, rows,
                      W == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
                      CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// ------------------------------------------------ the block pair's exchange
// Each block of the pair hands its partial S and dP (or S^T and dP^T) of a
// tile to the other and adds the other's to its own, both blocks adding the
// same two values. The consumer warpgroup touches only its own block's
// shared memory and barriers: it writes its partials (push) and reads the
// other's (pull) from its slot `in`; one thread of the producer warpgroup
// (exchange_helper) copies them into the other block's `in` with the
// bulk-copy unit and does the cross-block signalling, so that no consumer
// thread waits on the other SM. With two ring-A stages (FOLD) the partials
// are pushed into the stage the tile's S and dP were computed from, now
// read, and the helper hands the stage back to the producer once copied;
// with one, they go to a buffer `out` of their own and the consumers hand
// the stage back as soon as S and dP are done. A slot holds N floats a
// consumer thread as N / 4 float4, float4 f of thread i at
// (f * 128 + i) * 16. Barriers: xfull (the other's copy landed in `in`:
// expect_tx by the helper, complete_tx by the copy), xfree (the other
// block read what the last copy put there; one remote arrival), out_ready
// (the 128 consumer threads pushed), in_read (the 128 consumer threads
// pulled), out_free (the copy read `out`). Pushes and pulls alternate, tile
// by tile.
constexpr int kExchangeBars = 5;

template <bool FOLD>
struct Exchange {
  uint32_t in_s, out_s, xfull, out_ready, in_read, out_free, i16;
  uint32_t pushes = 0, pulls = 0;  // parities

  __device__ __forceinline__ Exchange(uint32_t in, uint32_t out,
                                      uint32_t bars, int i)
      : in_s(in + i * 16),
        out_s(out + i * 16),
        xfull(bars),
        out_ready(bars + 16),
        in_read(bars + 24),
        out_free(bars + 32),
        i16(i * 16) {}

  // This block's partials a, b (N / 2 floats each) into the ring stage at
  // `stage` (FOLD), or into `out` once the last copy has read it.
  template <int N>
  __device__ __forceinline__ void push(const float (&a)[N / 2],
                                       const float (&b)[N / 2],
                                       uint32_t stage) {
    static_assert(N % 8 == 0, "float4");
    uint32_t at = stage + i16;
    if constexpr (!FOLD) {
      s9::mbar_wait(out_free, pushes ^ 1);
      pushes ^= 1;
      at = out_s;
    }
#pragma unroll
    for (int f = 0; f < N / 8; ++f) {
      s9::st_shared_v4(at + f * 2048, a[4 * f], a[4 * f + 1], a[4 * f + 2],
                       a[4 * f + 3]);
      s9::st_shared_v4(at + (N / 8 + f) * 2048, b[4 * f], b[4 * f + 1],
                       b[4 * f + 2], b[4 * f + 3]);
    }
    s9::fence_proxy_async();  // the bulk copy reads through the async proxy
    s9::mbar_arrive(out_ready);
  }

  // a += the other block's a, b += its b, once its copy has landed.
  template <int N>
  __device__ __forceinline__ void pull(float (&a)[N / 2], float (&b)[N / 2]) {
    s9::mbar_wait(xfull, pulls);
#pragma unroll
    for (int f = 0; f < N / 8; ++f) {
      const float4 u = s9::ld_shared_v4(in_s + f * 2048);
      const float4 w = s9::ld_shared_v4(in_s + (N / 8 + f) * 2048);
      a[4 * f] += u.x;
      a[4 * f + 1] += u.y;
      a[4 * f + 2] += u.z;
      a[4 * f + 3] += u.w;
      b[4 * f] += w.x;
      b[4 * f + 1] += w.y;
      b[4 * f + 2] += w.z;
      b[4 * f + 3] += w.w;
    }
    s9::mbar_arrive(in_read);
    pulls ^= 1;
  }
};

// The exchange's barriers at `bars` (xfull, xfree, out_ready, in_read,
// out_free), set up by one thread.
__device__ __forceinline__ void exchange_init(uint32_t bars) {
  s9::mbar_init(bars, 1);
  s9::mbar_init(bars + 8, 1);
  s9::mbar_init(bars + 16, 128);
  s9::mbar_init(bars + 24, 128);
  s9::mbar_init(bars + 32, 1);
}

// The helper's side of the exchange, for `tiles` tiles of `bytes` a slot:
// for each, arm xfull, wait for the push, wait until the other block read
// the last copy, copy the partials into its `in` (FOLD: from ring-A stage
// t mod SA at a_s + stage_bytes stage, handed back to the producer on its
// empty barrier at aempty0 once read; else from `out`, freed once read),
// and, once the consumers pulled, tell the other block it may copy again.
template <int SA, bool FOLD>
__device__ __forceinline__ void exchange_helper(uint32_t in_s, uint32_t out_s,
                                                uint32_t bars, int tiles,
                                                uint32_t bytes, uint32_t a_s,
                                                uint32_t stage_bytes,
                                                uint32_t aempty0) {
  const uint32_t xfull = bars, xfree = bars + 8, out_ready = bars + 16,
                 in_read = bars + 24, out_free = bars + 32;
  const uint32_t peer = s9::cluster_rank() ^ 1u;
  const uint32_t peer_in = s9::cluster_map(in_s, peer);
  const uint32_t peer_full = s9::cluster_map(xfull, peer);
  const uint32_t peer_free = s9::cluster_map(xfree, peer);
  uint32_t ph = 0;
  int st = 0;
  for (int t = 0; t < tiles; ++t) {
    s9::mbar_expect_tx(xfull, bytes);  // this tile's copy from the other
    s9::mbar_wait(out_ready, ph);
    s9::mbar_wait_cluster(xfree, ph ^ 1);
    s9::bulk_copy_cluster(peer_in, FOLD ? a_s + st * stage_bytes : out_s,
                          bytes, peer_full);
    s9::bulk_commit();
    s9::bulk_wait_read();
    if (FOLD) {
      s9::mbar_arrive(aempty0 + 8 * st);
      if (++st == SA) st = 0;
    } else {
      s9::mbar_arrive(out_free);
    }
    s9::mbar_wait(in_read, ph);
    s9::mbar_arrive_cluster(peer_free);
    ph ^= 1;
  }
}

// A ring position: stage and the parity of its current round.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int S>
  __device__ __forceinline__ Ring next() const {
    Ring r = *this;
    if (++r.stage == S) {
      r.stage = 0;
      r.phase ^= 1;
    }
    return r;
  }
};

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

template <int DP, bool MASKED, bool ANY = false>
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
  const AnyMasks<ANY> any(p, b, h);
  const int n_kt = (p.Lk + BK - 1) / BK;
  auto pair = [&](int kt) {
    return any.pair(p, off, masked, q0, BQ, kt * BK, BK, true);
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
    const int qid0 = any.q_id(p, r0), qid1 = any.q_id(p, r1);
    const float c_any = any.c(p);  // exp2 factor of the logits (ANY)
    float* db = any.dbias(p, bh);
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
      if (state == 0) {  // dbias: a skipped tile is written as zeros
        if (ANY && db != nullptr)
          any.template write_zeros<BK>(p, db, r0, r1, kt * BK, t);
        continue;
      }
      const int k0 = kt * BK;
      const uint32_t ks = a_s + stage * C::kAStage;
      const uint32_t vs = ks + 2 * TK::kBytes;
      float bias_v[BK / 2];  // ANY: this tile's bias, fetched before the wait
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bias_v[4 * j + e] =
              any.bias(p, e < 2 ? r0 : r1, k0 + 8 * j + 2 * t + (e & 1));
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
      const bool check = k0 + BK > p.Lk || state == 2 || any.has_bias;
      uint32_t dh[BK / 8][4], dlo[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int qrow = e < 2 ? r0 : r1;
          // ANY: logit = scale s + bias, in fp32
          const float x = any.logit(p, s[4 * j + e], bias_v[4 * j + e]);
          float pr = s9::exp2_approx(
              fmaf(x, ANY ? c_any : c, -(e < 2 ? lse0 : lse1)));
          if (check) {
            bool visible = key < p.Lk;
            if (masked && state == 2)
              visible = visible && pos_sees(p, off, e < 2 ? qpos0 : qpos1,
                                            key);
            if (ANY)
              visible = visible &&
                        any.sees(x, e < 2 ? qid0 : qid1, any.k_id(p, key));
            if (!visible) pr = 0.f;  // selected, not multiplied
          }
          const float ds = pr * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
          if (ANY && db != nullptr) any.write(p, db, qrow, key, ds);
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

template <int DP, bool MASKED, bool ANY = false>
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
  const AnyMasks<ANY> any(p, b, h);
  const int n_qt = (p.Lq + BQ - 1) / BQ;
  auto pair = [&](int qt) {
    return any.pair(p, off, masked, qt * BQ, BQ, kb0, BKEY, false);
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
    const float c = any.c(p);  // exp(x scale) = exp2(x c); bias: log2 e
    const float* lse_b = p.lse + static_cast<long long>(bh) * p.Lq;
    const float* dl_b = p.delta + static_cast<long long>(bh) * p.Lq;
    const int kid0 = any.k_id(p, key0), kid1 = any.k_id(p, key1);
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
      int qpos[BQ / 4], qid[BQ / 4];
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
          qid[2 * j + u] = any.q_id(p, col);
        }
      float bias_v[BQ / 2];  // ANY: this tile's bias, fetched before the wait
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bias_v[4 * j + e] =
              any.bias(p, q0 + 8 * j + 2 * t + (e & 1), e < 2 ? key0 : key1);
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
                         kb0 + BKEY > p.Lk || any.has_bias;
      uint32_t ph[BQ / 8][4], pl[BQ / 8][4], sh[BQ / 8][4], sl[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = 2 * j + (e & 1);
          const int key = e < 2 ? key0 : key1;
          const int query = q0 + 8 * j + 2 * t + (e & 1);
          // ANY: logit = scale s + bias, in fp32
          const float x = any.logit(p, st[4 * j + e], bias_v[4 * j + e]);
          float pr = s9::exp2_approx(fmaf(x, c, -lq[u]));
          if (check) {
            bool visible = query < p.Lq && key < p.Lk;
            if (masked && state == 2)
              visible = visible && pos_sees(p, off, qpos[u], key);
            if (ANY)
              visible = visible && any.sees(x, qid[u], e < 2 ? kid0 : kid1);
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

// ------------------------------------------- K3 above 128: a pair of blocks
template <int DP>
struct DqWideCfg {
  static constexpr int kDH = DP / 2;  // this block's columns
  static constexpr int kBQ = 64, kBK = DP <= 192 ? 32 : 16;
  static constexpr int kThreads = 256;  // producer + one consumer
  static constexpr int kConsumerRegs = 240;
  using TQ = Tile<kBQ, kDH>;   // Q, dO (resident)
  using TK = Tile<kBK, kDH>;   // K, V
  using TKT = Tile<kDH, kBK>;  // K^T: this block's rows of d
  static constexpr int kGOff = 2 * TQ::kBytes;
  static constexpr int kAOff = 4 * TQ::kBytes;  // ring A: K, V per stage
  static constexpr int kAStage = 4 * TK::kBytes;
  static constexpr int kBStage = 2 * TKT::kBytes;  // ring B: K^T
  static constexpr int kXBytes = 128 * kBK * 4;  // S, dP partials
  // ring A two stages where they fit, the partials pushed from the stage
  // just read (FOLD); else one, and a buffer `out` of their own; ring B
  // two stages where they fit
  static constexpr int kStagesA =
      kAOff + 2 * kAStage + kBStage + kXBytes + 8 * 12 + 1024 <= kSmemLimit
          ? 2
          : 1;
  static constexpr bool kFold = kStagesA == 2;
  static constexpr int kOutBytes = kFold ? 0 : kXBytes;
  static constexpr int kStagesB =
      kAOff + kStagesA * kAStage + 2 * kBStage + kXBytes + kOutBytes +
                  8 * 14 + 1024 <=
              kSmemLimit
          ? 2
          : 1;
  static constexpr int kBOff = kAOff + kStagesA * kAStage;
  static constexpr int kInOff = kBOff + kStagesB * kBStage;
  static constexpr int kOutOff = kInOff + kXBytes;
  static constexpr int kBarOff = kOutOff + kOutBytes;
  // Q / dO full; A full, empty per stage; B full, empty per stage; the
  // exchange's
  static constexpr int kBars =
      1 + 2 * kStagesA + 2 * kStagesB + kExchangeBars;
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
  static_assert(DP % 32 == 0 && DP > 128 && DP <= 256, "head dim");
};

template <int DP, bool MASKED, bool ANY = false>
__global__ void __cluster_dims__(2, 1, 1)
    __launch_bounds__(DqWideCfg<DP>::kThreads, 1)
    flash_bwd_dq_f32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tg,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tkt,
                                 const __grid_constant__ Params p) {
  using C = DqWideCfg<DP>;
  using TQ = typename C::TQ;
  using TK = typename C::TK;
  using TKT = typename C::TKT;
  constexpr int DH = C::kDH, BQ = C::kBQ, BK = C::kBK, SA = C::kStagesA,
                SB = C::kStagesB;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (s9::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, g_s = base + C::kGOff;
  const uint32_t a_s = base + C::kAOff, b_s = base + C::kBOff;
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t afull0 = q_full + 8, aempty0 = afull0 + 8 * SA;
  const uint32_t bfull0 = aempty0 + 8 * SA, bempty0 = bfull0 + 8 * SB;
  const uint32_t xbars = bempty0 + 8 * SB;  // the exchange's

  const int tid = threadIdx.x;
  const int c0 = static_cast<int>(s9::cluster_rank()) * DH;  // first column
  const int tile = blockIdx.x / 2;
  const int bh = tile / p.n_tiles;
  int qt = tile % p.n_tiles;
  if (MASKED && p.pos.causal) qt = p.n_tiles - 1 - qt;  // long rows first
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * BQ;

  if (tid == 0) {
    s9::mbar_init(q_full, 1);
    for (int s = 0; s < SA; ++s) {
      s9::mbar_init(afull0 + 8 * s, 1);
      // the exchange helper once copied (FOLD), else the consumers
      s9::mbar_init(aempty0 + 8 * s, C::kFold ? 1 : 128);
    }
    for (int s = 0; s < SB; ++s) {
      s9::mbar_init(bfull0 + 8 * s, 1);
      s9::mbar_init(bempty0 + 8 * s, 128);
    }
    exchange_init(xbars);
    s9::mbar_init_fence();
  } else if (tid == 32) {  // fetch the descriptors while barriers are set up
    s9::prefetch_tensormap(&tq);
    s9::prefetch_tensormap(&tg);
    s9::prefetch_tensormap(&tk);
    s9::prefetch_tensormap(&tv);
    s9::prefetch_tensormap(&tkt);
  }
  // both blocks' barriers are set up before either arrives on the other's
  s9::cluster_sync();

  const bool masked = MASKED && (p.pos.causal || p.pos.has_valid);
  const Offsets off(p.pos, masked);
  const AnyMasks<ANY> any(p, b, h);
  const int n_kt = (p.Lk + BK - 1) / BK;
  auto pair = [&](int kt) {
    return any.pair(p, off, masked, q0, BQ, kt * BK, BK, true);
  };
  // the first key tile from kt on that this query tile sees; n_kt if none
  auto visible = [&](int kt) {
    while (kt < n_kt && pair(kt) == 0) ++kt;
    return kt;
  };

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      s9::mbar_expect_tx(q_full, 4 * TQ::kBytes);
      TQ::load(q_s, &tq, q_full, c0, q0, h, b, p.B);
      TQ::load(g_s, &tg, q_full, c0, q0, h, b, p.B);
      // ring A (K, V) runs a tile ahead of ring B (K^T): the consumer
      // reads A(t + 1) before B(t)
      Ring ra, rb;
      int ka = visible(0), kb = ka;
      auto load_a = [&]() {
        const uint32_t afull = afull0 + 8 * ra.stage;
        const uint32_t as = a_s + ra.stage * C::kAStage;
        s9::mbar_wait(aempty0 + 8 * ra.stage, ra.phase ^ 1);
        s9::mbar_expect_tx(afull, 4 * TK::kBytes);
        TK::load(as, &tk, afull, c0, ka * BK, h, b, p.B);
        TK::load(as + 2 * TK::kBytes, &tv, afull, c0, ka * BK, h, b, p.B);
        ra = ra.template next<SA>();
        ka = visible(ka + 1);
      };
      if (ka < n_kt) load_a();
      while (kb < n_kt) {
        if (ka < n_kt) load_a();
        const uint32_t bfull = bfull0 + 8 * rb.stage;
        s9::mbar_wait(bempty0 + 8 * rb.stage, rb.phase ^ 1);
        s9::mbar_expect_tx(bfull, 2 * TKT::kBytes);
        TKT::load(b_s + rb.stage * C::kBStage, &tkt, bfull, kb * BK, c0, h,
                  b, p.B);
        rb = rb.template next<SB>();
        kb = visible(kb + 1);
      }
    } else if (tid == 32) {
      int tiles = 0;
      for (int kt = visible(0); kt < n_kt; kt = visible(kt + 1)) ++tiles;
      exchange_helper<SA, C::kFold>(base + C::kInOff, base + C::kOutOff,
                                    xbars, tiles, C::kXBytes, a_s,
                                    C::kAStage, aempty0);
    }
    __syncwarp();
  } else {
    // ------------------------------------------------------------ consumer
    s9::reg_alloc<C::kConsumerRegs>();
    const int i = tid - 128;
    const int warp = i / 32, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
    const float c = p.scale * kLog2e;  // exp(x scale) = exp2(x c)
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
    const int qid0 = any.q_id(p, r0), qid1 = any.q_id(p, r1);
    const float c_any = any.c(p);  // exp2 factor of the logits (ANY)
    // dbias: both blocks hold the same dS; the first writes it, every tile
    // of its rows once, the skipped ones as zeros
    float* db = c0 == 0 ? any.dbias(p, bh) : nullptr;
    auto zeros = [&](int from, int to) {
      if (ANY && db != nullptr)
        for (int kz = from; kz < to; ++kz)
          any.template write_zeros<BK>(p, db, r0, r1, kz * BK, t);
    };
    Exchange<C::kFold> x(base + C::kInOff, base + C::kOutOff, xbars, i);
    float dq[DH / 2];
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) dq[j] = 0.f;
    // The partials of a tile, out of the accumulators (sv, dpv: wgmma writes
    // s and dp only, and nothing reads them while a wgmma is in flight)
    float s[BK / 2], dp[BK / 2], sv[BK / 2], dpv[BK / 2];
    auto take = [&]() {
      s9::fence_regs(s);
      s9::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        sv[j] = s[j];
        dpv[j] = dp[j];
      }
    };

    // This block's partial S = Q K^T and dP = dO V^T of the tile on ring
    // stage `st`, over its columns, three passes each, issued into (s, dp)
    // and committed, not waited for.
    auto issue_sdp = [&](int st) {
      const uint32_t ks = a_s + st * C::kAStage;
      const uint32_t vs = ks + 2 * TK::kBytes;
      s9::fence_regs(s);
      s9::fence_regs(dp);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        const uint64_t qh = TQ::desc(q_s, kk, 0);
        const uint64_t ql = TQ::desc(q_s + TQ::kBytes, kk, 0);
        const uint64_t kh = TK::desc(ks, kk, 0);
        const uint64_t kl = TK::desc(ks + TK::kBytes, kk, 0);
        s9::wgmma_tf32_ss<BK>(s, ql, kh, kk > 0);
        s9::wgmma_tf32_ss<BK>(s, qh, kl, 1);
        s9::wgmma_tf32_ss<BK>(s, qh, kh, 1);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        const uint64_t gh = TQ::desc(g_s, kk, 0);
        const uint64_t gl = TQ::desc(g_s + TQ::kBytes, kk, 0);
        const uint64_t vh = TK::desc(vs, kk, 0);
        const uint64_t vl = TK::desc(vs + TK::kBytes, kk, 0);
        s9::wgmma_tf32_ss<BK>(dp, gl, vh, kk > 0);
        s9::wgmma_tf32_ss<BK>(dp, gh, vl, 1);
        s9::wgmma_tf32_ss<BK>(dp, gh, vh, 1);
      }
      s9::wgmma_commit();
    };

    s9::mbar_wait(q_full, 0);  // also when no tile is visited: TMA is done
    // The tiles are software-pipelined across the pair's exchange: the
    // next tile's S and dP run on the tensor cores while this tile's
    // partials come in and its P and dS are formed, and this block pushes
    // the next tile's partials while this tile's dQ runs.
    Ring ra, rb;  // the ring positions of this tile's K, V and its K^T
    int kt = visible(0);
    zeros(0, kt);
    if (kt < n_kt) {
      s9::mbar_wait(afull0, 0);
      issue_sdp(0);
      s9::wgmma_wait<0>();
      take();
      if (!C::kFold) s9::mbar_arrive(aempty0);  // K and V are read
      x.template push<BK>(sv, dpv, a_s);
    }
    while (kt < n_kt) {
      const int kn = visible(kt + 1);
      zeros(kt + 1, kn);
      const Ring rn = ra.template next<SA>();
      if (kn < n_kt) {
        s9::mbar_wait(afull0 + 8 * rn.stage, rn.phase);
        issue_sdp(rn.stage);
      }
      const int k0 = kt * BK;
      float bias_v[BK / 2];  // ANY: this tile's bias, fetched before the pull
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bias_v[4 * j + e] =
              any.bias(p, e < 2 ? r0 : r1, k0 + 8 * j + 2 * t + (e & 1));
      x.template pull<BK>(sv, dpv);  // S and dP over all of d

      // P = exp(scale s - lse), selected to 0 where the key is hidden or
      // past Lk; dS = P (dP - delta), split into the TF32 A fragments of
      // dS K: accumulator columns (2t, 2t + 1) of a k-step are the
      // fragment's (t, t + 4).
      const int state = masked || ANY ? pair(kt) : 1;
      const bool check = k0 + BK > p.Lk || state == 2 || any.has_bias;
      uint32_t dh[BK / 8][4], dlo[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int qrow = e < 2 ? r0 : r1;
          // ANY: logit = scale s + bias, in fp32
          const float lg = any.logit(p, sv[4 * j + e], bias_v[4 * j + e]);
          float pr = s9::exp2_approx(
              fmaf(lg, ANY ? c_any : c, -(e < 2 ? lse0 : lse1)));
          if (check) {
            bool seen = key < p.Lk;
            if (masked && state == 2)
              seen = seen && pos_sees(p, off, e < 2 ? qpos0 : qpos1, key);
            if (ANY)
              seen = seen && any.sees(lg, e < 2 ? qid0 : qid1,
                                      any.k_id(p, key));
            if (!seen) pr = 0.f;  // selected, not multiplied
          }
          const float ds = pr * (dpv[4 * j + e] - (e < 2 ? dl0 : dl1));
          if (ANY && db != nullptr) any.write(p, db, qrow, key, ds);
          const int f = (e & 1) * 2 + (e >> 1);  // fragment register
          split_frag(ds, dh[j][f], dlo[j][f]);
        }
      }
      if (kn < n_kt) {
        s9::wgmma_wait<0>();  // the next tile's S and dP
        take();
        if (!C::kFold) s9::mbar_arrive(aempty0 + 8 * rn.stage);
      }

      // dQ += this tile's dS K over this block's columns (its rows of K^T,
      // K-major, permuted as dS), into a fresh accumulator; the next
      // tile's partials go to the other block meanwhile.
      s9::mbar_wait(bfull0 + 8 * rb.stage, rb.phase);
      const uint32_t ts = b_s + rb.stage * C::kBStage;
      float part[DH / 2];
      s9::fence_regs(part);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t th = TKT::desc(ts, kk, 0);
        const uint64_t tl = TKT::desc(ts + TKT::kBytes, kk, 0);
        s9::wgmma_tf32_rs<DH>(part, dlo[kk], th, kk > 0);
        s9::wgmma_tf32_rs<DH>(part, dh[kk], tl, 1);
        s9::wgmma_tf32_rs<DH>(part, dh[kk], th, 1);
      }
      s9::wgmma_commit();
      if (kn < n_kt)
        x.template push<BK>(sv, dpv, a_s + rn.stage * C::kAStage);
      s9::wgmma_wait<0>();
      s9::fence_regs(part);
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) dq[j] += part[j];
      s9::mbar_arrive(bempty0 + 8 * rb.stage);  // K^T of this stage is read
      kt = kn;
      ra = rn;
      rb = rb.template next<SB>();
    }

    // Epilogue: this block's columns of dQ * scale through dq's strides;
    // rows past Lq and columns past d not written.
    float* ob = p.o0 + b * p.o0s[0] + h * p.o0s[1];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (col >= p.d) continue;
      if (r0 < p.Lq)
        *reinterpret_cast<float2*>(ob + r0 * p.o0s[2] + col) =
            make_float2(dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
      if (r1 < p.Lq)
        *reinterpret_cast<float2*>(ob + r1 * p.o0s[2] + col) =
            make_float2(dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
    }
  }
  // neither block leaves while the other may still arrive on its barriers
  s9::cluster_sync();
}

// ---------------------------------------- K4 above 128: a pair of blocks
template <int DP>
struct DkvWideCfg {
  static constexpr int kDH = DP / 2;  // this block's columns
  static constexpr int kBKey = 64;    // keys per block pair
  static constexpr int kBQ = DP <= 160 ? 32 : 16;  // queries per tile
  static constexpr int kThreads = 256;  // producer + one consumer
  static constexpr int kConsumerRegs = 240;
  static constexpr int kNC = kDH / 2;  // output columns per accumulator
  using TK = Tile<kBKey, kDH>;  // K, V (resident)
  using TQ = Tile<kBQ, kDH>;    // Q, dO
  using TQT = Tile<kDH, kBQ>;   // Q^T, dO^T: this block's rows of d
  static constexpr int kVOff = 2 * TK::kBytes;
  static constexpr int kAOff = 4 * TK::kBytes;  // ring A: Q, dO per stage
  static constexpr int kAStage = 4 * TQ::kBytes;
  static constexpr int kBStage = 4 * TQT::kBytes;  // ring B: Q^T, dO^T
  static constexpr int kXBytes = 128 * kBQ * 4;  // S^T, dP^T partials
  // ring A two stages where they fit, the partials pushed from the stage
  // just read (FOLD); else one, and a buffer `out` of their own; ring B
  // two stages where they fit
  static constexpr int kStagesA =
      kAOff + 2 * kAStage + kBStage + kXBytes + 8 * 12 + 1024 <= kSmemLimit
          ? 2
          : 1;
  static constexpr bool kFold = kStagesA == 2;
  static constexpr int kOutBytes = kFold ? 0 : kXBytes;
  static constexpr int kStagesB =
      kAOff + kStagesA * kAStage + 2 * kBStage + kXBytes + kOutBytes +
                  8 * 14 + 1024 <=
              kSmemLimit
          ? 2
          : 1;
  static constexpr int kBOff = kAOff + kStagesA * kAStage;
  static constexpr int kInOff = kBOff + kStagesB * kBStage;
  static constexpr int kOutOff = kInOff + kXBytes;
  static constexpr int kBarOff = kOutOff + kOutBytes;
  // K / V full; A full, empty per stage; B full, empty per stage; the
  // exchange's
  static constexpr int kBars =
      1 + 2 * kStagesA + 2 * kStagesB + kExchangeBars;
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
  static_assert(DP % 32 == 0 && DP > 128 && DP <= 256, "head dim");
};

template <int DP, bool MASKED, bool ANY = false>
__global__ void __cluster_dims__(2, 1, 1)
    __launch_bounds__(DkvWideCfg<DP>::kThreads, 1)
    flash_bwd_dkv_f32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tg,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tqt,
                                  const __grid_constant__ CUtensorMap tgt,
                                  const __grid_constant__ Params p) {
  using C = DkvWideCfg<DP>;
  using TK = typename C::TK;
  using TQ = typename C::TQ;
  using TQT = typename C::TQT;
  constexpr int DH = C::kDH, BQ = C::kBQ, BKEY = C::kBKey,
                SA = C::kStagesA, SB = C::kStagesB, NC = C::kNC;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (s9::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + C::kVOff;
  const uint32_t a_s = base + C::kAOff, b_s = base + C::kBOff;
  const uint32_t kv_full = base + C::kBarOff;
  const uint32_t afull0 = kv_full + 8, aempty0 = afull0 + 8 * SA;
  const uint32_t bfull0 = aempty0 + 8 * SA, bempty0 = bfull0 + 8 * SB;
  const uint32_t xbars = bempty0 + 8 * SB;  // the exchange's

  const int tid = threadIdx.x;
  const int c0 = static_cast<int>(s9::cluster_rank()) * DH;  // first column
  const int tile = blockIdx.x / 2;
  const int bh = tile / p.n_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int kb0 = (tile % p.n_tiles) * BKEY;

  if (tid == 0) {
    s9::mbar_init(kv_full, 1);
    for (int s = 0; s < SA; ++s) {
      s9::mbar_init(afull0 + 8 * s, 1);
      // the exchange helper once copied (FOLD), else the consumers
      s9::mbar_init(aempty0 + 8 * s, C::kFold ? 1 : 128);
    }
    for (int s = 0; s < SB; ++s) {
      s9::mbar_init(bfull0 + 8 * s, 1);
      s9::mbar_init(bempty0 + 8 * s, 128);
    }
    exchange_init(xbars);
    s9::mbar_init_fence();
  } else if (tid == 32) {  // fetch the descriptors while barriers are set up
    s9::prefetch_tensormap(&tq);
    s9::prefetch_tensormap(&tg);
    s9::prefetch_tensormap(&tk);
    s9::prefetch_tensormap(&tv);
    s9::prefetch_tensormap(&tqt);
    s9::prefetch_tensormap(&tgt);
  }
  s9::cluster_sync();

  const bool masked = MASKED && (p.pos.causal || p.pos.has_valid);
  const Offsets off(p.pos, masked);
  const AnyMasks<ANY> any(p, b, h);
  const int n_qt = (p.Lq + BQ - 1) / BQ;
  auto pair = [&](int qt) {
    return any.pair(p, off, masked, qt * BQ, BQ, kb0, BKEY, false);
  };
  // the first query tile from qt on that sees this key block; n_qt if none
  auto visible = [&](int qt) {
    while (qt < n_qt && pair(qt) == 0) ++qt;
    return qt;
  };

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      s9::mbar_expect_tx(kv_full, 4 * TK::kBytes);
      TK::load(k_s, &tk, kv_full, c0, kb0, h, b, p.B);
      TK::load(v_s, &tv, kv_full, c0, kb0, h, b, p.B);
      // ring A (Q, dO) runs a tile ahead of ring B (Q^T, dO^T): the
      // consumer reads A(t + 1) before B(t)
      Ring ra, rb;
      int qa = visible(0), qb = qa;
      auto load_a = [&]() {
        const uint32_t afull = afull0 + 8 * ra.stage;
        const uint32_t as = a_s + ra.stage * C::kAStage;
        s9::mbar_wait(aempty0 + 8 * ra.stage, ra.phase ^ 1);
        s9::mbar_expect_tx(afull, 4 * TQ::kBytes);
        TQ::load(as, &tq, afull, c0, qa * BQ, h, b, p.B);
        TQ::load(as + 2 * TQ::kBytes, &tg, afull, c0, qa * BQ, h, b, p.B);
        ra = ra.template next<SA>();
        qa = visible(qa + 1);
      };
      if (qa < n_qt) load_a();
      while (qb < n_qt) {
        if (qa < n_qt) load_a();
        const uint32_t bfull = bfull0 + 8 * rb.stage;
        const uint32_t bs = b_s + rb.stage * C::kBStage;
        s9::mbar_wait(bempty0 + 8 * rb.stage, rb.phase ^ 1);
        s9::mbar_expect_tx(bfull, 4 * TQT::kBytes);
        TQT::load(bs, &tqt, bfull, qb * BQ, c0, h, b, p.B);
        TQT::load(bs + 2 * TQT::kBytes, &tgt, bfull, qb * BQ, c0, h, b,
                  p.B);
        rb = rb.template next<SB>();
        qb = visible(qb + 1);
      }
    } else if (tid == 32) {
      int tiles = 0;
      for (int qt = visible(0); qt < n_qt; qt = visible(qt + 1)) ++tiles;
      exchange_helper<SA, C::kFold>(base + C::kInOff, base + C::kOutOff,
                                    xbars, tiles, C::kXBytes, a_s,
                                    C::kAStage, aempty0);
    }
    __syncwarp();
  } else {
    // ------------------------------------------------------------ consumer
    s9::reg_alloc<C::kConsumerRegs>();
    const int i = tid - 128;
    const int warp = i / 32, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int key0 = kb0 + 16 * warp + g, key1 = key0 + 8;
    const float c = any.c(p);  // exp(x scale) = exp2(x c); bias: log2 e
    const float* lse_b = p.lse + static_cast<long long>(bh) * p.Lq;
    const float* dl_b = p.delta + static_cast<long long>(bh) * p.Lq;
    const int kid0 = any.k_id(p, key0), kid1 = any.k_id(p, key1);
    Exchange<C::kFold> x(base + C::kInOff, base + C::kOutOff, xbars, i);
    float dk[DH / 2], dv[DH / 2];
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) dk[j] = dv[j] = 0.f;
    // The partials of a tile, out of the accumulators (sv, dv: wgmma writes
    // st and dpt only, and nothing reads them while a wgmma is in flight)
    float st[BQ / 2], dpt[BQ / 2], sv[BQ / 2], dpv[BQ / 2];
    auto take = [&]() {
      s9::fence_regs(st);
      s9::fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        sv[j] = st[j];
        dpv[j] = dpt[j];
      }
    };

    // This block's partial S^T = K Q^T and dP^T = V dO^T of the tile on
    // ring A stage `sa`, over its columns, the keys as M, three passes
    // each, issued into (st, dpt) and committed, not waited for.
    auto issue_sdp = [&](int sa) {
      const uint32_t qs = a_s + sa * C::kAStage;
      const uint32_t gs = qs + 2 * TQ::kBytes;
      s9::fence_regs(st);
      s9::fence_regs(dpt);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        const uint64_t kh = TK::desc(k_s, kk, 0);
        const uint64_t kl = TK::desc(k_s + TK::kBytes, kk, 0);
        const uint64_t qh = TQ::desc(qs, kk, 0);
        const uint64_t ql = TQ::desc(qs + TQ::kBytes, kk, 0);
        s9::wgmma_tf32_ss<BQ>(st, kl, qh, kk > 0);
        s9::wgmma_tf32_ss<BQ>(st, kh, ql, 1);
        s9::wgmma_tf32_ss<BQ>(st, kh, qh, 1);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        const uint64_t vh = TK::desc(v_s, kk, 0);
        const uint64_t vl = TK::desc(v_s + TK::kBytes, kk, 0);
        const uint64_t gh = TQ::desc(gs, kk, 0);
        const uint64_t gl = TQ::desc(gs + TQ::kBytes, kk, 0);
        s9::wgmma_tf32_ss<BQ>(dpt, vl, gh, kk > 0);
        s9::wgmma_tf32_ss<BQ>(dpt, vh, gl, 1);
        s9::wgmma_tf32_ss<BQ>(dpt, vh, gh, 1);
      }
      s9::wgmma_commit();
    };

    s9::mbar_wait(kv_full, 0);  // also when no tile is visited: TMA is done
    // Pipelined as dq is: the next tile's S^T and dP^T run while this
    // tile's partials come in and its P^T is formed; the next tile's
    // partials go out while this tile's dK runs.
    Ring ra, rb;
    int qt = visible(0);
    if (qt < n_qt) {
      s9::mbar_wait(afull0, 0);
      issue_sdp(0);
      s9::wgmma_wait<0>();
      take();
      if (!C::kFold) s9::mbar_arrive(aempty0);  // Q and dO are read
      x.template push<BQ>(sv, dpv, a_s);
    }
    while (qt < n_qt) {
      const int qn = visible(qt + 1);
      const Ring ran = ra.template next<SA>();
      if (qn < n_qt) {
        s9::mbar_wait(afull0 + 8 * ran.stage, ran.phase);
        issue_sdp(ran.stage);
      }
      // lse (times log2 e), delta and position of this thread's query
      // columns 8j + 2t + u
      const int q0 = qt * BQ;
      float lq[BQ / 4], dlt[BQ / 4];
      int qpos[BQ / 4], qid[BQ / 4];
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
          qid[2 * j + u] = any.q_id(p, col);
        }
      float bias_v[BQ / 2];  // ANY: this tile's bias, fetched before the pull
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bias_v[4 * j + e] =
              any.bias(p, q0 + 8 * j + 2 * t + (e & 1), e < 2 ? key0 : key1);
      x.template pull<BQ>(sv, dpv);  // S^T and dP^T over all of d

      // P^T in registers (kept in sv), selected to 0 where hidden or past
      // the ends, split into the TF32 A fragments of P^T dO; then dS^T the
      // same for dS^T Q, in the same fragment registers.
      const int state = masked || ANY ? pair(qt) : 1;
      const bool check = q0 + BQ > p.Lq || state == 2 ||
                         kb0 + BKEY > p.Lk || any.has_bias;
      uint32_t fh[BQ / 8][4], fl[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = 2 * j + (e & 1);
          const int key = e < 2 ? key0 : key1;
          const int query = q0 + 8 * j + 2 * t + (e & 1);
          // ANY: logit = scale s + bias, in fp32
          const float lg = any.logit(p, sv[4 * j + e], bias_v[4 * j + e]);
          float pr = s9::exp2_approx(fmaf(lg, c, -lq[u]));
          if (check) {
            bool seen = query < p.Lq && key < p.Lk;
            if (masked && state == 2)
              seen = seen && pos_sees(p, off, qpos[u], key);
            if (ANY)
              seen = seen && any.sees(lg, qid[u], e < 2 ? kid0 : kid1);
            if (!seen) pr = 0.f;  // selected, not multiplied
          }
          sv[4 * j + e] = pr;
          const int f = (e & 1) * 2 + (e >> 1);  // fragment register
          split_frag(pr, fh[j][f], fl[j][f]);
        }
      }
      if (qn < n_qt) {
        s9::wgmma_wait<0>();  // the next tile's S^T and dP^T
        s9::fence_regs(st);
        s9::fence_regs(dpt);
        if (!C::kFold) s9::mbar_arrive(aempty0 + 8 * ran.stage);
      }

      // dV += P^T dO and dK += dS^T Q over this block's columns, NC at a
      // time (its rows of dO^T and Q^T, K-major, permuted as P^T); the next
      // tile's partials go to the other block while dK runs.
      const uint32_t qts = b_s + rb.stage * C::kBStage;
      s9::mbar_wait(bfull0 + 8 * rb.stage, rb.phase);
      accum_rs<TQT, DH, NC>(dv, fh, fl, qts + 2 * TQT::kBytes);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = (e & 1) * 2 + (e >> 1);
          const float ds =
              sv[4 * j + e] * (dpv[4 * j + e] - dlt[2 * j + (e & 1)]);
          split_frag(ds, fh[j][f], fl[j][f]);
        }
      }
      if (qn < n_qt) take();
      accum_rs<TQT, DH, NC>(dk, fh, fl, qts, [&]() {
        if (qn < n_qt)
          x.template push<BQ>(sv, dpv, a_s + ran.stage * C::kAStage);
      });
      s9::mbar_arrive(bempty0 + 8 * rb.stage);  // Q^T and dO^T are read
      qt = qn;
      ra = ran;
      rb = rb.template next<SB>();
    }

    // Epilogue: this block's columns of dK * scale and dV through their
    // strides; keys past Lk and columns past d are not written.
    float* kb = p.o0 + b * p.o0s[0] + h * p.o0s[1];
    float* vb = p.o1 + b * p.o1s[0] + h * p.o1s[1];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = c0 + 8 * j + 2 * t;
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
  s9::cluster_sync();
}

// ------------------------------------------------------------- launchers
// K3 / K4 at padded width DP (160 - 256) on terms the pre-pass has written
// into the workspace w; p.n_tiles is set here. Two blocks (one cluster) per
// query tile or key block.
template <int DP, bool MASKED, bool ANY = false>
cudaError_t run_dq_wide(const Work& w, Params p, cudaStream_t s) {
  using C = DqWideCfg<DP>;
  CUtensorMap tq, tg, tk, tv, tkt;
  cudaError_t err =
      rows_map(&tq, w.q, p.B, p.H, p.Lq, p.d, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tg, w.g, p.B, p.H, p.Lq, p.d, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tk, w.k, p.B, p.H, p.Lk, p.d, C::TK::W, C::kBK);
  if (err == cudaSuccess)
    err = rows_map(&tv, w.v, p.B, p.H, p.Lk, p.d, C::TK::W, C::kBK);
  if (err == cudaSuccess)
    err = transposed_map(&tkt, w.kt, p.B, p.H, p.Lk, p.d, C::TKT::W, C::kDH);
  if (err != cudaSuccess) return err;
  p.n_tiles = (p.Lq + C::kBQ - 1) / C::kBQ;
  return s9::launch_kernel(flash_bwd_dq_f32_wide_kernel<DP, MASKED, ANY>,
                           2 * p.B * p.H * p.n_tiles, C::kThreads,
                           C::kSmemBytes, s, tq, tg, tk, tv, tkt, p);
}

template <int DP, bool MASKED, bool ANY = false>
cudaError_t run_dkv_wide(const Work& w, Params p, cudaStream_t s) {
  using C = DkvWideCfg<DP>;
  CUtensorMap tq, tg, tk, tv, tqt, tgt;
  cudaError_t err =
      rows_map(&tq, w.q, p.B, p.H, p.Lq, p.d, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tg, w.g, p.B, p.H, p.Lq, p.d, C::TQ::W, C::kBQ);
  if (err == cudaSuccess)
    err = rows_map(&tk, w.k, p.B, p.H, p.Lk, p.d, C::TK::W, C::kBKey);
  if (err == cudaSuccess)
    err = rows_map(&tv, w.v, p.B, p.H, p.Lk, p.d, C::TK::W, C::kBKey);
  if (err == cudaSuccess)
    err = transposed_map(&tqt, w.qt, p.B, p.H, p.Lq, p.d, C::TQT::W,
                         C::kDH);
  if (err == cudaSuccess)
    err = transposed_map(&tgt, w.gt, p.B, p.H, p.Lq, p.d, C::TQT::W,
                         C::kDH);
  if (err != cudaSuccess) return err;
  p.n_tiles = (p.Lk + C::kBKey - 1) / C::kBKey;
  return s9::launch_kernel(flash_bwd_dkv_f32_wide_kernel<DP, MASKED, ANY>,
                           2 * p.B * p.H * p.n_tiles, C::kThreads,
                           C::kSmemBytes, s, tq, tg, tk, tv, tqt, tgt, p);
}

// K3 / K4 up to 128 at padded width DP on terms the pre-pass has written
// into the workspace w; p.n_tiles is set here.
template <int DP, bool MASKED, bool ANY = false>
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
  return s9::launch_kernel(flash_bwd_dq_f32_kernel<DP, MASKED, ANY>,
                           p.B * p.H * p.n_tiles, C::kThreads, C::kSmemBytes,
                           s, tq, tg, tk, tv, tkt, p);
}

template <int DP, bool MASKED, bool ANY = false>
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
  return s9::launch_kernel(flash_bwd_dkv_f32_kernel<DP, MASKED, ANY>,
                           p.B * p.H * p.n_tiles, C::kThreads, C::kSmemBytes,
                           s, tq, tg, tk, tv, tqt, tgt, p);
}

// K3 (dq) or K4 without a mask or masked (causal, K6 / K7) on the one-block
// kernels at padded width DP (16 - 128, a multiple of 16).
template <int DP>
cudaError_t run_narrow(bool dq, bool masked, const Work& w, const Params& p,
                       cudaStream_t s) {
  if (dq)
    return masked ? run_dq<DP, true>(w, p, s) : run_dq<DP, false>(w, p, s);
  return masked ? run_dkv<DP, true>(w, p, s) : run_dkv<DP, false>(w, p, s);
}
#define FDSD_F32_BWD_NARROW(P, DP)                                          \
  P template cudaError_t run_narrow<DP>(bool, bool, const Work&,           \
                                        const Params&, cudaStream_t);
#define FDSD_F32_BWD_NARROW_EXTERN(DP) FDSD_F32_BWD_NARROW(extern, DP)
FDSD_F32_BWD_NARROW_EXTERN(16)
FDSD_F32_BWD_NARROW_EXTERN(32)
FDSD_F32_BWD_NARROW_EXTERN(48)
FDSD_F32_BWD_NARROW_EXTERN(64)
FDSD_F32_BWD_NARROW_EXTERN(80)
FDSD_F32_BWD_NARROW_EXTERN(96)
FDSD_F32_BWD_NARROW_EXTERN(112)
FDSD_F32_BWD_NARROW_EXTERN(128)
#undef FDSD_F32_BWD_NARROW_EXTERN

// K3 (dq) or K4 in the ANY form at padded width DP (32, 64, 96, 128: the
// one-block kernels; 160 - 256: the block pairs).
template <int DP>
cudaError_t run_any(bool dq, const Work& w, const Params& p,
                    cudaStream_t s) {
  if constexpr (DP > 128)
    return dq ? run_dq_wide<DP, true, true>(w, p, s)
              : run_dkv_wide<DP, true, true>(w, p, s);
  else
    return dq ? run_dq<DP, true, true>(w, p, s)
              : run_dkv<DP, true, true>(w, p, s);
}
#define FDSD_F32_BWD_ANY(P, DP)                                             \
  P template cudaError_t run_any<DP>(bool, const Work&, const Params&,     \
                                     cudaStream_t);
#define FDSD_F32_BWD_ANY_EXTERN(DP) FDSD_F32_BWD_ANY(extern, DP)
#define FDSD_F32_BWD_ANY_WIDTHS(X) \
  X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256)
FDSD_F32_BWD_ANY_WIDTHS(FDSD_F32_BWD_ANY_EXTERN)
#undef FDSD_F32_BWD_ANY_EXTERN

// The instantiations of one width, no mask and masked (P: empty, or
// `extern` for their declarations); each width is instantiated in one of the
// flash_f32_bwd_w*.cu files.
#define FDSD_F32_BWD_WIDE(P, DP)                                            \
  P template cudaError_t run_dq_wide<DP, false>(const Work&, Params,        \
                                                cudaStream_t);              \
  P template cudaError_t run_dq_wide<DP, true>(const Work&, Params,         \
                                               cudaStream_t);               \
  P template cudaError_t run_dkv_wide<DP, false>(const Work&, Params,       \
                                                 cudaStream_t);             \
  P template cudaError_t run_dkv_wide<DP, true>(const Work&, Params,        \
                                                cudaStream_t);
#define FDSD_F32_BWD_WIDE_EXTERN(DP) FDSD_F32_BWD_WIDE(extern, DP)
FDSD_F32_BWD_WIDE_EXTERN(160)
FDSD_F32_BWD_WIDE_EXTERN(192)
FDSD_F32_BWD_WIDE_EXTERN(224)
FDSD_F32_BWD_WIDE_EXTERN(256)
#undef FDSD_F32_BWD_WIDE_EXTERN

}  // namespace fdsd::f32bwd
