// Flash-attention forward for Hopper (sm_90a) on TMA and wgmma: bf16 in,
// fp32 softmax, out bf16 + lse fp32. K1 at head dims 40, 48, 64, 72, 80, 128
// and 160, the masked forms at 64 and 128; d = 512 is the kernel of
// flash_attention.cu, with its own C entry. K5, the position-masked forward,
// at head dims 64 and 128, is K1's design under position masks, on the same
// per-tile steps.
//
// Replaces three Pallas TPU kernels of the JAX package:
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_wide
//     (single pass over the whole K/V of one (b, h): SD1 UNet at 64^2,
//     (2B, 8, 4096, 40); tiny-SD at 64^2, (B, 1, 4096, 128))
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel
//     (blocked online softmax with bias, causal, key tail and segment ids:
//     SD1 at 32^2, (2B, 8, 1024, 80); tiny-SD at 32^2; the SigLIP tower and
//     TinyVLM decoder, (16, 12, 576 | 584, 64), causal in the decoder; T5-XXL,
//     (2, 64, 512, 64) with a (1, 64, 512, 512) bias)
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_pos
//     (K5: a LOCAL block of queries against a LOCAL block of keys whose
//     GLOBAL positions are pos(idx) = off[0] + idx below seg, off[1] +
//     (idx - seg) from it on, per side, off int32[2] in device memory; a key
//     is masked when its index is >= Lk, its position >= valid_len (when
//     given), or its position > the query's (causal); online softmax or the
//     fixed-max "bounded" one. The SD3 / MMDiT joint attention runs it four
//     times per block at (2, 24, {154, 4096}, {154, 4096}, 64), offsets 0)
// It computes what they compute, not their block structure: the TPU's
// sequential key-block grid axis is a loop inside the block.
//
// What bounds it on the H100: at 4096 keys attention does ~2,000 flop per
// byte of q, k, v and out, so operations: the tensor cores' issue rate and,
// at small head dims, the exponentials (one per logit on the 16-per-clock
// MUFU pipe; at d = 64 as many clocks as the two products). The mma.sync
// forms it replaces reached ~5 % (K1) and ~17 % (K5) of the bound: global
// loads were synchronous, no load overlapped a product, and mma.sync is not
// the full tensor-core rate on Hopper.
//
// Design. One block of three warpgroups per (b*h, 128 queries):
//  - a producer warpgroup gives up its registers (setmaxnreg 40); one thread
//    issues TMA: the Q tile once, then K and V tiles of 128 keys into a ring
//    of two stages with full / empty mbarriers, so the next tile's copy
//    overlaps this tile's products. The
//    tensor maps are 4-D (D, L, H, B) over the operands' own strides (q, k,
//    v may be column slices of one fused projection), encoded on the host
//    per call; keys and queries past the end and head-dim columns past d
//    come in as zeros (d = 40 -> 48, 72 -> 80). In the bias form its 128
//    threads also stage the bias tile in shared memory in the bias's dtype
//    (one stage, XOR-swizzled against bank conflicts) by cp.async from the
//    bias's strides; a stride of 0 (T5's bias over the batch) is fine.
//  - two consumer warpgroups of 64 query rows (setmaxnreg 232): S = Q K^T
//    by wgmma m64n128k16 with both operands K-major in shared memory as TMA
//    wrote them; the online softmax in registers on the accumulators (row
//    max and sum across the quad, exp2 with scale * log2 e folded in); P
//    converted to bf16 in registers is the A operand of O += P V (wgmma in
//    RS form), V the MN-major B operand read as it lies: no transposed copy.
//    Each product is waited for before its registers are read; the two
//    consumer warpgroups interleave on their own.
//  - swizzle: 128-byte at DP = 64 and 128, 32-byte atoms of 16 columns at
//    DP = 48, 80 and 160 (rows of 96, 160 and 320 bytes), so no MMA work is
//    spent on padding past the next multiple of 16. At DP = 160 (the SD1
//    UNet's level-2 attention, 1280 channels over 8 heads, from 768^2) the
//    Q tile and the two K/V stages take 200 KB of shared memory, and each
//    consumer holds a 64 x 160 fp32 accumulator (80 registers a thread)
//    beside S (64) and P (32); O += P V is one m64n160k16 RS wgmma per
//    16 keys.
// Masks are template parameters, so the no-mask form carries no mask code:
// causal visits no key tile above the diagonal and masks per logit only where
// a tile crosses it; the key tail is masked on the last tile only (TMA's
// zeros are logits of 0, not masked ones); segment ids walk the tile range
// [lo, hi] of mask.cuh at (128, 128) tiles in every role, skip a tile whose
// ids are disjoint, and mask per logit only where the two tiles are not one
// same segment. In the masked forms a masked logit is selected to
// probability 0, so a row that sees no key gives out = 0, lse = -1e30.
// K5 (flash_fwd_pos_sm90_kernel) runs the same steps (qk_tile, softmax_tile,
// pv_tile, store_rows below) with the same producer and consumer roles, and
// differs in three ways:
//  - its masks are runtime flags, read per tile: causal by position over two
//    segments does not make a contiguous range of key tiles, so every role
//    judges each (query tile, key tile) pair by the same pos_pair of the two
//    tiles' position bounds (pos_tile.cuh): skipped, wholly visible, or
//    masked per logit (with the key tail); without causal and valid_len the
//    offsets are not even read. A query tile that visits no key tile loads
//    nothing and waits on no barrier;
//  - BOUNDED fixes the max at 0: no row maxima, no rescale of O, P =
//    exp2(scale log2 e s), lse = ln l;
//  - the grid is persistent (one block per SM walks query tiles with a
//    stride) and Q is double-buffered: the next tile's Q, K and V load while
//    this tile's last products and epilogue run. At SD3's 4096 queries
//    against 154 keys a block's life is two key tiles long, and one block
//    per SM (384 threads take the whole register file) left its load
//    latency and epilogue bare.
// Out is written from the accumulators through its strides, rows past Lq
// are not written; lse is (B, H, Lq) fp32, the contract K3, K4 and the lse
// merge of the joint attention read.
// Later work: overlap one tile's softmax with the next tile's Q K^T (tried:
// ptxas serialised the wgmmas, C7515, and every form got 5-20 % slower),
// FA3's ping-pong of the two consumer warpgroups, a persistent grid for K1.

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
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 128, kBK = 128;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int DP, bool HAS_BIAS>
struct Cfg {
  static constexpr int W = DP % 64 == 0 ? 64 : 16;  // columns per swizzle row
  static constexpr int kChunks = DP / W;
  static constexpr int kStages = 2;  // K/V ring
  static constexpr uint32_t kLayout = W == 64 ? 1 : 3;  // 128B / 32B swizzle
  static constexpr uint32_t kAtom = 8 * W * 2;          // 8 rows of a chunk
  static constexpr int kQChunk = kBQ * W * 2;
  static constexpr int kKVChunk = kBK * W * 2;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kKVBytes = kBK * DP * 2;  // one K or V tile
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBiasOff = kVOff + kStages * kKVBytes;
  static constexpr int kBarOff = kBiasOff + (HAS_BIAS ? kBQ * kBK * 4 : 0);
  // Q full, K/V full and empty per stage, bias full and empty
  static constexpr int kBars = 1 + 2 * kStages + 2;
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(DP % 16 == 0 && (DP <= 128 || DP == 160), "head dim");
};

struct Params {
  __nv_bfloat16* out;
  float* lse;
  int H, Lq, Lk, d, n_qt;
  long long os[3];  // out's (batch, head, seq) element strides
  float scale;
  MaskArgs m;
};

// logit = scale * s + bias in fp32, for this thread's rows rl0 and rl1.
template <typename T>
__device__ __forceinline__ void add_bias(float (&s)[kBK / 2], const T* tile,
                                         int rl0, int rl1, int t,
                                         float scale) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 b0 = s9::load_pair(tile + s9::bias_at<kBK>(rl0, c));
    const float2 b1 = s9::load_pair(tile + s9::bias_at<kBK>(rl1, c));
    s[4 * j] = fmaf(s[4 * j], scale, b0.x);
    s[4 * j + 1] = fmaf(s[4 * j + 1], scale, b0.y);
    s[4 * j + 2] = fmaf(s[4 * j + 2], scale, b1.x);
    s[4 * j + 3] = fmaf(s[4 * j + 3], scale, b1.y);
  }
}

// ------------------------------------------- the steps K1 and K5 share
// S = Q K^T for one consumer warpgroup: 64 rows (q_rows) x 128 keys (ks),
// raw logits.
template <int DP>
__device__ __forceinline__ void qk_tile(float (&s)[kBK / 2], uint32_t q_rows,
                                        uint32_t ks) {
  using C = Cfg<DP, false>;
  s9::fence_regs(s);
  s9::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t chunk = kk * 16 / C::W, off = (kk * 16 % C::W) * 2;
    s9::wgmma_ss<128>(
        s,
        s9::smem_desc(q_rows + chunk * C::kQChunk + off, 16, C::kAtom,
                      C::kLayout),
        s9::smem_desc(ks + chunk * C::kKVChunk + off, 16, C::kAtom,
                      C::kLayout),
        kk > 0);
  }
  s9::wgmma_commit();
  s9::wgmma_wait<0>();
  s9::fence_regs(s);
}

// The softmax of one tile in registers, on this thread's two rows: online
// (running max m, rescale of l and O) or BOUNDED (max fixed at 0: no row
// maxima, no rescale). c = scale * log2 e (or log2 e on scaled logits);
// with SELECT a logit at -1e30 is a masked one, selected to probability 0,
// and a row with nothing visible yet subtracts 0. Leaves P in bf16, the A
// fragments of P V.
template <int DP, bool SELECT, bool BOUNDED>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2],
                                             float (&o)[DP / 2],
                                             uint32_t (&pa)[kBK / 16][4],
                                             float& m0, float& m1, float& l0,
                                             float& l1, float c) {
  float al0 = 1.f, al1 = 1.f, sub0 = 0.f, sub1 = 0.f;
  if (!BOUNDED) {
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with nothing visible yet subtracts 0: its P stays 0
    const float mu0 = SELECT && mn0 == kNegInf ? 0.f : mn0;
    const float mu1 = SELECT && mn1 == kNegInf ? 0.f : mn1;
    al0 = s9::exp2_approx((m0 - mu0) * c);
    al1 = s9::exp2_approx((m1 - mu1) * c);
    m0 = mn0;
    m1 = mn1;
    sub0 = mu0 * c;
    sub1 = mu1 * c;
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e];
      pr[e] = s9::exp2_approx(fmaf(x, c, -(e < 2 ? sub0 : sub1)));
      if (SELECT && x <= kNegInf) pr[e] = 0.f;  // selected, not exp'd
    }
    sum0 += pr[0] + pr[1];
    sum1 += pr[2] + pr[3];
    __nv_bfloat162 lo = __floats2bfloat162_rn(pr[0], pr[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(pr[2], pr[3]);
    pa[j / 2][(j & 1) * 2] = *reinterpret_cast<uint32_t*>(&lo);
    pa[j / 2][(j & 1) * 2 + 1] = *reinterpret_cast<uint32_t*>(&hi);
  }
  l0 = l0 * al0 + sum0;
  l1 = l1 * al1 + sum1;
  if (!BOUNDED) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
  }
}

// O += P V: V MN-major in shared memory (vs), the k-step kk is keys
// 16kk .. 16kk + 15.
template <int DP>
__device__ __forceinline__ void pv_tile(float (&o)[DP / 2],
                                        const uint32_t (&pa)[kBK / 16][4],
                                        uint32_t vs) {
  using C = Cfg<DP, false>;
  s9::fence_regs(o);
  s9::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    s9::wgmma_rs<DP>(o, pa[kk],
                     s9::smem_desc(vs + kk * 16 * C::W * 2, C::kKVChunk,
                                   C::kAtom, C::kLayout),
                     1);
  s9::wgmma_commit();
  s9::wgmma_wait<0>();
  s9::fence_regs(o);
}

// Epilogue of this thread's rows r0, r1: O / l in bf16 at ob (row stride
// os2), lse = m * to_ln + log l into lb; rows past Lq and columns past d are
// not written; a row with l = 0 gives out = 0 and lse = -1e30.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&o)[DP / 2], float l0,
                                           float l1, float m0, float m1,
                                           float to_ln, __nv_bfloat16* ob,
                                           long long os2, float* lb, int r0,
                                           int r1, int Lq, int d, int t) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col < d) {
      if (r0 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * os2 + col) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * os2 + col) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
  if (t == 0) {
    if (r0 < Lq) lb[r0] = l0 == 0.f ? kNegInf : m0 * to_ln + logf(l0);
    if (r1 < Lq) lb[r1] = l1 == 0.f ? kNegInf : m1 * to_ln + logf(l1);
  }
}

// ----------------------------------------------------------------- K1
template <int DP, bool CAUSAL, bool HAS_BIAS, bool HAS_SEG>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const Params p) {
  using C = Cfg<DP, HAS_BIAS>;
  constexpr bool kSelect = CAUSAL || HAS_BIAS || HAS_SEG;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  float* bias_s =
      reinterpret_cast<float*>(smem_raw + (base - raw) + C::kBiasOff);
  const uint32_t q_s = base, k_s = base + C::kKOff, v_s = base + C::kVOff;
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
  }
  __syncthreads();

  // The key tiles this block visits, the same walk in every role: all of
  // them; up to the diagonal when causal; the range whose segment ids
  // overlap this query tile's, less the disjoint tiles inside it.
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

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      s9::mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c)
        s9::tma_load_4d(q_s + c * C::kQChunk, &tq, q_full, c * C::W, q0, h, b);
    }
    const long long bias_base = HAS_BIAS ? b * p.m.bs[0] + h * p.m.bs[1] : 0;
    int stage = 0;
    uint32_t phase = 0, bias_phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      if (HAS_SEG && !seg_overlap(q_bound, k_bounds + 2 * kt)) continue;
      const int k0 = kt * kBK;
      if (tid == 0) {
        const uint32_t full = full0 + 8 * stage;
        s9::mbar_wait(empty0 + 8 * stage, phase ^ 1);
        s9::mbar_expect_tx(full, 2 * C::kKVBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          const int off = stage * C::kKVBytes + c * C::kKVChunk;
          s9::tma_load_4d(k_s + off, &tk, full, c * C::W, k0, h, b);
          s9::tma_load_4d(v_s + off, &tv, full, c * C::W, k0, h, b);
        }
      }
      if (HAS_BIAS) {
        s9::mbar_wait(bias_empty, bias_phase ^ 1);
        if (p.m.bias_bf16)
          s9::stage_bias<kBQ, kBK>(
              reinterpret_cast<__nv_bfloat16*>(bias_s), p.m, bias_base, q0,
              k0, p.Lq, p.Lk, tid, bias_full);
        else
          s9::stage_bias<kBQ, kBK>(bias_s, p.m, bias_base, q0, k0, p.Lq,
                                   p.Lk, tid, bias_full);
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
    const int* kv_ids = nullptr;
    int qid0 = -1, qid1 = -1;
    if (HAS_SEG) {
      kv_ids = p.m.kv_ids + static_cast<long long>(b) * p.Lk;
      const int* ids = p.m.q_ids + static_cast<long long>(b) * p.Lq;
      if (r0 < p.Lq) qid0 = ids[r0];
      if (r1 < p.Lq) qid1 = ids[r1];
    }
    // exp(x * scale) = exp2(x * c); with a bias the logits are scaled first
    const float c = HAS_BIAS ? kLog2e : p.scale * kLog2e;
    float m0 = kNegInf, m1 = kNegInf;  // running row max (logit units)
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float s[kBK / 2];
    const uint32_t q_rows = q_s + cw * 64 * C::W * 2;  // this group's Q rows

    s9::mbar_wait(q_full, 0);  // also when no tile is visited: TMA is done
    int stage = 0;
    uint32_t phase = 0, bias_phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      if (HAS_SEG && !seg_overlap(q_bound, k_bounds + 2 * kt)) continue;
      const int k0 = kt * kBK;
      const uint32_t ks = k_s + stage * C::kKVBytes;
      const uint32_t vs = v_s + stage * C::kKVBytes;
      // Which per-logit masks this tile needs; the segment ids of this
      // thread's 32 key columns are loaded before the wait, so that their
      // latency hides behind the copy and Q K^T.
      bool need_mask = k0 + kBK > p.Lk;
      if (CAUSAL) need_mask = need_mask || k0 + kBK - 1 > q0 + 64 * cw;
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
      s9::mbar_wait(full0 + 8 * stage, phase);
      qk_tile<DP>(s, q_rows, ks);

      if (HAS_BIAS) {  // logit = scale * s + bias, in fp32
        s9::mbar_wait(bias_full, bias_phase);
        if (p.m.bias_bf16)
          add_bias(s, reinterpret_cast<const __nv_bfloat16*>(bias_s), rl0,
                   rl1, t, p.scale);
        else
          add_bias(s, bias_s, rl0, rl1, t, p.scale);
        s9::mbar_arrive(bias_empty);
        bias_phase ^= 1;
      }

      // Per-logit masks, only on the tiles that need them.
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            bool visible = col < p.Lk;
            if (CAUSAL) visible = visible && col <= (e < 2 ? r0 : r1);
            if (HAS_SEG && seg_mask)
              visible = visible && kv_id[j][e & 1] == (e < 2 ? qid0 : qid1);
            if (!visible) s[4 * j + e] = kNegInf;
          }
        }
      }

      uint32_t pa[kBK / 16][4];  // P in bf16: the A fragments of P V
      softmax_tile<DP, kSelect, false>(s, o, pa, m0, m1, l0, l1, c);
      pv_tile<DP>(o, pa, vs);
      s9::mbar_arrive(empty0 + 8 * stage);  // K and V of this stage are read
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue: O / l in bf16 through out's strides; lse = m + log l.
    store_rows<DP>(o, l0, l1, m0, m1, c * kLn2,
                   p.out + b * p.os[0] + h * p.os[1], p.os[2],
                   p.lse + static_cast<long long>(bh) * p.Lq, r0, r1, p.Lq,
                   p.d, t);
  }
}

// ----------------------------------------------------------------- K5
// Shared memory of K5: two Q buffers (the next query tile's Q loads while
// this one's last products and epilogue run), the K/V ring, and full / empty
// barriers for each Q buffer and each ring stage.
template <int DP>
struct PosCfg {
  using C = Cfg<DP, false>;
  static constexpr int kKOff = 2 * C::kQBytes;
  static constexpr int kVOff = kKOff + C::kStages * C::kKVBytes;
  static constexpr int kBarOff = kVOff + C::kStages * C::kKVBytes;
  static constexpr int kBars = 2 * 2 + 2 * C::kStages;
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= 232448, "shared memory");
};

struct PosParams {
  __nv_bfloat16* out;
  float* lse;
  int H, Lq, Lk, n_qt, n_tiles;  // n_tiles = B * H * n_qt query tiles
  long long os[3];               // out's (batch, head, seq) element strides
  float scale;
  PosArgs pos;
};

// A persistent grid: block i takes query tiles i, i + gridDim.x, ... (tile =
// bh * n_qt + qt), so that consecutive blocks share K and V in L2 and one
// tile's epilogue overlaps the next tile's loads.
template <int DP, bool BOUNDED>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_pos_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ PosParams p) {
  using C = Cfg<DP, false>;
  using P = PosCfg<DP>;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (s9::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base + P::kKOff, v_s = base + P::kVOff;
  const uint32_t q_full0 = base + P::kBarOff, q_empty0 = q_full0 + 16;
  const uint32_t full0 = q_empty0 + 16, empty0 = full0 + 8 * C::kStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      s9::mbar_init(q_full0 + 8 * i, 1);
      s9::mbar_init(q_empty0 + 8 * i, kConsumers);
    }
    for (int s = 0; s < C::kStages; ++s) {
      s9::mbar_init(full0 + 8 * s, 1);
      s9::mbar_init(empty0 + 8 * s, kConsumers);
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
  const bool masked = p.pos.causal || p.pos.has_valid;
  int q_off0 = 0, q_off1 = 0, k_off0 = 0, k_off1 = 0;
  if (masked) {
    q_off0 = p.pos.q_off[0];
    q_off1 = p.pos.q_off[1];
    k_off0 = p.pos.k_off[0];
    k_off1 = p.pos.k_off[1];
  }
  const int n_kt = (p.Lk + kBK - 1) / kBK;
  // pos_pair of the query tile at q0 with key tile kt: 0 skip, 1 visible,
  // 2 masked per logit; the same call in every role, so that producer and
  // consumers walk the same (tile, key tile) pairs and the barriers' phases
  // stay in step.
  auto pair = [&](int q0, int kt) {
    if (!masked) return 1;
    int q_lo, q_hi, k_lo, k_hi;
    pos_bounds(q0, kBQ, q_off0, q_off1, p.pos.seg_q, p.Lq, q_lo, q_hi);
    pos_bounds(kt * kBK, kBK, k_off0, k_off1, p.pos.seg_k, p.Lk, k_lo, k_hi);
    return pos_pair(p.pos, q_lo, q_hi, k_lo, k_hi);
  };
  // does the query tile at q0 visit any key tile?
  auto visits = [&](int q0) {
    for (int kt = 0; kt < n_kt; ++kt)
      if (pair(q0, kt) != 0) return true;
    return false;
  };

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid != 0) return;
    int stage = 0, qb = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const int bh = tile / p.n_qt, q0 = (tile % p.n_qt) * kBQ;
      const int b = bh / p.H, h = bh % p.H;
      if (!visits(q0)) continue;  // loads nothing
      const uint32_t q_full = q_full0 + 8 * qb;
      s9::mbar_wait(q_empty0 + 8 * qb, q_phase ^ 1);
      s9::mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c)
        s9::tma_load_4d(base + qb * C::kQBytes + c * C::kQChunk, &tq, q_full,
                        c * C::W, q0, h, b);
      if (++qb == 2) {
        qb = 0;
        q_phase ^= 1;
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        if (pair(q0, kt) == 0) continue;
        const int k0 = kt * kBK;
        const uint32_t full = full0 + 8 * stage;
        s9::mbar_wait(empty0 + 8 * stage, phase ^ 1);
        s9::mbar_expect_tx(full, 2 * C::kKVBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          const int off = stage * C::kKVBytes + c * C::kKVChunk;
          s9::tma_load_4d(k_s + off, &tk, full, c * C::W, k0, h, b);
          s9::tma_load_4d(v_s + off, &tv, full, c * C::W, k0, h, b);
        }
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    s9::reg_alloc<kConsumerRegs>();
    const int cw = (tid - 128) / 128;  // query rows 64*cw .. 64*cw + 63
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl0 = 64 * cw + 16 * warp + g, rl1 = rl0 + 8;  // tile rows
    const float c = p.scale * kLog2e;  // exp(x * scale) = exp2(x * c)
    int stage = 0, qb = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const int bh = tile / p.n_qt, q0 = (tile % p.n_qt) * kBQ;
      const int b = bh / p.H, h = bh % p.H;
      const int r0 = q0 + rl0, r1 = q0 + rl1;
      int qpos0 = 0, qpos1 = 0;  // positions of this thread's two rows
      if (masked) {
        qpos0 = pos_of(r0, q_off0, q_off1, p.pos.seg_q);
        qpos1 = pos_of(r1, q_off0, q_off1, p.pos.seg_q);
      }
      // running row max (logit units; bounded: fixed at 0) and this
      // thread's share of the row sums
      float m0 = BOUNDED ? 0.f : kNegInf, m1 = BOUNDED ? 0.f : kNegInf;
      float l0 = 0.f, l1 = 0.f;
      float o[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
      if (visits(q0)) {
        s9::mbar_wait(q_full0 + 8 * qb, q_phase);
        const uint32_t q_rows = base + qb * C::kQBytes + cw * 64 * C::W * 2;
        float s[kBK / 2];
        for (int kt = 0; kt < n_kt; ++kt) {
          const int state = pair(q0, kt);
          if (state == 0) continue;
          const int k0 = kt * kBK;
          const bool need_mask = k0 + kBK > p.Lk || state == 2;
          s9::mbar_wait(full0 + 8 * stage, phase);
          qk_tile<DP>(s, q_rows, k_s + stage * C::kKVBytes);

          // Per-logit masks (the key tail, valid_len, causal by position),
          // only on the tiles that need them.
          if (need_mask) {
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j) {
              int cpos[2];  // the positions of this thread's two keys
              bool kvis[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = k0 + 8 * j + 2 * t + e;
                cpos[e] = pos_of(col, k_off0, k_off1, p.pos.seg_k);
                kvis[e] = col < p.Lk &&
                          (!p.pos.has_valid || cpos[e] < p.pos.valid_len);
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                bool visible = kvis[e & 1];
                if (p.pos.causal)
                  visible = visible && cpos[e & 1] <= (e < 2 ? qpos0 : qpos1);
                if (!visible) s[4 * j + e] = kNegInf;
              }
            }
          }

          uint32_t pa[kBK / 16][4];  // P in bf16: the A fragments of P V
          softmax_tile<DP, true, BOUNDED>(s, o, pa, m0, m1, l0, l1, c);
          pv_tile<DP>(o, pa, v_s + stage * C::kKVBytes);
          s9::mbar_arrive(empty0 + 8 * stage);  // K and V of this stage
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        s9::mbar_arrive(q_empty0 + 8 * qb);  // this Q buffer is read
        if (++qb == 2) {
          qb = 0;
          q_phase ^= 1;
        }
      }
      // A tile that visits no key tile writes out = 0 and lse = -1e30.
      store_rows<DP>(o, l0, l1, m0, m1, p.scale,
                     p.out + b * p.os[0] + h * p.os[1], p.os[2],
                     p.lse + static_cast<long long>(bh) * p.Lq, r0, r1, p.Lq,
                     DP, t);
    }
  }
}

// ---------------------------------------------------------------- host side
// The q, k, v tensor maps of one launch.
template <int DP>
cudaError_t make_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
                      const void* q, const void* k, const void* v, int d,
                      int Lq, int Lk, int H, int B, const long long* st) {
  using C = Cfg<DP, false>;
  const CUtensorMapSwizzle sw =
      C::W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  cudaError_t err = s9::make_map(tq, q, d, Lq, H, B, st, C::W, kBQ, sw);
  if (err == cudaSuccess)
    err = s9::make_map(tk, k, d, Lk, H, B, st + 3, C::W, kBK, sw);
  if (err == cudaSuccess)
    err = s9::make_map(tv, v, d, Lk, H, B, st + 6, C::W, kBK, sw);
  return err;
}

template <int DP, bool CAUSAL = false, bool HAS_BIAS = false,
          bool HAS_SEG = false>
cudaError_t launch(const void* q, const void* k, const void* v, int B,
                   const long long* st, const Params& p,
                   cudaStream_t stream) {
  using C = Cfg<DP, HAS_BIAS>;
  CUtensorMap tq, tk, tv;
  const cudaError_t err =
      make_maps<DP>(&tq, &tk, &tv, q, k, v, p.d, p.Lq, p.Lk, p.H, B, st);
  if (err != cudaSuccess) return err;
  return s9::launch_kernel(flash_fwd_sm90_kernel<DP, CAUSAL, HAS_BIAS, HAS_SEG>,
                           p.n_qt * B * p.H, kThreads, C::kSmemBytes, stream,
                           tq, tk, tv, p);
}

// K5 on min(query tiles, SMs) persistent blocks.
template <int DP, bool BOUNDED>
cudaError_t launch_pos(const void* q, const void* k, const void* v, int B,
                       const long long* st, const PosParams& p,
                       cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int dev = 0, n_sm = 0;
  cudaError_t err =
      make_maps<DP>(&tq, &tk, &tv, q, k, v, DP, p.Lq, p.Lk, p.H, B, st);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return s9::launch_kernel(flash_fwd_pos_sm90_kernel<DP, BOUNDED>,
                           p.n_tiles < n_sm ? p.n_tiles : n_sm, kThreads,
                           PosCfg<DP>::kSmemBytes, stream, tq, tk, tv, p);
}

// The masked forms at one head dim; code = 4*causal + 2*has_bias + has_seg.
template <int DP>
cudaError_t launch_masked(int code, const void* q, const void* k,
                          const void* v, int B, const long long* st,
                          const Params& p, cudaStream_t s) {
  switch (code) {
#define FDSD_FORM(CODE, CA, BI, SE) \
  case CODE:                        \
    return launch<DP, CA, BI, SE>(q, k, v, B, st, p, s);
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

// strides: 16 element strides, (batch, head, seq) for q, k, v, out, then
// (batch, head, row, col) for the bias; the head-dim stride is 1. lse is
// (B, H, Lq) contiguous fp32. bias (fp32, or bf16 when bias_bf16) and the six
// segment arrays of mask.cuh are null when the form is not asked for. Head
// dims 40, 48, 64, 72, 80, 128 and 160 run here, the masked forms at 64 and
// 128; others (d = 512: fdsd_flash_fwd_d512) return cudaErrorInvalidValue.
extern "C" int fdsd_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, const void* bias,
                              const void* q_ids, const void* kv_ids,
                              const void* q_bounds, const void* kv_bounds,
                              const void* lo, const void* hi, int B, int H,
                              int Lq, int Lk, int d, const long long* strides,
                              float scale, int causal, int bias_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = 4 * (causal != 0) + 2 * (bias != nullptr) +
                   (q_ids != nullptr);
  Params p;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.n_qt = (Lq + kBQ - 1) / kBQ;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.scale = scale;
  p.m = fdsd::make_mask_args(bias, strides + 12, bias_bf16, q_ids, kv_ids,
                             q_bounds, kv_bounds, lo, hi);
  cudaError_t err;
  if (code != 0) {
    if (d == 64)
      err = launch_masked<64>(code, q, k, v, B, strides, p, s);
    else if (d == 128)
      err = launch_masked<128>(code, q, k, v, B, strides, p, s);
    else
      err = cudaErrorInvalidValue;
    return static_cast<int>(err);
  }
  switch ((d + 15) / 16 * 16) {
    case 48:  // SD1 UNet at 64^2: d = 40
      err = launch<48>(q, k, v, B, strides, p, s);
      break;
    case 64:  // SigLIP tower, TinyVLM decoder, T5
      err = launch<64>(q, k, v, B, strides, p, s);
      break;
    case 80:  // SD1 UNet at 32^2: d = 80 (and 72)
      err = launch<80>(q, k, v, B, strides, p, s);
      break;
    case 128:  // tiny-SD UNet
      err = launch<128>(q, k, v, B, strides, p, s);
      break;
    case 160:  // SD1 UNet level 2 (1280 / 8 heads), from 768^2 images
      err = launch<160>(q, k, v, B, strides, p, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// K5. strides: 12 element strides, (batch, head, seq) for q, k, v, out; the
// head-dim stride is 1. lse is (B, H, Lq) contiguous fp32. q_off and k_off
// are int32[2] in device memory. Head dims 64 and 128; others return
// cudaErrorInvalidValue.
extern "C" int fdsd_flash_fwd_pos(const void* q, const void* k, const void* v,
                                  void* out, void* lse, const void* q_off,
                                  const void* k_off, int B, int H, int Lq,
                                  int Lk, int d, const long long* strides,
                                  float scale, int seg_q, int seg_k,
                                  int valid_len, int has_valid, int causal,
                                  int bounded, void* stream) {
  PosParams p;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.n_qt = (Lq + kBQ - 1) / kBQ;
  p.n_tiles = B * H * p.n_qt;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.scale = scale;
  p.pos = PosArgs{static_cast<const int*>(q_off),
                  static_cast<const int*>(k_off), seg_q, seg_k, valid_len,
                  has_valid, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64)
    err = bounded ? launch_pos<64, true>(q, k, v, B, strides, p, s)
                  : launch_pos<64, false>(q, k, v, B, strides, p, s);
  else if (d == 128)
    err = bounded ? launch_pos<128, true>(q, k, v, B, strides, p, s)
                  : launch_pos<128, false>(q, k, v, B, strides, p, s);
  return static_cast<int>(err);
}
