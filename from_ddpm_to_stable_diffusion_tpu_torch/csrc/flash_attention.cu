// Flash-attention forward above head dim 256 for Hopper (sm_90a) on TMA and
// wgmma, bf16 in, fp32 softmax, out bf16 + lse fp32: K1 at the padded widths
// DP = 384 (head dims 257 to 384) and 512 (385 to 512), without a mask and
// in every mask form (causal, an additive bias, segment ids and their
// combinations), and K5 (the position masks, online and bounded) at the same
// widths. At 512 it is the VAEs' one-head mid attention (SD1 decoder and
// encoder, (B, 1, 4096, 512); SD3 decoder, (1, 1, 16384, 512)). Head dims up
// to 256 are the kernels of flash_attention_sm90.cu.
//
// Replaces, above head dim 256, the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_wide
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_pos
// (the second in its bias, causal and segment-id forms, the third in its
// position forms: two offset segments a side, valid_len, causal by position,
// online or bounded), computing what they compute (out in bf16, lse = m +
// log l in fp32) with the TPU's sequential key-block grid axis as a loop in
// the block.
//
// What bounds it on the H100: operations (4096 keys: ~2,000 flop per byte),
// so the tensor cores' issue rate. The mma.sync kernel it replaces reached
// ~3 % of that bound: K and V were loaded synchronously, V was transposed
// element by element, and S went through fp32 shared memory with four block
// barriers per key tile.
//
// Design. A 64 x DP fp32 output accumulator is DP / 2 registers a thread for
// one warpgroup, more than a thread may hold, so one block of three
// warpgroups per (b*h, 64 queries, key split):
//  - a producer warpgroup gives up its registers (setmaxnreg 40); one thread
//    issues TMA: the Q tile once (64 KB at DP 512), then K and V tiles of 64
//    keys (64 KB each), each on its own single-stage full / empty mbarrier
//    pair, so that the next tile's K loads while this tile's P V runs and
//    its V while the next S and softmax run. 227 KB of shared memory hold
//    one Q and one K and V tile of 64 keys (a second stage of both would not
//    fit). Boxes are 64 columns with 128-byte swizzle, DP / 64 chunks per
//    row; the columns past the head dim read as TMA's zeros.
//  - two consumer warpgroups (setmaxnreg 232), each owning DP / 2 of the
//    output columns (DP / 4 fp32 registers of O), split S = Q K^T by keys:
//    each computes S for its 32 of the tile's 64 keys over the full d (wgmma
//    m64n32k16, SS form, both operands K-major as TMA wrote them). They
//    exchange the row maxima through shared memory under a named barrier of
//    the 256 consumer threads, so both apply the same running max; each
//    writes its half of P in bf16 into a (64 x 64) shared tile in the
//    128-byte swizzled K-major layout wgmma reads, fences it to the async
//    proxy, and after a second named barrier runs O[:, its columns] += P V
//    as m64n(DP/2)k16 with P and V (MN-major, read as it lies) from shared
//    memory. Each keeps its own part of the row sums under the common max;
//    the two parts are added once, at the end.
//  - the key tail is masked on the last tile only (TMA's zeros are logits of
//    0, not masked ones).
//  - masks (the ANY instantiation, every path chosen per launch): the
//    position masks of pos_tile.cuh (two offset segments a side, valid_len,
//    causal by position; K1's causal is the same predicate with offsets 0,
//    key <= query from index 0) judge each (query tile, key tile) pair by
//    pos_pair in every role: a pair that shows nothing is skipped, a
//    partly visible one masked per logit; the bias is read from global
//    memory into each consumer's logits (logit = scale s + bias in fp32; a
//    bias of -1e30 or -inf hides the key, narrowing the key-tail mask);
//    segment ids walk the tile range [lo, hi] of mask.cuh at (64, 64), skip
//    a tile whose id range is disjoint and compare ids per logit. A masked
//    probability is selected to 0, so a row that sees no key gives out = 0
//    and lse = -1e30. The bounded softmax (K5's, a launch flag) keeps the
//    max at 0: no row maxima exchanged, no rescale.
//  - key split: with fewer 64-query blocks than SMs (SD1's 4096 queries give
//    64) the host splits the key tiles over up to four blocks per query
//    tile; each writes O / l in fp32 and its lse into a workspace, and
//    merge_d512_kernel combines them by their lse into out and lse. A split
//    whose keys a row does not see (past the diagonal, past valid_len, other
//    segments, or all masked; a whole split or launch past them) gets lse =
//    -1e30 there and weight 0. Under the bounded softmax each split's sum is
//    taken under the fixed max 0, its lse = log l; the merge's max is over
//    the splits' lse, not the logits, so the merged lse is log of the sum of
//    the splits' sums, what one block over every key would give.

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
constexpr int W = 64;  // columns per swizzle row
constexpr int kBQ = 64, kBK = 64, kHalf = kBK / 2;  // keys of S per consumer
constexpr int kMaxSplits = 4;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr uint32_t kAtom = 8 * W * 2;  // 8 rows of a chunk
constexpr int kQChunk = kBQ * W * 2, kKChunk = kBK * W * 2;

template <int DP>
struct Cfg {
  static constexpr int kChunks = DP / W;
  static constexpr int kQBytes = kBQ * DP * 2, kKBytes = kBK * DP * 2;
  static constexpr int kKOff = kQBytes, kVOff = kKOff + kKBytes;
  static constexpr int kPOff = kVOff + kKBytes;  // P, 64 x 64 bf16: one chunk
  static constexpr int kStatOff = kPOff + kBQ * kBK * 2;  // max, sum: 2 x 2
  static constexpr int kBarOff = kStatOff + 4 * kBQ * 4;
  static constexpr int kBars = 5;  // Q full; K full, empty; V full, empty
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static constexpr int kNC = DP / 2;  // output columns a consumer
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(DP % 128 == 0 && DP <= 512, "width");
};
static_assert(kBK == W, "P is one swizzled chunk");

struct Params {
  __nv_bfloat16* out;
  float* lse;
  float* work;  // splits > 1: O / l (splits, rows, DP), then lse (splits, rows)
  int H, Lq, Lk, d, n_qt, splits, kt_per_split;
  int bounded;  // ANY: the max fixed at 0 (K5's bounded softmax)
  long long rows;   // B * H * Lq
  long long os[3];  // out's (batch, head, seq) element strides
  float scale;
  PosArgs pos;  // ANY: the position masks (K1: null offsets, read as 0)
  MaskArgs m;   // ANY: the bias and the segment arrays at (64, 64)
};

template <int DP, bool ANY>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_d512_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ Params p) {
  using C = Cfg<DP>;
  constexpr int NC = C::kNC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  unsigned char* p_tile = smem + C::kPOff;
  // [max of consumer 0 | max of consumer 1 | sum 0 | sum 1], kBQ rows each
  float* stat = reinterpret_cast<float*>(smem + C::kStatOff);
  const uint32_t q_s = base, k_s = base + C::kKOff, v_s = base + C::kVOff;
  const uint32_t p_s = base + C::kPOff;
  const uint32_t q_full = base + C::kBarOff, k_full = q_full + 8;
  const uint32_t k_empty = k_full + 8, v_full = k_empty + 8;
  const uint32_t v_empty = v_full + 8;

  const int tid = threadIdx.x;
  const int split = blockIdx.x % p.splits;
  const int tile = blockIdx.x / p.splits;
  const int bh = tile / p.n_qt;
  int qt = tile % p.n_qt;
  const bool causal = ANY && p.pos.causal != 0;
  const bool has_valid = ANY && p.pos.has_valid != 0;
  const bool masked = causal || has_valid;  // positions matter
  const bool bounded = ANY && p.bounded != 0;
  const bool has_bias = ANY && p.m.bias != nullptr;
  const bool has_seg = ANY && p.m.q_ids != nullptr;
  if (causal) qt = p.n_qt - 1 - qt;  // the longest rows start first
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kBQ;
  const int n_kt = (p.Lk + kBK - 1) / kBK;
  int kt_begin = split * p.kt_per_split;
  int kt_end = min(n_kt, kt_begin + p.kt_per_split);
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
  // The key tiles this block visits, the same walk in every role: its
  // split's; those pos_pair does not skip; the range whose segment ids
  // overlap this query tile's, less the disjoint tiles inside it.
  const int* q_bound = nullptr;
  const int* k_bounds = nullptr;
  if (has_seg) {
    const int seg_tile = b * p.n_qt + qt;
    kt_begin = max(kt_begin, p.m.lo[seg_tile]);
    kt_end = min(kt_end, p.m.hi[seg_tile] + 1);
    q_bound = p.m.q_bounds + 2 * seg_tile;
    k_bounds = p.m.kv_bounds + 2 * b * n_kt;
  }
  // what the (query tile, key tile kt) pair needs: 0 skip, 1 visible, 2
  // masked per logit by position; the same call in every role keeps the
  // barriers' phases in step (pos_tile.cuh)
  auto pair = [&](int kt) {
    if (has_seg && !seg_overlap(q_bound, k_bounds + 2 * kt)) return 0;
    if (!masked) return 1;
    int q_lo, q_hi, k_lo, k_hi;
    pos_bounds(q0, kBQ, q_off0, q_off1, p.pos.seg_q, p.Lq, q_lo, q_hi);
    pos_bounds(kt * kBK, kBK, k_off0, k_off1, p.pos.seg_k, p.Lk, k_lo, k_hi);
    return pos_pair(p.pos, q_lo, q_hi, k_lo, k_hi);
  };

  if (tid == 0) {
    s9::mbar_init(q_full, 1);
    s9::mbar_init(k_full, 1);
    s9::mbar_init(k_empty, kConsumers);
    s9::mbar_init(v_full, 1);
    s9::mbar_init(v_empty, kConsumers);
    s9::mbar_init_fence();
  } else if (tid == 32) {  // fetch the descriptors while barriers are set up
    s9::prefetch_tensormap(&tq);
    s9::prefetch_tensormap(&tk);
    s9::prefetch_tensormap(&tv);
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    s9::reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      s9::mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c)
        s9::tma_load_4d(q_s + c * kQChunk, &tq, q_full, c * W, q0, h, b);
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        if (pair(kt) == 0) continue;
        const int k0 = kt * kBK;
        s9::mbar_wait(k_empty, phase ^ 1);
        s9::mbar_expect_tx(k_full, C::kKBytes);
        for (int c = 0; c < C::kChunks; ++c)
          s9::tma_load_4d(k_s + c * kKChunk, &tk, k_full, c * W, k0, h, b);
        s9::mbar_wait(v_empty, phase ^ 1);
        s9::mbar_expect_tx(v_full, C::kKBytes);
        for (int c = 0; c < C::kChunks; ++c)
          s9::tma_load_4d(v_s + c * kKChunk, &tv, v_full, c * W, k0, h, b);
        phase ^= 1;
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    s9::reg_alloc<kConsumerRegs>();
    const int cw = (tid - 128) / 128;  // keys 32*cw.. of S, columns NC*cw..
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl0 = 16 * warp + g, rl1 = rl0 + 8;  // tile rows
    const int r0 = q0 + rl0, r1 = q0 + rl1;
    // exp(x * scale) = exp2(x * c); with a bias the logits are scaled first
    const float c = has_bias ? kLog2e : p.scale * kLog2e;
    // running row max (logit units; bounded: fixed at 0)
    float m0 = bounded ? 0.f : kNegInf, m1 = m0;
    float l0 = 0.f, l1 = 0.f;  // this thread's share of its half's row sums
    float o[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) o[i] = 0.f;
    float s[kHalf / 2];
    float* my_max = stat + cw * kBQ;
    const float* other_max = stat + (1 - cw) * kBQ;
    // ANY: the segment ids of this thread's two rows
    const int* kv_ids = nullptr;
    int qid0 = -1, qid1 = -1;
    if (has_seg) {
      kv_ids = p.m.kv_ids + static_cast<long long>(b) * p.Lk;
      const int* ids = p.m.q_ids + static_cast<long long>(b) * p.Lq;
      if (r0 < p.Lq) qid0 = ids[r0];
      if (r1 < p.Lq) qid1 = ids[r1];
    }
    const long long bias_base = has_bias ? b * p.m.bs[0] + h * p.m.bs[1] : 0;
    // ANY: the positions of this thread's two rows (rows past Lq are not
    // written, whatever they see)
    int qpos0 = 0, qpos1 = 0;
    if (masked) {
      qpos0 = pos_of(r0, q_off0, q_off1, p.pos.seg_q);
      qpos1 = pos_of(r1, q_off0, q_off1, p.pos.seg_q);
    }

    s9::mbar_wait(q_full, 0);  // also when no tile is visited: TMA is done
    uint32_t phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int state = pair(kt);
      if (state == 0) continue;
      const int k0 = kt * kBK;
      s9::mbar_wait(k_full, phase);

      // S = Q K^T for keys 32*cw .. 32*cw + 31 of the tile: raw logits.
      s9::fence_regs(s);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t chunk = kk * 16 / W, off = (kk * 16 % W) * 2;
        s9::wgmma_ss<kHalf>(
            s, s9::smem_desc(q_s + chunk * kQChunk + off, 16, kAtom, 1),
            s9::smem_desc(k_s + chunk * kKChunk + cw * kHalf * W * 2 + off, 16,
                          kAtom, 1),
            kk > 0);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(s);
      s9::mbar_arrive(k_empty);  // this group's reads of K are done

      // ANY: logit = scale * s + bias in fp32 (rows past Lq and keys past Lk
      // read no bias: their logits are not used or are masked below).
      if (has_bias) {
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + kHalf * cw + 8 * j + 2 * t + (e & 1);
            const int row = e < 2 ? r0 : r1;
            const float bias = row < p.Lq && key < p.Lk
                                   ? fdsd::load_bias(p.m, bias_base, row, key)
                                   : 0.f;
            s[4 * j + e] = fmaf(s[4 * j + e], p.scale, bias);
          }
      }
      // The key tail (last tile only), on a partly visible pair the keys
      // past valid_len and past each row's position, and keys of another
      // segment, to -1e30; the key tail after the bias, which narrows it
      // and never replaces it.
      if (k0 + kBK > p.Lk || state == 2 || has_seg) {
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int key = k0 + kHalf * cw + 8 * j + 2 * t + u;
            bool v0 = key < p.Lk, v1 = v0;
            if (state == 2) {
              const int kpos = pos_of(key, k_off0, k_off1, p.pos.seg_k);
              if (has_valid && kpos >= p.pos.valid_len) v0 = v1 = false;
              if (causal) {
                v0 = v0 && kpos <= qpos0;
                v1 = v1 && kpos <= qpos1;
              }
            }
            if (has_seg && key < p.Lk) {
              const int kid = kv_ids[key];
              v0 = v0 && kid == qid0;
              v1 = v1 && kid == qid1;
            }
            if (!v0) s[4 * j + u] = kNegInf;
            if (!v1) s[4 * j + 2 + u] = kNegInf;
          }
      }

      // The row max over both halves of the tile, through shared memory (the
      // bounded softmax keeps 0 and exchanges nothing); a row with nothing
      // visible yet subtracts 0. The barrier also keeps this group from
      // writing P while the other still reads the last tile's.
      float al0 = 1.f, al1 = 1.f, sub0 = 0.f, sub1 = 0.f;
      float mx0 = kNegInf, mx1 = kNegInf;
      if (!bounded) {
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        if (t == 0) {
          my_max[rl0] = mx0;
          my_max[rl1] = mx1;
        }
      }
      s9::named_barrier_sync(1, kConsumers);
      if (!bounded) {
        const float mn0 = fmaxf(m0, fmaxf(mx0, other_max[rl0]));
        const float mn1 = fmaxf(m1, fmaxf(mx1, other_max[rl1]));
        const float mu0 = ANY && mn0 <= kNegInf ? 0.f : mn0;
        const float mu1 = ANY && mn1 <= kNegInf ? 0.f : mn1;
        al0 = s9::exp2_approx((m0 - mu0) * c);
        al1 = s9::exp2_approx((m1 - mu1) * c);
        m0 = mn0;
        m1 = mn1;
        sub0 = mu0 * c;
        sub1 = mu1 * c;
      }

      // P = exp(scale * (S - m)) in bf16 into this group's half of the P
      // tile: row r, keys 8u .. 8u + 7 at unit u ^ (r % 8) of the row. A
      // masked logit is selected to 0.
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * j + e];
          pr[e] = s9::exp2_approx(fmaf(x, c, -(e < 2 ? sub0 : sub1)));
          if (ANY && x <= kNegInf) pr[e] = 0.f;  // selected
        }
        sum0 += pr[0] + pr[1];
        sum1 += pr[2] + pr[3];
        const int u = cw * (kHalf / 8) + j;
        *reinterpret_cast<__nv_bfloat162*>(
            p_tile + rl0 * 128 + ((u ^ (rl0 & 7)) << 4) + 4 * t) =
            __floats2bfloat162_rn(pr[0], pr[1]);
        *reinterpret_cast<__nv_bfloat162*>(
            p_tile + rl1 * 128 + ((u ^ (rl1 & 7)) << 4) + 4 * t) =
            __floats2bfloat162_rn(pr[2], pr[3]);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
      s9::fence_proxy_async();  // P's stores, visible to wgmma
      s9::named_barrier_sync(2, kConsumers);
      s9::mbar_wait(v_full, phase);

      // O[:, NC*cw ..] += P V: P K-major, V MN-major; the k-step kk is keys
      // 16kk .. 16kk + 15.
      s9::fence_regs(o);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        s9::wgmma_ss<NC, 1>(
            o, s9::smem_desc(p_s + kk * 32, 16, kAtom, 1),
            s9::smem_desc(v_s + (NC / W) * cw * kKChunk + kk * 16 * W * 2,
                          kKChunk, kAtom, 1),
            1);
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(o);
      s9::mbar_arrive(v_empty);  // V and, for the next tile, P are free
      phase ^= 1;
    }

    // Epilogue: the row sums of both halves; O / l and lse = m + log l (m in
    // scaled units with a bias).
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (t == 0) {
      stat[(2 + cw) * kBQ + rl0] = l0;
      stat[(2 + cw) * kBQ + rl1] = l1;
    }
    s9::named_barrier_sync(1, kConsumers);
    l0 += stat[(3 - cw) * kBQ + rl0];
    l1 += stat[(3 - cw) * kBQ + rl1];
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    const float to_ln = has_bias ? 1.f : p.scale;
    const float lse0 = l0 == 0.f ? kNegInf : m0 * to_ln + logf(l0);
    const float lse1 = l1 == 0.f ? kNegInf : m1 * to_ln + logf(l1);
    const long long row0 = static_cast<long long>(bh) * p.Lq + r0;
    if (p.splits == 1) {
      __nv_bfloat16* ob = p.out + b * p.os[0] + h * p.os[1];
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = NC * cw + 8 * j + 2 * t;
        if (col >= p.d) continue;  // padding columns are not written
        if (r0 < p.Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + r0 * p.os[2] + col) =
              __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (r1 < p.Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + r1 * p.os[2] + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      if (cw == 0 && t == 0) {
        if (r0 < p.Lq) p.lse[row0] = lse0;
        if (r1 < p.Lq) p.lse[row0 + 8] = lse1;
      }
    } else {
      float* wo = p.work + (split * p.rows + row0) * DP + NC * cw;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (r0 < p.Lq)
          *reinterpret_cast<float2*>(wo + col) =
              make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (r1 < p.Lq)
          *reinterpret_cast<float2*>(wo + 8 * DP + col) =
              make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      if (cw == 0 && t == 0) {
        float* wl = p.work + p.splits * p.rows * DP + split * p.rows;
        if (r0 < p.Lq) wl[row0] = lse0;
        if (r1 < p.Lq) wl[row0 + 8] = lse1;
      }
    }
  }
}

// The key splits of one row, merged by their lse: out = sum_s w_s O_s with
// w_s = exp(lse_s - lse), lse = log sum_s exp(lse_s); a split at -1e30 (no
// key of it visible) has weight 0. One block of DP / 8 threads per row, 8
// columns a thread; the columns past d are not written.
template <int DP>
__global__ void __launch_bounds__(DP / 8)
merge_d512_kernel(const float* __restrict__ work,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int H, int Lq, int d, int splits, long long rows,
                  long long os0, long long os1, long long os2) {
  const long long row = blockIdx.x;
  const int bh = static_cast<int>(row / Lq), r = static_cast<int>(row % Lq);
  const int b = bh / H, h = bh % H;
  const float* wl = work + splits * rows * DP;
  float ls[kMaxSplits], mx = kNegInf;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    ls[s] = s < splits ? wl[s * rows + row] : kNegInf;
    mx = fmaxf(mx, ls[s]);
  }
  float w[kMaxSplits], tot = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    w[s] = ls[s] <= kNegInf ? 0.f : expf(ls[s] - mx);  // selected, not exp'd
    tot += w[s];
  }
  const float inv = tot == 0.f ? 0.f : 1.f / tot;
  const int col = 8 * threadIdx.x;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s >= splits) break;
    if (w[s] == 0.f) continue;  // its O / l is 0 (and never read as NaN)
    const float4* src =
        reinterpret_cast<const float4*>(work + (s * rows + row) * DP + col);
    const float4 a = src[0], c = src[1];
    const float ws = w[s] * inv;
    acc[0] += ws * a.x;
    acc[1] += ws * a.y;
    acc[2] += ws * a.z;
    acc[3] += ws * a.w;
    acc[4] += ws * c.x;
    acc[5] += ws * c.y;
    acc[6] += ws * c.z;
    acc[7] += ws * c.w;
  }
  if (col < d) {
    __nv_bfloat16* ob = out + b * os0 + h * os1 + r * os2 + col;
#pragma unroll
    for (int i = 0; i < 8; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(ob + i) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
  if (threadIdx.x == 0) lse[row] = tot == 0.f ? kNegInf : mx + logf(tot);
}

// One launch at width DP (and its merge with key splits).
template <int DP, bool ANY>
cudaError_t launch(const void* q, const void* k, const void* v, int B,
                   const long long* strides, const Params& p,
                   cudaStream_t s) {
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv;
  cudaError_t err = s9::make_map(&tq, q, p.d, p.Lq, p.H, B, strides, W, kBQ,
                                 sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tk, k, p.d, p.Lk, p.H, B, strides + 3, W, kBK, sw);
  if (err == cudaSuccess)
    err = s9::make_map(&tv, v, p.d, p.Lk, p.H, B, strides + 6, W, kBK, sw);
  if (err == cudaSuccess)
    err = s9::launch_kernel(flash_fwd_d512_kernel<DP, ANY>,
                            B * p.H * p.n_qt * p.splits, kThreads,
                            Cfg<DP>::kSmemBytes, s, tq, tk, tv, p);
  if (err == cudaSuccess && p.splits > 1) {
    merge_d512_kernel<DP><<<static_cast<unsigned>(p.rows), DP / 8, 0, s>>>(
        p.work, p.out, p.lse, p.H, p.Lq, p.d, p.splits, p.rows, p.os[0],
        p.os[1], p.os[2]);
    err = cudaGetLastError();
  }
  return err;
}

template <int DP>
cudaError_t launch_width(bool any, const void* q, const void* k,
                         const void* v, int B, const long long* strides,
                         const Params& p, cudaStream_t s) {
  return any ? launch<DP, true>(q, k, v, B, strides, p, s)
             : launch<DP, false>(q, k, v, B, strides, p, s);
}

// The Params of a launch of B * H * ceil(Lq / 64) query tiles with
// `splits` key splits; no mask, no position.
Params make_params(void* out, void* lse, void* work, int B, int H, int Lq,
                   int Lk, int d, const long long* strides, float scale,
                   int splits) {
  Params p = {};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.work = static_cast<float*>(work);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.n_qt = (Lq + kBQ - 1) / kBQ;
  p.splits = splits;
  const int n_kt = (Lk + kBK - 1) / kBK;
  p.kt_per_split = (n_kt + splits - 1) / splits;
  p.rows = static_cast<long long>(B) * H * Lq;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.scale = scale;
  p.pos = PosArgs{nullptr, nullptr, Lq, Lk, 0, 0, 0};
  return p;
}

// The head dims (multiples of 8 from 264 to 512) and split counts (1 to 4,
// with their scratch above 1) the kernels take.
bool takes(int d, int splits, const void* work) {
  return splits >= 1 && splits <= kMaxSplits &&
         (splits == 1 || work != nullptr) && d > 256 && d <= 512 &&
         d % 8 == 0;
}

cudaError_t launch_d(int d, bool any, const void* q, const void* k,
                     const void* v, int B, const long long* strides,
                     const Params& p, cudaStream_t s) {
  return d <= 384 ? launch_width<384>(any, q, k, v, B, strides, p, s)
                  : launch_width<512>(any, q, k, v, B, strides, p, s);
}

}  // namespace

// K1 above head dim 256. strides: 16 element strides, (batch, head, seq) for
// q, k, v, out, then (batch, head, row, col) for the bias; the head-dim
// stride is 1. lse is (B, H, Lq) contiguous fp32. bias (fp32, or bf16 when
// bias_bf16) and the six segment arrays of mask.cuh (at (64, 64) tiles) are
// null when the form is not asked for. d: the head dim, a multiple of 8 from
// 264 to 512, run at DP = 384 (up to 384) or 512 (the columns past d read as
// zeros and not written). splits (1 to 4) key splits per query tile; with
// more than one, `work` is fp32 scratch of splits * B * H * Lq * (DP + 1)
// values. Returns cudaErrorInvalidValue for a head dim or split count
// outside those ranges or without its scratch.
extern "C" int fdsd_flash_fwd_d512(const void* q, const void* k, const void* v,
                                   void* out, void* lse, void* work,
                                   const void* bias, const void* q_ids,
                                   const void* kv_ids, const void* q_bounds,
                                   const void* kv_bounds, const void* lo,
                                   const void* hi, int B, int H, int Lq,
                                   int Lk, int d, const long long* strides,
                                   float scale, int causal, int bias_bf16,
                                   int splits, void* stream) {
  if (!takes(d, splits, work)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(out, lse, work, B, H, Lq, Lk, d, strides, scale,
                         splits);
  p.pos.causal = causal != 0;  // by index: the positions with offsets 0
  p.m = fdsd::make_mask_args(bias, strides + 12, bias_bf16, q_ids, kv_ids,
                             q_bounds, kv_bounds, lo, hi);
  const bool any = causal != 0 || bias != nullptr || q_ids != nullptr;
  return static_cast<int>(launch_d(d, any, q, k, v, B, strides, p,
                                   static_cast<cudaStream_t>(stream)));
}

// K5 above head dim 256, called by fdsd_flash_fwd_pos
// (flash_attention_sm90.cu) with its arguments (strides: 12 element strides,
// (batch, head, seq) for q, k, v, out; q_off and k_off int32[2] in device
// memory; the scratch and key splits of fdsd_flash_fwd_d512), at the head
// dims and split counts of fdsd_flash_fwd_d512. Without causal, valid_len
// and bounded it runs the no-mask instantiation (offsets unread), else ANY
// with the positions.
namespace fdsd::d512 {

cudaError_t fwd_pos(const void* q, const void* k, const void* v, void* out,
                    void* lse, const void* q_off, const void* k_off,
                    void* work, int B, int H, int Lq, int Lk, int d,
                    const long long* strides, float scale, int seg_q,
                    int seg_k, int valid_len, int has_valid, int causal,
                    int bounded, int splits, cudaStream_t stream) {
  if (!takes(d, splits, work)) return cudaErrorInvalidValue;
  Params p = make_params(out, lse, work, B, H, Lq, Lk, d, strides, scale,
                         splits);
  p.pos = PosArgs{static_cast<const int*>(q_off),
                  static_cast<const int*>(k_off), seg_q, seg_k, valid_len,
                  has_valid != 0, causal != 0};
  p.bounded = bounded != 0;
  const bool any = causal != 0 || has_valid != 0 || bounded != 0;
  return launch_d(d, any, q, k, v, B, strides, p, stream);
}

}  // namespace fdsd::d512
