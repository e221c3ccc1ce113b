// The fp32 flash forward's streaming kernel: K1 and K5 on fp32 inputs on the
// tensor cores at the padded widths DP = 192, 224, 256 (head dims 161 to 256
// rounded up to 32; the columns past d read as TMA's zeros and not written)
// in four forms (WideForm: no mask; causal; ANY, the position masks, a bias
// and segment ids chosen per launch; the position masks under the bounded
// softmax), and K1 and K5 at 384 (head dims 257 to 384) and 512 (385 to
// 512): without a mask (K1), causal (K1), ANY (K1's masks, K5 online) and
// bounded (K5), with key splits (at 512 without a mask: the VAEs' mid
// attention). The width kernels are instantiated a few to a
// file in flash_f32_fwd_w*.cu, so that the build compiles them in parallel;
// flash_f32_fwd.cu holds the d = 512 kernel, the key-split merge, the split
// pre-pass, the tensor maps and the C entry.
//
// Replaces, for fp32 q, k, v at those head dims, the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_wide
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel
// under Precision.HIGHEST (tiny-SD's UNet in fp32: d = 192 once a step at
// `channel: 96`). The contract and the numerical plan are those of the
// kernels up to 160 (flash_f32_fwd.cu): the three-term TF32 split after the
// split pre-pass, into the same workspace; P split in registers, the row sums
// adding the fp32 P; a row that sees no key gives out = 0 and lse = -1e30; a
// masked probability is selected to 0.
//
// What bounds it on the H100: operations, three TF32 passes of 4 Lq Lk d
// flop at 495 TFLOP/s. What stopped the kernel up to 160 here is shared
// memory: it keeps both split terms of the 64-query Q tile resident, 512 B a
// column each, 192 KB at DP = 192 before any K or V tile. So nothing stays
// resident. One block of three warpgroups per (b*h, 64 queries, key split):
//  - a producer thread streams, for each 64-key tile, the Q and K hi / lo
//    terms of d in chunks of 64 columns (the last one 32 at DP = 224) and
//    then v^T hi / lo in kVSlots pieces, all through a ring of three 64 KB
//    slots with full / empty mbarriers; Q is reloaded from L2 every key
//    tile (a 64-query tile's terms are read Lk / 64 times), which is what
//    the d = 512 kernel, the model of this one, does at 58 % of its bound;
//  - two consumer warpgroups split S = Q K^T by keys (32 each: m64n32k8
//    SS) and own DP / 2 output columns each: each chunk of S goes into a
//    fresh accumulator added to S in registers, the row maxima are
//    exchanged through shared memory under a named barrier, P hi / lo are
//    written to a shared tile (64 x 64, 128-byte swizzle, keys in v^T's
//    order), and each consumer runs O += P V over its columns, one V slot at
//    a time (m64nRk8 SS, R = DP / (2 kVSlots): 48, 56, 64), each into a
//    fresh accumulator added to O in registers.
// The rounding hazard of the TF32 accumulators (they add rounding toward
// zero): no chain of wgmmas into one accumulator is longer than 3 x 64 / 8
// = 24; S at DP = 256 is four chains, added in registers rounded to nearest.
// Causal (key <= query from index 0 on both sides) visits key tiles up to
// the query tile's own (the query tiles walked from the last, long rows
// first) and masks per logit on that diagonal tile only; the key tail is
// masked on the last tile only. ANY judges each (query tile, key tile) pair
// by pos_pair and the segment tiles' id ranges in every role, as the
// resident kernel does, reads the bias from global memory into each
// consumer's logits, and selects a masked logit to probability 0; the
// bounded form keeps the max at 0 and exchanges no row maxima. No key split
// up to 256: at the shapes the paths give these widths (>= 512 query tiles)
// the tiles fill the card. Above 256 a split that a row sees no key of
// (skipped tiles, past valid_len, above the diagonal) writes lse -1e30 and
// O = 0, and weighs 0 in the merge; a bounded split's lse is log of its sum
// under the fixed max 0.
// Against the layout kept resident up to 160, this one moves more bytes
// through L2 and the slots and needs no resident tile: it is the layout
// that exists at every width up to 512.

#pragma once

#include <type_traits>

#include "../mask.cuh"
#include "../pos_tile.cuh"
#include "../sm90.cuh"

namespace fdsd::f32fwd {

namespace s9 = fdsd::sm90;

// The forms of the streaming kernel: no mask; causal (key <= query from
// index 0); every mask chosen per launch (ANY: the position masks of
// pos_tile.cuh, an additive bias and segment ids, online softmax); the
// position masks under the bounded softmax (max fixed at 0).
enum WideForm { kWidePlain = 0, kWideCausal = 1, kWideAny = 2,
                kWideBounded = 3 };

constexpr float kWideNegInf = -1e30f;
constexpr float kWideLog2e = 1.4426950408889634f;
constexpr int kWideThreads = 384;    // producer + two consumer warpgroups
constexpr int kWideConsumers = 256;
constexpr int kWideProducerRegs = 40, kWideConsumerRegs = 232;

template <int DP>
struct WideCfg {
  static constexpr int kBQ = 64, kBK = 64, kHalf = kBK / 2;
  // S chunks of 64 columns a key tile (the last 32 wide at DP = 224)
  static constexpr int kSChunks = (DP + 63) / 64;
  // V slots a key tile: each holds kVRows v^T rows of each consumer
  static constexpr int kVSlots = (DP / 2 + 63) / 64;
  static constexpr int kVRows = DP / 2 / kVSlots;
  static constexpr int kSlots = 3, kSlotBytes = 65536;
  // S slot c: Q hi, Q lo, K hi, K lo, each 64 rows x two 128-byte swizzle
  // chunks of 32 columns (kChunk bytes a chunk). V slot j: for consumer w at
  // 4 kVChunk * w, v^T hi then lo of rows DP / 2 * w + kVRows j .., two
  // chunks of 32 keys each.
  static constexpr int kChunk = 64 * 128;
  static constexpr int kVChunk = kVRows * 128;
  static constexpr int kPOff = kSlots * kSlotBytes;  // P hi, P lo: 16 KB each
  static constexpr int kStatOff = kPOff + 2 * 2 * kChunk;  // max, sum: 2 x 2
  static constexpr int kBarOff = kStatOff + 4 * kBQ * 4;
  static constexpr int kBars = 2 * kSlots;  // full, empty per slot
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + align
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(DP % 32 == 0 && DP / 2 % kVSlots == 0 && kVRows % 8 == 0 &&
                    8 * kVChunk <= kSlotBytes,
                "width");
};

struct WideParams {
  float* out;
  float* lse;
  float* work;  // splits > 1: O / l (splits, rows, DP), then lse (splits, rows)
  int B, H, Lq, Lk, d, n_qt, splits, kt_per_split;
  long long rows;   // B * H * Lq
  long long os[3];  // out's (batch, head, seq) element strides
  float scale;
  PosArgs pos;  // ANY and bounded: null offsets read as 0
  MaskArgs m;   // ANY: the fp32 bias and the segment arrays at (64, 64)
};

template <int N>
using Steps = std::integral_constant<int, N>;

// One chunk of S = Q K^T (STEPS k-steps of 8 columns) for this consumer's 32
// keys, three passes, into a fresh accumulator `part`; sb: the S slot.
template <int STEPS>
__device__ __forceinline__ void s_chunk(float (&part)[16], uint32_t sb,
                                        int cw) {
  constexpr int kChunk = 64 * 128;
  s9::fence_regs(part);
  s9::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
    const uint32_t ka = sb + 4 * kChunk + off + cw * 32 * 128;
    const uint64_t qh = s9::smem_desc(sb + off, 16, 1024, 1);
    const uint64_t ql = s9::smem_desc(sb + 2 * kChunk + off, 16, 1024, 1);
    const uint64_t kh = s9::smem_desc(ka, 16, 1024, 1);
    const uint64_t kl = s9::smem_desc(ka + 2 * kChunk, 16, 1024, 1);
    s9::wgmma_tf32_ss<32>(part, ql, kh, kk > 0);
    s9::wgmma_tf32_ss<32>(part, qh, kl, 1);
    s9::wgmma_tf32_ss<32>(part, qh, kh, 1);
  }
  s9::wgmma_commit();
  s9::wgmma_wait<0>();
  s9::fence_regs(part);
}

// The block's work: tq, tk (d, L, H, 2B) boxes of 32 columns x 64 rows, tv
// (Lk8, d, H, 2B) boxes of 32 keys x kVRows rows, over the workspace's
// split terms. FORM: a WideForm.
template <int DP, int FORM>
__device__ __forceinline__ void wide_body(const CUtensorMap& tq,
                                          const CUtensorMap& tk,
                                          const CUtensorMap& tv,
                                          const WideParams& p) {
  using C = WideCfg<DP>;
  constexpr int kBK = C::kBK, kHalf = C::kHalf, kVR = C::kVRows;
  constexpr float kNegInf = kWideNegInf;
  constexpr bool CAUSAL = FORM == kWideCausal;
  constexpr bool ANY = FORM == kWideAny || FORM == kWideBounded;
  constexpr bool BOUNDED = FORM == kWideBounded;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = s9::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  // [max of consumer 0 | max of consumer 1 | sum 0 | sum 1], kBQ rows each
  float* stat = reinterpret_cast<float*>(smem + C::kStatOff);
  const uint32_t p_s = base + C::kPOff;
  const uint32_t full0 = base + C::kBarOff, empty0 = full0 + 8 * C::kSlots;

  const int tid = threadIdx.x;
  const int split = blockIdx.x % p.splits;
  const int tile = blockIdx.x / p.splits;
  const int bh = tile / p.n_qt;
  int qt = tile % p.n_qt;
  if (CAUSAL || (ANY && p.pos.causal)) qt = p.n_qt - 1 - qt;  // long rows first
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * C::kBQ;
  const int n_kt = (p.Lk + kBK - 1) / kBK;
  int kt_begin = split * p.kt_per_split;
  int kt_end = min(n_kt, kt_begin + p.kt_per_split);
  // causal: the key tiles holding a key <= the tile's last query
  if (CAUSAL) kt_end = min(kt_end, (q0 + C::kBQ - 1) / kBK + 1);
  // ANY: positions matter only to a mask (without causal and valid_len the
  // offsets are not read); segment ids walk the tile range [lo, hi] of
  // mask.cuh and skip a tile whose ids are disjoint from this one's
  const bool masked = ANY && (p.pos.causal || p.pos.has_valid);
  const bool has_bias = ANY && p.m.bias != nullptr;
  const bool has_seg = ANY && p.m.q_ids != nullptr;
  int q_off0 = 0, q_off1 = 0, k_off0 = 0, k_off1 = 0;
  if (masked && p.pos.q_off != nullptr) {
    q_off0 = p.pos.q_off[0];
    q_off1 = p.pos.q_off[1];
  }
  if (masked && p.pos.k_off != nullptr) {
    k_off0 = p.pos.k_off[0];
    k_off1 = p.pos.k_off[1];
  }
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
  // masked per logit; the same call in every role keeps the slots in step
  auto pair = [&](int kt) {
    if (!ANY) return 1;
    int state = 1;
    if (masked) {
      int q_lo, q_hi, k_lo, k_hi;
      pos_bounds(q0, C::kBQ, q_off0, q_off1, p.pos.seg_q, p.Lq, q_lo, q_hi);
      pos_bounds(kt * kBK, kBK, k_off0, k_off1, p.pos.seg_k, p.Lk, k_lo,
                 k_hi);
      state = pos_pair(p.pos, q_lo, q_hi, k_lo, k_hi);
    }
    if (has_seg && state != 0)
      state = seg_overlap(q_bound, k_bounds + 2 * kt) ? 2 : 0;
    return state;
  };

  if (tid == 0) {
    for (int s = 0; s < C::kSlots; ++s) {
      s9::mbar_init(full0 + 8 * s, 1);
      s9::mbar_init(empty0 + 8 * s, kWideConsumers);
    }
    s9::mbar_init_fence();
  } else if (tid == 32) {
    s9::prefetch_tensormap(&tq);
    s9::prefetch_tensormap(&tk);
    s9::prefetch_tensormap(&tv);
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
    s9::reg_dealloc<kWideProducerRegs>();
    if (tid != 0) return;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      if (pair(kt) == 0) continue;
      const int k0 = kt * kBK;
      for (int c = 0; c < C::kSChunks; ++c) {  // S slots
        const int halves = min(2, (DP - 64 * c) / 32);
        const uint32_t full = full0 + 8 * slot;
        const uint32_t sb = base + slot * C::kSlotBytes;
        s9::mbar_wait(empty0 + 8 * slot, phase ^ 1);
        s9::mbar_expect_tx(full, 4 * halves * C::kChunk);
        for (int term = 0; term < 2; ++term)
          for (int half = 0; half < halves; ++half) {
            const uint32_t at = sb + term * 2 * C::kChunk + half * C::kChunk;
            s9::tma_load_4d(at, &tq, full, 64 * c + 32 * half, q0, h,
                            b + term * p.B);
            s9::tma_load_4d(at + 4 * C::kChunk, &tk, full,
                            64 * c + 32 * half, k0, h, b + term * p.B);
          }
        next();
      }
      for (int j = 0; j < C::kVSlots; ++j) {  // V slots
        const uint32_t full = full0 + 8 * slot;
        const uint32_t sb = base + slot * C::kSlotBytes;
        s9::mbar_wait(empty0 + 8 * slot, phase ^ 1);
        s9::mbar_expect_tx(full, 8 * C::kVChunk);
        for (int w = 0; w < 2; ++w)
          for (int term = 0; term < 2; ++term)
            for (int kc = 0; kc < 2; ++kc)
              s9::tma_load_4d(
                  sb + (2 * w + term) * 2 * C::kVChunk + kc * C::kVChunk,
                  &tv, full, k0 + 32 * kc, DP / 2 * w + kVR * j, h,
                  b + term * p.B);
        next();
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  s9::reg_alloc<kWideConsumerRegs>();
  const int cw = (tid - 128) / 128;  // keys 32cw .. of S, columns DP/2 cw ..
  const int warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = 16 * warp + g, rl1 = rl0 + 8;  // tile rows
  const int r0 = q0 + rl0, r1 = q0 + rl1;
  // exp(x * scale) = exp2(x * c); with a bias the logits are scaled first
  const float c = has_bias ? kWideLog2e : p.scale * kWideLog2e;
  // running row max (logit units; bounded: fixed at 0)
  float m0 = BOUNDED ? 0.f : kNegInf, m1 = m0;
  float l0 = 0.f, l1 = 0.f;  // this thread's share of its half's row sums
  float o[C::kVSlots][kVR / 2];  // output columns DP/2 cw + kVR j ..
#pragma unroll
  for (int j = 0; j < C::kVSlots; ++j)
#pragma unroll
    for (int i = 0; i < kVR / 2; ++i) o[j][i] = 0.f;
  float s[kHalf / 2], part[kHalf / 2];  // S, and one chunk's share of it
  float* my_max = stat + cw * C::kBQ;
  const float* other_max = stat + (1 - cw) * C::kBQ;
  // ANY: the positions and segment ids of this thread's two rows
  int qpos0 = 0, qpos1 = 0, qid0 = -1, qid1 = -1;
  if (masked) {
    qpos0 = pos_of(r0, q_off0, q_off1, p.pos.seg_q);
    qpos1 = pos_of(r1, q_off0, q_off1, p.pos.seg_q);
  }
  const int* kv_ids = nullptr;
  if (has_seg) {
    kv_ids = p.m.kv_ids + static_cast<long long>(b) * p.Lk;
    const int* ids = p.m.q_ids + static_cast<long long>(b) * p.Lq;
    if (r0 < p.Lq) qid0 = ids[r0];
    if (r1 < p.Lq) qid1 = ids[r1];
  }
  const long long bias_base = has_bias ? b * p.m.bs[0] + h * p.m.bs[1] : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int state = pair(kt);
    if (state == 0) continue;
    const int k0 = kt * kBK;
    // S = Q K^T for keys 32cw .. 32cw + 31 over the chunks of d, each chunk
    // into a fresh accumulator added to S in registers.
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) s[i] = 0.f;
    auto chunk = [&](auto steps) {
      const uint32_t sb = base + slot * C::kSlotBytes;
      s9::mbar_wait(full0 + 8 * slot, phase);
      s_chunk<decltype(steps)::value>(part, sb, cw);
      s9::mbar_arrive(empty0 + 8 * slot);
      next();
#pragma unroll
      for (int i = 0; i < kHalf / 2; ++i) s[i] += part[i];
    };
    for (int cc = 0; cc < DP / 64; ++cc) chunk(Steps<8>());
    if constexpr (DP % 64 != 0) chunk(Steps<4>());  // the last 32 columns

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
                                 ? load_bias(p.m, bias_base, row, key)
                                 : 0.f;
          s[4 * j + e] = fmaf(s[4 * j + e], p.scale, bias);
        }
    }

    // The key tail (last tile only) and, causal, the diagonal tile's keys
    // past each row's query; ANY: the position masks and segment ids where
    // the pair needs them. The key tail is masked after the bias, which
    // narrows it and never replaces it.
    const bool diag = CAUSAL && k0 + kBK - 1 > q0;
    if (k0 + kBK > p.Lk || diag || state == 2) {
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = k0 + kHalf * cw + 8 * j + 2 * t + u;
          bool v0 = key < p.Lk, v1 = v0;
          if (diag) {
            v0 = v0 && key <= r0;
            v1 = v1 && key <= r1;
          }
          if (masked && state == 2) {
            const int kpos = pos_of(key, k_off0, k_off1, p.pos.seg_k);
            if (p.pos.has_valid && kpos >= p.pos.valid_len) v0 = v1 = false;
            if (p.pos.causal) {
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
    // bounded softmax keeps 0); a row with nothing visible yet subtracts 0.
    float al0 = 1.f, al1 = 1.f, sub0 = 0.f, sub1 = 0.f;
    if (!BOUNDED) {
      float mx0 = kNegInf, mx1 = kNegInf;
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
      s9::named_barrier_sync(1, kWideConsumers);
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

    // P = exp(scale (S - m)) split into hi / lo in this group's half of the
    // P tiles: key 2t of a group of 8 at position t, key 2t + 1 at t + 4
    // (v^T's order); row r, positions 4u .. 4u + 3 of a chunk at unit
    // u ^ (r % 8) of the row. A masked logit is selected to 0.
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * j + e];
        float pr = s9::exp2_approx(fmaf(x, c, -(e < 2 ? sub0 : sub1)));
        if ((CAUSAL || ANY) && x <= kNegInf) pr = 0.f;  // selected
        if (e < 2)
          sum0 += pr;
        else
          sum1 += pr;
        const int r = e < 2 ? rl0 : rl1, u = 2 * j + (e & 1);
        unsigned char* at = smem + C::kPOff + cw * C::kChunk + r * 128 +
                            ((u ^ (r & 7)) << 4) + 4 * t;
        const uint32_t hi = s9::to_tf32(pr);
        *reinterpret_cast<uint32_t*>(at) = hi;
        *reinterpret_cast<uint32_t*>(at + 2 * C::kChunk) =
            s9::to_tf32(pr - __uint_as_float(hi));
      }
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int j = 0; j < C::kVSlots; ++j)
#pragma unroll
      for (int i = 0; i < kVR / 8; ++i) {
        o[j][4 * i] *= al0;
        o[j][4 * i + 1] *= al0;
        o[j][4 * i + 2] *= al1;
        o[j][4 * i + 3] *= al1;
      }
    s9::fence_proxy_async();  // P's stores, visible to wgmma
    s9::named_barrier_sync(2, kWideConsumers);

    // O[:, DP/2 cw + kVR j ..] += P V over the V slots, three passes each,
    // into a fresh accumulator added to O in registers.
#pragma unroll
    for (int j = 0; j < C::kVSlots; ++j) {
      const uint32_t sb =
          base + slot * C::kSlotBytes + cw * 4 * C::kVChunk;
      float acc[kVR / 2];
      s9::mbar_wait(full0 + 8 * slot, phase);
      s9::fence_regs(acc);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const uint32_t off = (kk / 4) * C::kChunk + (kk % 4) * 32;
        const uint32_t voff = (kk / 4) * C::kVChunk + (kk % 4) * 32;
        const uint64_t ph = s9::smem_desc(p_s + off, 16, 1024, 1);
        const uint64_t pl =
            s9::smem_desc(p_s + 2 * C::kChunk + off, 16, 1024, 1);
        const uint64_t vh = s9::smem_desc(sb + voff, 16, 1024, 1);
        const uint64_t vl =
            s9::smem_desc(sb + 2 * C::kVChunk + voff, 16, 1024, 1);
        s9::wgmma_tf32_ss<kVR>(acc, pl, vh, kk > 0);
        s9::wgmma_tf32_ss<kVR>(acc, ph, vl, 1);
        s9::wgmma_tf32_ss<kVR>(acc, ph, vh, 1);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_regs(acc);
      s9::mbar_arrive(empty0 + 8 * slot);
      next();
#pragma unroll
      for (int i = 0; i < kVR / 2; ++i) o[j][i] += acc[i];
    }
  }

  // Epilogue: the row sums of both halves; O / l and lse = m scale + log l.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (t == 0) {
    stat[(2 + cw) * C::kBQ + rl0] = l0;
    stat[(2 + cw) * C::kBQ + rl1] = l1;
  }
  s9::named_barrier_sync(1, kWideConsumers);
  l0 += stat[(3 - cw) * C::kBQ + rl0];
  l1 += stat[(3 - cw) * C::kBQ + rl1];
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  const float to_ln = has_bias ? 1.f : p.scale;  // m in scaled units: 1
  const float lse0 = l0 == 0.f ? kNegInf : m0 * to_ln + logf(l0);
  const float lse1 = l1 == 0.f ? kNegInf : m1 * to_ln + logf(l1);
  const long long row0 = static_cast<long long>(bh) * p.Lq + r0;
  float* ob;
  long long stride;
  if (p.splits == 1) {
    ob = p.out + b * p.os[0] + h * p.os[1] + r0 * p.os[2];
    stride = p.os[2];
  } else {
    ob = p.work + (split * p.rows + row0) * DP;
    stride = DP;
  }
#pragma unroll
  for (int j = 0; j < C::kVSlots; ++j)
#pragma unroll
    for (int i = 0; i < kVR / 8; ++i) {
      const int col = DP / 2 * cw + kVR * j + 8 * i + 2 * t;
      if (col >= p.d) continue;
      if (r0 < p.Lq)
        *reinterpret_cast<float2*>(ob + col) =
            make_float2(o[j][4 * i] * inv0, o[j][4 * i + 1] * inv0);
      if (r1 < p.Lq)
        *reinterpret_cast<float2*>(ob + 8 * stride + col) =
            make_float2(o[j][4 * i + 2] * inv1, o[j][4 * i + 3] * inv1);
    }
  if (cw == 0 && t == 0) {
    float* lb = p.splits == 1 ? p.lse
                              : p.work + p.splits * p.rows * DP + split * p.rows;
    if (r0 < p.Lq) lb[row0] = lse0;
    if (r1 < p.Lq) lb[row0 + 8] = lse1;
  }
}

// K1 (and K5 with the position masks) at the widths 192, 224, 256 in the
// WideForm FORM.
template <int DP, int FORM>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_f32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ WideParams p) {
  wide_body<DP, FORM>(tq, tk, tv, p);
}

// One launch of the width DP in the WideForm `form` on B * H * n_qt *
// splits blocks.
template <int DP>
cudaError_t launch_wide(int form, const CUtensorMap& tq,
                        const CUtensorMap& tk, const CUtensorMap& tv,
                        const WideParams& p, cudaStream_t s) {
  const int grid = p.B * p.H * p.n_qt * p.splits;
  switch (form) {
#define FDSD_FORM(F)                                                        \
  case F:                                                                   \
    return s9::launch_kernel(flash_fwd_f32_wide_kernel<DP, F>, grid,        \
                             kWideThreads, WideCfg<DP>::kSmemBytes, s, tq,  \
                             tk, tv, p);
    FDSD_FORM(kWidePlain)
    FDSD_FORM(kWideCausal)
    FDSD_FORM(kWideAny)
    FDSD_FORM(kWideBounded)
#undef FDSD_FORM
  }
  return cudaErrorInvalidValue;
}

// K1 and K5 above head dim 256 at the width DP (384: head dims 257 to 384;
// 512: 385 to 512) in the WideForm `form`: without a mask at 384 (512's is
// flash_fwd_f32_d512_kernel of flash_f32_fwd.cu), causal, ANY (K1's masks,
// K5 online) and bounded (K5) at both, on B * H * n_qt * splits blocks (the
// key splits merged by the caller).
template <int DP>
cudaError_t launch_wide_k1(int form, const CUtensorMap& tq,
                           const CUtensorMap& tk, const CUtensorMap& tv,
                           const WideParams& p, cudaStream_t s) {
  const int grid = p.B * p.H * p.n_qt * p.splits;
  constexpr int kSmem = WideCfg<DP>::kSmemBytes;
  if constexpr (DP != 512) {
    if (form == kWidePlain)
      return s9::launch_kernel(flash_fwd_f32_wide_kernel<DP, kWidePlain>,
                               grid, kWideThreads, kSmem, s, tq, tk, tv, p);
  }
  if (form == kWideCausal)
    return s9::launch_kernel(flash_fwd_f32_wide_kernel<DP, kWideCausal>, grid,
                             kWideThreads, kSmem, s, tq, tk, tv, p);
  if (form == kWideAny)
    return s9::launch_kernel(flash_fwd_f32_wide_kernel<DP, kWideAny>, grid,
                             kWideThreads, kSmem, s, tq, tk, tv, p);
  if (form == kWideBounded)
    return s9::launch_kernel(flash_fwd_f32_wide_kernel<DP, kWideBounded>,
                             grid, kWideThreads, kSmem, s, tq, tk, tv, p);
  return cudaErrorInvalidValue;
}

// The explicit instantiation of launch_wide<DP> (with `extern` before it: its
// declaration); each width is instantiated in one flash_f32_fwd_w*.cu, as
// launch_wide_k1<DP> at 384 and 512.
#define FDSD_F32_FWD_WIDE(DP)                                               \
  template cudaError_t launch_wide<DP>(int, const CUtensorMap&,             \
                                       const CUtensorMap&, const CUtensorMap&, \
                                       const WideParams&, cudaStream_t);
#define FDSD_F32_FWD_WIDTHS(X) X(192) X(224) X(256)
#define FDSD_F32_FWD_EXTERN(DP) extern FDSD_F32_FWD_WIDE(DP)
FDSD_F32_FWD_WIDTHS(FDSD_F32_FWD_EXTERN)
#undef FDSD_F32_FWD_EXTERN
#define FDSD_F32_FWD_K1(DP)                                                 \
  template cudaError_t launch_wide_k1<DP>(                                  \
      int, const CUtensorMap&, const CUtensorMap&, const CUtensorMap&,      \
      const WideParams&, cudaStream_t);
extern FDSD_F32_FWD_K1(384)
extern FDSD_F32_FWD_K1(512)

}  // namespace fdsd::f32fwd
