// Position-masked flash-attention forward for Hopper (sm_90a): bf16 in,
// fp32 softmax, out bf16 + lse fp32. K5.
//
// Replaces the Pallas TPU kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_pos
// (reached through flash_attention_pos): attention of a LOCAL block of
// queries against a LOCAL block of keys whose GLOBAL positions are
//   pos(idx) = off[0] + idx          if idx <  seg
//            = off[1] + (idx - seg)  otherwise
// for queries and keys separately; off are int32[2] arrays in device memory,
// read here. A key is masked when its index is >= Lk, when its position is
// >= valid_len (if given), and when its position is > the query's position
// (if causal). A (query tile, key tile) pair with nothing visible is skipped
// from the scalar position bounds of the two tiles, and a pair with nothing
// masked skips the per-logit mask. A row with no visible key gives out = 0
// and lse = -1e30, so a log-sum-exp merge gives it weight 0. BOUNDED is the
// fixed-max softmax (max 0: no max reduction, no rescale; lse = log l),
// exact while every logit stays inside the fp32 exp range.
// On the SD3 path (split-KV joint attention) it runs four times per MMDiT
// block at B*H = 48, d = 64, (Lq, Lk) in {(154,154), (154,4096),
// (4096,154), (4096,4096)}, offsets 0, no causal, no valid_len.
//
// What bounds it on the H100: at 4096 x 4096 keys it does 4*Lq*Lk*d flop on
// (2*Lq + 2*Lk)*d*2 bytes, ~2,000 flop per byte: operations, so the rate of
// tensor-core instructions and the exponentials; the 154-token calls are launch bound.
// The design keeps the softmax in registers: one block of 4 warps per
// (b*h, 64 queries), each warp 16 query rows; S = Q K^T from mma.sync
// m16n8k16 stays in the accumulators, whose layout is the A-operand layout
// of P V, so P never touches shared memory; row max and sum need two
// shuffles inside a quad. K and V tiles (64 keys) go through shared memory
// as they lie, read with ldmatrix (transposed for V), rows padded by 16
// bytes against bank conflicts; Q fragments are loaded once. 27 KB (d = 64)
// or 51 KB (d = 128) of shared memory, so several blocks share an SM and
// one block's loads hide behind another's products. q, k, v are read
// through their strides, out is written through its own; ragged edges are
// masked here, nothing is padded in device memory.
// Not carried over from the TPU kernel: the ones-column row sum on the
// matrix unit, the (rows, 128) max / sum scratch, the exp2 / fma probe arms,
// 1024-wide blocks and padded input copies.
// Later work: wgmma + TMA, cp.async double buffering, one launch for the
// four calls of the joint attention and their merge.

#include "mma.cuh"
#include "pos_tile.cuh"

namespace {

using fdsd::ld32;
using fdsd::ldmatrix_x4;
using fdsd::ldmatrix_x4_trans;
using fdsd::load_tile;
using fdsd::mma16816;
using fdsd::pack_bf16;
using fdsd::pos_bounds;
using fdsd::pos_of;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64, kBK = 64, kThreads = 128;

struct PosParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  float* lse;
  const int* q_off;
  const int* k_off;
  int H, Lq, Lk;
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, seq) element strides
  float scale;
  int seg_q, seg_k, valid_len, has_valid, causal;
};

template <int D, bool BOUNDED>
__global__ void __launch_bounds__(kThreads)
flash_fwd_pos_kernel(const PosParams p) {
  constexpr int kStride = D + 8;     // bf16 per shared row
  constexpr int kSTiles = kBK / 8;   // key n-tiles of S per warp
  constexpr int kOTiles = D / 8;     // head-dim n-tiles of O per warp
  constexpr int kDSteps = D / 16;    // k-steps of Q K^T
  constexpr int kKSteps = kBK / 16;  // k-steps of P V

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + kBQ * kStride;
  __nv_bfloat16* v_s = k_s + kBK * kStride;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int q_off0 = p.q_off[0], q_off1 = p.q_off[1];
  const int k_off0 = p.k_off[0], k_off1 = p.k_off[1];

  const __nv_bfloat16* kb = p.k + b * p.ks[0] + h * p.ks[1];
  const __nv_bfloat16* vb = p.v + b * p.vs[0] + h * p.vs[1];

  load_tile<D, kBQ>(q_s, p.q + b * p.qs[0] + h * p.qs[1], p.qs[2], q0, p.Lq,
                    tid);
  __syncthreads();
  uint32_t qf[kDSteps][4];
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    const __nv_bfloat16* qa = q_s + (row0 + g) * kStride + kk * 16 + 2 * t;
    qf[kk][0] = ld32(qa);
    qf[kk][1] = ld32(qa + 8 * kStride);
    qf[kk][2] = ld32(qa + 8);
    qf[kk][3] = ld32(qa + 8 * kStride + 8);
  }

  // This thread's two query rows, and the position bounds of the q tile.
  const int qpos0 = pos_of(q0 + row0 + g, q_off0, q_off1, p.seg_q);
  const int qpos1 = pos_of(q0 + row0 + g + 8, q_off0, q_off1, p.seg_q);
  int min_rp = 0, max_rp = 0;
  if (p.causal)
    pos_bounds(q0, kBQ, q_off0, q_off1, p.seg_q, p.Lq, min_rp, max_rp);

  const float c = p.scale * kLog2e;  // exp(scale * s) = exp2(c * s)
  float m0 = kNegInf, m1 = kNegInf;  // running max of the raw logits
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  float o[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int n_kt = (p.Lk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    // Whole-tile decisions, the same for every thread of the block.
    int min_cp, max_cp;
    pos_bounds(k0, kBK, k_off0, k_off1, p.seg_k, p.Lk, min_cp, max_cp);
    if ((p.has_valid && min_cp >= p.valid_len) ||
        (p.causal && min_cp > max_rp))
      continue;
    const bool need_mask = k0 + kBK > p.Lk ||
                           (p.has_valid && max_cp >= p.valid_len) ||
                           (p.causal && max_cp > min_rp);

    __syncthreads();  // the previous tile's readers of k_s and v_s are done
    load_tile<D, kBK>(k_s, kb, p.ks[2], k0, p.Lk, tid);
    load_tile<D, kBK>(v_s, vb, p.vs[2], k0, p.Lk, tid);
    __syncthreads();

    // S = Q K^T (raw logits) for this warp's 16 rows x 64 keys.
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kSTiles / 2; ++jp) {
        // matrices: (keys jp*16.., dims kk*16..), (same keys, dims +8),
        // (keys +8, dims +0), (keys +8, dims +8)
        uint32_t bk[4];
        ldmatrix_x4(bk, k_s + (jp * 16 + (lane & 7) + 8 * (lane >> 4)) * kStride +
                            kk * 16 + 8 * ((lane >> 3) & 1));
        mma16816(s[2 * jp], qf[kk], bk);
        mma16816(s[2 * jp + 1], qf[kk], bk + 2);
      }
    }

    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int cp = pos_of(col, k_off0, k_off1, p.seg_k);
          bool visible = col < p.Lk;
          if (p.has_valid) visible = visible && cp < p.valid_len;
          if (p.causal) visible = visible && cp <= (e < 2 ? qpos0 : qpos1);
          if (!visible) s[j][e] = kNegInf;
        }
      }
    }

    // Softmax in registers; P = exp2(c * (s - max)), masked logits give 0.
    float sub0 = 0.f, sub1 = 0.f;
    if (!BOUNDED) {
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with nothing visible so far keeps P = exp2(-1e30 * c - 0) = 0
      const float mu0 = mn0 == kNegInf ? 0.f : mn0;
      const float mu1 = mn1 == kNegInf ? 0.f : mn1;
      const float al0 = exp2f((m0 - mu0) * c), al1 = exp2f((m1 - mu1) * c);
      m0 = mn0;
      m1 = mn1;
      sub0 = mu0 * c;
      sub1 = mu1 * c;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        o[j][0] *= al0;
        o[j][1] *= al0;
        o[j][2] *= al1;
        o[j][3] *= al1;
      }
    }
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      s[j][0] = exp2f(s[j][0] * c - sub0);
      s[j][1] = exp2f(s[j][1] * c - sub0);
      s[j][2] = exp2f(s[j][2] * c - sub1);
      s[j][3] = exp2f(s[j][3] * c - sub1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += P V: the S accumulators of two key n-tiles are one A fragment.
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const uint32_t a[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                             pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                             pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int jp = 0; jp < kOTiles / 2; ++jp) {
        // transposed matrices: (keys ks*16.., dims jp*16..), (keys +8, same
        // dims), (keys +0, dims +8), (keys +8, dims +8)
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, v_s + (ks * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kStride +
                    jp * 16 + 8 * (lane >> 4));
        mma16816(o[2 * jp], a, bv);
        mma16816(o[2 * jp + 1], a, bv + 2);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + row0 + g, r1 = r0 + 8;
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  __nv_bfloat16* ob = p.out + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < p.Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * p.os[2] + col) =
          __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < p.Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * p.os[2] + col) =
          __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
  }
  if (t == 0) {
    float* lb = p.lse + static_cast<long long>(blockIdx.x) * p.Lq;
    const float base0 = BOUNDED ? 0.f : m0 * p.scale;
    const float base1 = BOUNDED ? 0.f : m1 * p.scale;
    if (r0 < p.Lq) lb[r0] = l0 == 0.f ? kNegInf : base0 + logf(l0);
    if (r1 < p.Lq) lb[r1] = l1 == 0.f ? kNegInf : base1 + logf(l1);
  }
}

template <int D, bool BOUNDED>
cudaError_t launch(const PosParams& p, int B, cudaStream_t stream) {
  constexpr int kSmemBytes = (kBQ + 2 * kBK) * (D + 8) * 2;
  auto kernel = flash_fwd_pos_kernel<D, BOUNDED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * p.H, (p.Lq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v, out; the
// head-dim stride is 1. lse is (B, H, Lq) contiguous fp32. q_off and k_off
// are int32[2] in device memory. Head dims 64 and 128.
extern "C" int fdsd_flash_fwd_pos(const void* q, const void* k, const void* v,
                                  void* out, void* lse, const void* q_off,
                                  const void* k_off, int B, int H, int Lq,
                                  int Lk, int d, const long long* strides,
                                  float scale, int seg_q, int seg_k,
                                  int valid_len, int has_valid, int causal,
                                  int bounded, void* stream) {
  PosParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.q_off = static_cast<const int*>(q_off);
  p.k_off = static_cast<const int*>(k_off);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.scale = scale;
  p.seg_q = seg_q;
  p.seg_k = seg_k;
  p.valid_len = valid_len;
  p.has_valid = has_valid;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return static_cast<int>(bounded ? launch<64, true>(p, B, s)
                                    : launch<64, false>(p, B, s));
  if (d == 128)
    return static_cast<int>(bounded ? launch<128, true>(p, B, s)
                                    : launch<128, false>(p, B, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
