// Position-masked flash-attention backward dq (K6) for Hopper (sm_90a):
// bf16 in and out, fp32 softmax reconstruction and accumulators. This file
// holds K6 only; its partner K7 (dk, dv) is the position-mask form of the
// TMA / wgmma kernel in flash_attention_bwd_sm90.cu.
//
// Replaces the Pallas TPU kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel_pos
// (reached through flash_bwd_pos): dq of one LOCAL block of queries against
// one LOCAL block of keys under a softmax that is GLOBAL, taken over more
// keys than this block holds. The caller gives the global log-sum-exp and
// delta = rowsum(dO * out) of the merged output, so
//   P  = exp(scale * Q K^T - lse)  where the key is visible, else 0
//   dS = P * (dO V^T - delta),  dQ = scale * dS K
// and the contributions of several key blocks simply add up. dS is rounded
// to bf16 before the product that takes it. Visibility is the forward's
// (K5, flash_attention_sm90.cu): positions from two offset segments per
// side, read from int32[2] arrays in device memory; a key is masked when its
// index is >= Lk, its position is >= valid_len (if given), or its position is
// > the query's (if causal). Masked entries are SELECTED to 0, never
// multiplied by 0: a row that no key of any block sees carries lse = -1e30,
// where exp(s - lse) overflows, and a row that only another block's keys see
// is masked in every tile here. A (query tile, key tile) pair with nothing
// visible is skipped from the scalar position bounds of the two tiles, and a
// pair with nothing masked skips the per-logit mask.
// On the MMDiT training path (split-KV joint attention) it runs four times
// per block at B*H = 48, d = 64, (Lq, Lk) in {(154,154), (154,4096),
// (4096,154), (4096,4096)}, offsets 0, no causal, no valid_len.
//
// What bounds it on the H100: at 4096 x 4096 it does 3 products of
// 2*Lq*Lk*d flop on a few (L, d) tensors, about 3,000 flop per byte:
// operations, so the rate of tensor-core instructions and the exponentials;
// the 154-token calls are launch bound. The design: one block of 4 warps per
// (b*h, 64 queries), each warp 16 query rows, walking key tiles, mma.sync
// m16n8k16, tiles staged in shared memory as they lie and read with
// ldmatrix, so no transposed copies are kept. Q and dO fragments stay in
// registers; S and dP come from ldmatrix on the K and V tiles; the dS
// accumulators are, pair by pair, the A fragments of dS K, whose B operand
// is the same K tile read with ldmatrix.trans.
// The key tile walked is 64 wide at d = 64 and 32 at d = 128, which keeps the
// dQ accumulators (d/2 registers) and S / dP inside 255 registers. At d = 64
// the kernel is held to 168 registers (__launch_bounds__ with 3 blocks per
// SM), so that three blocks of 4 warps share an SM and hide the
// load-sync-compute walk. Head dims 64 and 128; others return
// cudaErrorInvalidValue.
// Not carried over from the TPU kernel: 1024-wide blocks, padded input
// copies, the power-of-two prescale of q.
// Later work: TMA + wgmma as K7 has, one fused kernel for dq, dk and dv, one
// launch for the four calls of the joint attention.

#include "mma.cuh"
#include "pos_tile.cuh"

namespace {

using fdsd::ldmatrix_x4;
using fdsd::ldmatrix_x4_trans;
using fdsd::load_tile;
using fdsd::mma16816;
using fdsd::pack_bf16;
using fdsd::pos_bounds;
using fdsd::pos_of;

constexpr float kPadLse = 1e30f;  // padded query rows: P = exp2(s - 1e30) = 0
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kTile = 64;  // query rows per block

struct PosBwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;  // dO
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  const int* q_off;
  const int* k_off;
  int H, Lq, Lk;
  // (batch, head, seq) element strides of q, k, v, dO and dq
  long long qs[3], ks[3], vs[3], gs[3], o1[3];
  float scale;
  int seg_q, seg_k, valid_len, has_valid, causal;
};

// A fragment (rows r0..r0+15, k kk..kk+15) of a row-major shared tile:
// matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15) are a0..a3.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* s,
                                       int stride, int r0, int kk, int lane) {
  ldmatrix_x4(a, s + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride + kk +
                     8 * (lane >> 4));
}

// B fragments of two neighbouring n-tiles (n n0..n0+15, k kk..kk+15) from a
// tile stored with one row per n: b[0..1] for n0..n0+7, b[2..3] for +8.
__device__ __forceinline__ void load_b(uint32_t* b, const __nv_bfloat16* s,
                                       int stride, int n0, int kk, int lane) {
  ldmatrix_x4(b, s + (n0 + (lane & 7) + 8 * (lane >> 4)) * stride + kk +
                     8 * ((lane >> 3) & 1));
}

// The same from a tile stored with one row per k (read transposed): k
// k0..k0+15, n n0..n0+15.
__device__ __forceinline__ void load_b_trans(uint32_t* b,
                                             const __nv_bfloat16* s,
                                             int stride, int k0, int n0,
                                             int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride +
                           n0 + 8 * (lane >> 4));
}

// Two neighbouring accumulator n-tiles as the A fragment of the next product.
__device__ __forceinline__ void acc_to_a(uint32_t* a, float (*c)[4],
                                         int ks) {
  a[0] = pack_bf16(c[2 * ks][0], c[2 * ks][1]);
  a[1] = pack_bf16(c[2 * ks][2], c[2 * ks][3]);
  a[2] = pack_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1]);
  a[3] = pack_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3]);
}

// Rows r0 and r0 + 8 of a warp's 16 x D accumulator, times mult, to a
// strided bf16 matrix of len rows.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           long long row_stride,
                                           float (*acc)[4], float mult,
                                           int r0, int len, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < len)
      *reinterpret_cast<__nv_bfloat162*>(dst + r0 * row_stride + col) =
          __floats2bfloat162_rn(acc[j][0] * mult, acc[j][1] * mult);
    if (r0 + 8 < len)
      *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + 8) * row_stride + col) =
          __floats2bfloat162_rn(acc[j][2] * mult, acc[j][3] * mult);
  }
}

// ---------------------------------------------------------------- K6: dq
// MINB: the blocks per SM that the register allocation is held to.
template <int D, int BK, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
flash_bwd_pos_dq_kernel(const PosBwdParams p) {
  constexpr int kStride = D + 8;    // bf16 per shared row
  constexpr int kSTiles = BK / 8;   // key n-tiles of S and dP per warp
  constexpr int kDTiles = D / 8;    // head-dim n-tiles of dQ per warp
  constexpr int kDSteps = D / 16;   // k-steps of Q K^T and dO V^T
  constexpr int kKSteps = BK / 16;  // k-steps of dS K

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* g_s = q_s + kTile * kStride;
  __nv_bfloat16* k_s = g_s + kTile * kStride;
  __nv_bfloat16* v_s = k_s + BK * kStride;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int q_off0 = p.q_off[0], q_off1 = p.q_off[1];
  const int k_off0 = p.k_off[0], k_off1 = p.k_off[1];

  load_tile<D, kTile>(q_s, p.q + b * p.qs[0] + h * p.qs[1], p.qs[2], q0, p.Lq,
                      tid);
  load_tile<D, kTile>(g_s, p.g + b * p.gs[0] + h * p.gs[1], p.gs[2], q0, p.Lq,
                      tid);
  __syncthreads();
  uint32_t qf[kDSteps][4], gf[kDSteps][4];
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    load_a(qf[kk], q_s, kStride, row0, kk * 16, lane);
    load_a(gf[kk], g_s, kStride, row0, kk * 16, lane);
  }

  // This thread's two query rows: statistics (lse in units of log 2) and
  // positions; the position bounds of the q tile.
  const int r0 = q0 + row0 + g, r1 = r0 + 8;
  const float* lse_b = p.lse + static_cast<long long>(blockIdx.x) * p.Lq;
  const float* dl_b = p.delta + static_cast<long long>(blockIdx.x) * p.Lq;
  const float lse0 = r0 < p.Lq ? lse_b[r0] * kLog2e : kPadLse;
  const float lse1 = r1 < p.Lq ? lse_b[r1] * kLog2e : kPadLse;
  const float dl0 = r0 < p.Lq ? dl_b[r0] : 0.f;
  const float dl1 = r1 < p.Lq ? dl_b[r1] : 0.f;
  const int qpos0 = pos_of(r0, q_off0, q_off1, p.seg_q);
  const int qpos1 = pos_of(r1, q_off0, q_off1, p.seg_q);
  int min_rp = 0, max_rp = 0;
  if (p.causal)
    pos_bounds(q0, kTile, q_off0, q_off1, p.seg_q, p.Lq, min_rp, max_rp);

  const float c = p.scale * kLog2e;  // exp(scale * s - lse) = exp2(c*s - lse')
  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const __nv_bfloat16* kb = p.k + b * p.ks[0] + h * p.ks[1];
  const __nv_bfloat16* vb = p.v + b * p.vs[0] + h * p.vs[1];
  const int n_kt = (p.Lk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    // Whole-tile decisions, the same for every thread of the block.
    int min_cp, max_cp;
    pos_bounds(k0, BK, k_off0, k_off1, p.seg_k, p.Lk, min_cp, max_cp);
    if ((p.has_valid && min_cp >= p.valid_len) ||
        (p.causal && min_cp > max_rp))
      continue;
    const bool need_mask = k0 + BK > p.Lk ||
                           (p.has_valid && max_cp >= p.valid_len) ||
                           (p.causal && max_cp > min_rp);

    __syncthreads();  // the previous tile's readers of k_s and v_s are done
    load_tile<D, BK>(k_s, kb, p.ks[2], k0, p.Lk, tid);
    load_tile<D, BK>(v_s, vb, p.vs[2], k0, p.Lk, tid);
    __syncthreads();

    // S = Q K^T (raw logits) and dP = dO V^T: 16 rows x BK keys per warp.
    float s[kSTiles][4], dp[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kSTiles / 2; ++jp) {
        uint32_t bk[4], bv[4];
        load_b(bk, k_s, kStride, jp * 16, kk * 16, lane);
        load_b(bv, v_s, kStride, jp * 16, kk * 16, lane);
        mma16816(s[2 * jp], qf[kk], bk);
        mma16816(s[2 * jp + 1], qf[kk], bk + 2);
        mma16816(dp[2 * jp], gf[kk], bv);
        mma16816(dp[2 * jp + 1], gf[kk], bv + 2);
      }
    }

    // dS = P * (dP - delta), P = exp2(c * S - lse) where visible, else 0.
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool visible = true;
        if (need_mask) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int cp = pos_of(col, k_off0, k_off1, p.seg_k);
          visible = col < p.Lk;
          if (p.has_valid) visible = visible && cp < p.valid_len;
          if (p.causal) visible = visible && cp <= (e < 2 ? qpos0 : qpos1);
        }
        const float pr = exp2f(s[j][e] * c - (e < 2 ? lse0 : lse1));
        s[j][e] = visible ? pr * (dp[j][e] - (e < 2 ? dl0 : dl1)) : 0.f;
      }
    }

    // dQ += dS K: the dS accumulators of two key n-tiles are one A fragment.
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t a[4];
      acc_to_a(a, s, ks);
#pragma unroll
      for (int jp = 0; jp < kDTiles / 2; ++jp) {
        uint32_t bk[4];
        load_b_trans(bk, k_s, kStride, ks * 16, jp * 16, lane);
        mma16816(acc[2 * jp], a, bk);
        mma16816(acc[2 * jp + 1], a, bk + 2);
      }
    }
  }

  store_rows<D>(p.dq + b * p.o1[0] + h * p.o1[1], p.o1[2], acc, p.scale, r0,
                p.Lq, t);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem_bytes, const PosBwdParams& p, int B,
                   int rows, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * p.H, (rows + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

// The params of a launch; dq's strides follow q, k, v, dO in the stride
// array.
PosBwdParams make_params(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         const void* q_off, const void* k_off, int H, int Lq,
                         int Lk, const long long* st, float scale, int seg_q,
                         int seg_k, int valid_len, int has_valid,
                         int causal) {
  PosBwdParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.q_off = static_cast<const int*>(q_off);
  p.k_off = static_cast<const int*>(k_off);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = st[i];
    p.ks[i] = st[3 + i];
    p.vs[i] = st[6 + i];
    p.gs[i] = st[9 + i];
    p.o1[i] = st[12 + i];
  }
  p.scale = scale;
  p.seg_q = seg_q;
  p.seg_k = seg_k;
  p.valid_len = valid_len;
  p.has_valid = has_valid;
  p.causal = causal;
  return p;
}

constexpr int smem_dq(int D, int BK) {
  return (2 * kTile + 2 * BK) * (D + 8) * 2;
}

}  // namespace

// strides: (batch, head, seq) element strides of q, k, v, dO, dq (15
// values); the head-dim stride is 1. lse and delta are (B, H, Lq) contiguous
// fp32; q_off and k_off are int32[2] in device memory. Head dims 64 and 128.
extern "C" int fdsd_flash_bwd_pos_dq(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, const void* q_off,
    const void* k_off, int B, int H, int Lq, int Lk, int d,
    const long long* strides, float scale, int seg_q, int seg_k, int valid_len,
    int has_valid, int causal, void* stream) {
  PosBwdParams p = make_params(q, k, v, g, lse, delta, q_off, k_off, H, Lq, Lk,
                               strides, scale, seg_q, seg_k, valid_len,
                               has_valid, causal);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return static_cast<int>(launch(
        flash_bwd_pos_dq_kernel<64, 64, 3>, smem_dq(64, 64), p, B, Lq, s));
  if (d == 128)
    return static_cast<int>(launch(flash_bwd_pos_dq_kernel<128, 32, 1>,
                                   smem_dq(128, 32), p, B, Lq, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
