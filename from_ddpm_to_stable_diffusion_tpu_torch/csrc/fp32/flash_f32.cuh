// Shared by the fp32 forms of the flash backward kernels (dq, dk/dv): every
// product is fp32 fused multiply-adds on the CUDA cores with fp32
// accumulation, so nothing is rounded to bf16 or TF32 anywhere. This is the
// form the Pallas kernels take on fp32 inputs (Precision.HIGHEST on every dot:
// from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py, _dot_precision).
// The fp32 forward runs on the tensor cores instead (flash_f32_fwd.cu).
//
// One block has 256 threads laid out as 16 x 16: ty = tid / 16, tx = tid % 16
// (a warp holds two ty and all sixteen tx). Two register-tiled products carry
// every kernel:
//   dot_tiles   s[i][j] += X[ty + 16 i] . Y[tx + 16 j]      (Q K^T, dO V^T)
//   accum_tiles acc[i][c] += sum_k A[ty + 16 i][k] B[k][dim(c)]  (dS K,
//                                                        P^T dO, dS^T Q)
// Rows and columns are interleaved by 16 and shared rows are D + 4 floats
// long (an odd multiple of 4), so the 16-byte loads of a half warp fall into
// distinct banks; lanes that share a row read one address (a broadcast).
//
// Masks: none, or the position masks of pos_tile.cuh (two offset segments
// per side, valid_len, causal on positions, the ragged key tail). The causal
// form of the plain flash kernels (col <= row from index 0) is the position
// mask with offsets 0 and one span, so K3 / K4 causal and K6 / K7 share the
// masked instantiations. A masked probability is selected to 0; a row that
// sees no key (lse = -1e30) gets zero gradients.

#pragma once

#include <cuda_runtime.h>

#include "../pos_tile.cuh"

namespace fdsd32 {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* g;       // dO
  const float* lse_in;  // (B, H, Lq) fp32
  const float* delta;   // (B, H, Lq) fp32
  float* o0;            // dq, or dk
  float* o1;            // dv
  const int* q_off;     // int32[2] in device memory, or null: offsets 0
  const int* k_off;
  int H, Lq, Lk, d;
  // (batch, head, seq) element strides; the head-dim stride is 1
  long long qs[3], ks[3], vs[3], gs[3], o0s[3], o1s[3];
  float scale;
  int seg_q, seg_k, valid_len, has_valid, causal;
};

// Rows [r0, r0 + ROWS) of a strided (len x d) fp32 matrix into a row-major
// shared tile of row stride DP + 4; rows past len and dims past d as zeros.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int len, int d, int tid) {
  constexpr int kVecs = DP / 4, kStride = DP + 4;
  for (int i = tid; i < ROWS * kVecs; i += kThreads) {
    const int r = i / kVecs, c = i % kVecs;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < len && c * 4 < d)
      val = *reinterpret_cast<const float4*>(src + (r0 + r) * row_stride +
                                             c * 4);
    *reinterpret_cast<float4*>(dst + r * kStride + c * 4) = val;
  }
}

// s[i][j] += X[ty + 16 i] . Y[tx + 16 j] over DP dims; X, Y shared tiles of
// row stride DP + 4.
template <int RM, int RN, int DP>
__device__ __forceinline__ void dot_tiles(float (&s)[RM][RN], const float* x,
                                          const float* y, int ty, int tx) {
  constexpr int kStride = DP + 4;
#pragma unroll 4
  for (int dd = 0; dd < DP; dd += 4) {
    float4 a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(x + (ty + 16 * i) * kStride + dd);
#pragma unroll
    for (int j = 0; j < RN; ++j)
      b[j] = *reinterpret_cast<const float4*>(y + (tx + 16 * j) * kStride + dd);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// The head dim that accumulator c of thread tx holds: runs of four
// neighbouring dims where DP / 16 is a multiple of 4 (one 16-byte load),
// dims interleaved by 16 otherwise (d = 40 padded to 48, d = 80).
template <int DP>
__device__ __forceinline__ int dim_of(int c, int tx) {
  if constexpr (DP / 16 % 4 == 0) {
    return 4 * (tx + 16 * (c / 4)) + c % 4;
  } else {
    return tx + 16 * c;
  }
}

// acc[i][c] += sum_{k < KK} A[ty + 16 i][k] * B[k][dim_of(c)]; A a shared
// tile of row stride SA, B one of row stride DP + 4.
template <int RM, int DP, int KK, int SA>
__device__ __forceinline__ void accum_tiles(float (&acc)[RM][DP / 16],
                                            const float* a_s, const float* b_s,
                                            int ty, int tx) {
  constexpr int DPT = DP / 16, SB = DP + 4;
#pragma unroll 2
  for (int kk = 0; kk < KK; kk += 4) {
    float a[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 t =
          *reinterpret_cast<const float4*>(a_s + (ty + 16 * i) * SA + kk);
      a[i][0] = t.x;
      a[i][1] = t.y;
      a[i][2] = t.z;
      a[i][3] = t.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* brow = b_s + (kk + u) * SB;
      if constexpr (DPT % 4 == 0) {
#pragma unroll
        for (int c = 0; c < DPT / 4; ++c) {
          const float4 b =
              *reinterpret_cast<const float4*>(brow + 4 * (tx + 16 * c));
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc[i][4 * c + 0] = fmaf(a[i][u], b.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(a[i][u], b.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(a[i][u], b.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(a[i][u], b.w, acc[i][4 * c + 3]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const float b = brow[tx + 16 * c];
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(a[i][u], b, acc[i][c]);
        }
      }
    }
  }
}

// acc (rows ty + 16 i of the tile at r0, dims dim_of(c)) times `mul` into a
// strided (len x d) fp32 matrix.
template <int RM, int DP>
__device__ __forceinline__ void store_tiles(const float (&acc)[RM][DP / 16],
                                            float* dst, long long row_stride,
                                            int r0, int len, int d, float mul,
                                            int ty, int tx) {
  constexpr int DPT = DP / 16;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= len) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int dim = dim_of<DP>(c, tx);
      if (dim < d) dst[r * row_stride + dim] = acc[i][c] * mul;
    }
  }
}

// The position mask of one block: offsets read once, tile decisions and the
// per-pair test. With MASKED false only the ragged key tail is masked.
template <bool MASKED>
struct Mask {
  int q0_, q1_, k0_, k1_;
  __device__ __forceinline__ explicit Mask(const Params& p) {
    q0_ = q1_ = k0_ = k1_ = 0;
    if (MASKED && p.q_off != nullptr) {
      q0_ = p.q_off[0];
      q1_ = p.q_off[1];
    }
    if (MASKED && p.k_off != nullptr) {
      k0_ = p.k_off[0];
      k1_ = p.k_off[1];
    }
  }
  __device__ __forceinline__ int row_pos(const Params& p, int row) const {
    return fdsd::pos_of(row, q0_, q1_, p.seg_q);
  }
  __device__ __forceinline__ int col_pos(const Params& p, int col) const {
    return fdsd::pos_of(col, k0_, k1_, p.seg_k);
  }
  // Does the (query tile at q0, key tile at k0) pair hold no visible pair?
  __device__ __forceinline__ bool skip(const Params& p, int q0, int bq, int k0,
                                       int bk) const {
    if (!MASKED) return false;
    int min_cp, max_cp, min_rp, max_rp;
    fdsd::pos_bounds(k0, bk, k0_, k1_, p.seg_k, p.Lk, min_cp, max_cp);
    if (p.has_valid && min_cp >= p.valid_len) return true;
    if (!p.causal) return false;
    fdsd::pos_bounds(q0, bq, q0_, q1_, p.seg_q, p.Lq, min_rp, max_rp);
    return min_cp > max_rp;
  }
  // Does the query at position rp see the key at index col?
  __device__ __forceinline__ bool sees(const Params& p, int rp, int col) const {
    if (col >= p.Lk) return false;
    if (!MASKED) return true;
    const int cp = col_pos(p, col);
    if (p.has_valid && cp >= p.valid_len) return false;
    return !p.causal || cp <= rp;
  }
};

// Params of a C entry; strides holds n_tensors triples in the order q, k, v,
// [dO,] outputs.
inline Params make_params(const void* q, const void* k, const void* v, int H,
                          int Lq, int Lk, int d, float scale) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.d = d;
  p.scale = scale;
  p.seg_q = Lq;
  p.seg_k = Lk;
  return p;
}

inline void set_pos(Params& p, const void* q_off, const void* k_off, int seg_q,
                    int seg_k, int valid_len, int has_valid, int causal) {
  p.q_off = static_cast<const int*>(q_off);
  p.k_off = static_cast<const int*>(k_off);
  p.seg_q = seg_q;
  p.seg_k = seg_k;
  p.valid_len = valid_len;
  p.has_valid = has_valid;
  p.causal = causal;
}

inline void set_strides(long long (&dst)[3], const long long* src) {
  for (int i = 0; i < 3; ++i) dst[i] = src[i];
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem_bytes, const Params& p, int B,
                   int rows, int tile, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * p.H, (rows + tile - 1) / tile);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fdsd32
