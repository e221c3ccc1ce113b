// The pre-pass of the three-term TF32 split, shared by the fp32 flash
// forward (flash_f32_fwd.cu) and backward (flash_f32_bwd.cu): every fp32
// operand x goes into a workspace the caller allocates as two terms,
// x_hi = tf32(x) (rounded to nearest, cvt.rna) and x_lo = tf32(x - x_hi),
// hi at the term's start and lo one term further on.
//  - split_f32_rows_kernel: up to four (B, H, L, d) tensors, read through
//    their strides, into contiguous (2, B, H, L, d) terms, one float4 a
//    thread (every stride a multiple of 4 elements).
//  - split_f32_vt_kernel: one (B, H, L, d) tensor TRANSPOSED into
//    (2, B, H, d, L8) terms, L8 = L rounded up to kKeyGroup, zeros past L.
//    TF32 wgmma takes both operands K-major (PTX allows the transpose flags
//    for 16-bit types only), so every product whose reduction runs over the
//    sequence (P V in the forward; dS K, P^T dO and dS^T Q in the backward)
//    needs the sequence axis of its B operand contiguous: v^T, k^T, dO^T,
//    q^T. Within each group of 8 positions the pass stores position 2t at
//    t and 2t + 1 at t + 4: the A fragment of a TF32 wgmma holds columns
//    (t, t + 4) of a k-step where the accumulator of the product before it
//    (S, or S^T with the keys as M) holds columns (2t, 2t + 1), so P and dS
//    go from the accumulators into the A operand in registers.

#pragma once

#include "../sm90.cuh"

namespace {

constexpr int kKeyGroup = 8;  // transposed terms: padded to, permuted within

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float(fdsd::sm90::to_tf32(x));
  lo = __uint_as_float(fdsd::sm90::to_tf32(x - hi));
}

// The position at slot p of its group of 8 in a transposed term: 2p for
// p < 4, else 2(p - 4) + 1.
__device__ __forceinline__ int key_at(int p) {
  return p < 4 ? 2 * p : 2 * (p - 4) + 1;
}

constexpr int kMaxRows = 4;

struct RowsArgs {
  const float* x[kMaxRows];
  long long st[kMaxRows][3];  // (batch, head, seq) element strides
  float* out[kMaxRows];       // hi at out, lo at out + n
  long long n[kMaxRows];      // floats of one term
  int L[kMaxRows];
  int H, d;
};

// Tensor blockIdx.y of `a` into contiguous hi / lo terms.
__global__ void __launch_bounds__(256) split_f32_rows_kernel(const RowsArgs a) {
  const int y = blockIdx.y;
  const long long n4 = a.n[y] / 4;
  const int dv = a.d / 4;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4;
       i += 256LL * gridDim.x) {
    const int c = static_cast<int>(i % dv) * 4;
    const long long rest = i / dv;
    const int l = static_cast<int>(rest % a.L[y]);
    const int bh = static_cast<int>(rest / a.L[y]);
    const int b = bh / a.H, h = bh % a.H;
    const float4 x = *reinterpret_cast<const float4*>(
        a.x[y] + b * a.st[y][0] + h * a.st[y][1] + l * a.st[y][2] + c);
    float4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    reinterpret_cast<float4*>(a.out[y])[i] = hi;
    reinterpret_cast<float4*>(a.out[y] + a.n[y])[i] = lo;
  }
}

// x (B, H, L, d) through its strides into x^T hi / lo terms (2, B, H, d,
// l8), positions permuted within groups of 8, zeros past L. One block of
// 32 x 8 threads per (32 positions, 32 columns, b*h), through a padded
// shared tile.
__global__ void __launch_bounds__(256)
split_f32_vt_kernel(const float* __restrict__ x, long long s0, long long s1,
                    long long s2, float* __restrict__ xt, long long n, int H,
                    int L, int l8, int d) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 8 * i, col = c0 + tx;
    tile[ty + 8 * i][tx] = key < L && col < d
                               ? x[b * s0 + h * s1 + key * s2 + col]
                               : 0.f;
  }
  __syncthreads();
  const int key = (tx & ~7) + key_at(tx & 7);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = c0 + ty + 8 * i;
    if (row < d && k0 + tx < l8) {
      float hi, lo;
      split(tile[key][ty + 8 * i], hi, lo);
      const long long at = (static_cast<long long>(bh) * d + row) * l8 + k0 + tx;
      xt[at] = hi;
      xt[n + at] = lo;
    }
  }
}

// ---------------------------------------------------------------- host side
inline int round_up8(int n) { return (n + kKeyGroup - 1) / kKeyGroup * kKeyGroup; }

// The first `count` tensors of `a` into their terms.
inline cudaError_t split_rows(const RowsArgs& a, int count, cudaStream_t s) {
  long long most = 0;
  for (int i = 0; i < count; ++i) most = a.n[i] > most ? a.n[i] : most;
  most /= 4;
  const int blocks =
      static_cast<int>(most / 256 + 1 < 4096 ? most / 256 + 1 : 4096);
  split_f32_rows_kernel<<<dim3(blocks, count), 256, 0, s>>>(a);
  return cudaGetLastError();
}

// One (B, H, L, d) tensor x (element strides st) into its transposed terms
// at xt, n floats a term.
inline cudaError_t split_transposed(const void* x, const long long* st,
                                    float* xt, long long n, int B, int H,
                                    int L, int d, cudaStream_t s) {
  const int l8 = round_up8(L);
  split_f32_vt_kernel<<<dim3((l8 + 31) / 32, (d + 31) / 32, B * H),
                        dim3(32, 8), 0, s>>>(static_cast<const float*>(x),
                                             st[0], st[1], st[2], xt, n, H, L,
                                             l8, d);
  return cudaGetLastError();
}

}  // namespace
