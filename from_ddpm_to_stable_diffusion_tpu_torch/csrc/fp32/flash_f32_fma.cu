// Flash attention forward on fp32 inputs in plain fp32 arithmetic on the
// CUDA cores: the fp32 form of K1, without a mask and causal, at the head
// dims the TF32 forward of flash_f32_fwd.cu does not take, 161 to 256. (K3
// and K4 in fp32 above 128 run on the tensor cores: flash_f32_bwd.cuh.)
//
// Replaces, for fp32 q, k, v at those head dims, the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_wide
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel
// (tiny-SD's UNet in fp32 at wide heads: 192 at `channel: 96`), which ask
// for Precision.HIGHEST on fp32 inputs. Same contract as the TF32 forward:
// out and lse fp32; a row that sees no key gives out = 0 and lse = -1e30;
// masked probabilities are selected to 0. Every product is an fp32 FMA, so
// nothing is rounded below fp32.
//
// Why not the TF32 forward: its split keeps the resident Q tile twice (hi
// and lo terms), and above d = 160 that tile no longer fits in shared memory
// beside the streamed ones. This file is the simple form; a TF32 design for
// the wide head dims (the column split of flash_f32_bwd.cuh) is later work.
//
// What bounds it on the H100: operations, at the 67 TFLOP/s of fp32 FMAs,
// and in practice the shared-memory reads that feed them (each FMA's operand
// pair is 1.5 loads); the exponentials are one per logit.
//
// Design. 256 threads a block as a 16 x 16 grid (tx = tid % 16, ty = tid /
// 16); every tile in shared memory with rows padded by one float, so that
// sixteen threads reading sixteen rows at one column hit sixteen banks. One
// block per (b*h, 64 queries): Q resident; K and V tiles of 64 keys loaded
// by all threads; each thread computes S for 4 rows x 4 keys (keys tx + 16
// j), the online softmax (row max over the 16 threads of a row by shuffles,
// exp2 of the logit times scale * log2 e), writes P to a shared tile, and
// accumulates O for its 4 rows x DP / 16 columns (columns tx + 16 j:
// consecutive threads, consecutive words). DP is the head dim rounded up to
// 32: 192, 224, 256 (columns past d are zeros in shared memory and never
// written); causal (key <= query, from index 0 on both sides) is a runtime
// flag: the key tiles past the diagonal are not visited, and the logits
// across it are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 256;
constexpr int kRows = 64;  // queries a block

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o0;       // out
  float* lse_out;  // (B, H, Lq)
  int H, Lq, Lk, d, causal;
  long long st[4][3];  // (batch, head, seq) strides: q, k, v, out
  float scale;
};

// rows [r0, r0 + n) of x (head dim d, row stride st[2]) into a shared tile
// of n rows x DP columns (row pitch DP + 1): zeros past d and past `rows`.
template <int DP>
__device__ __forceinline__ void load_tile(float* tile, const float* x,
                                          const long long* st, int b, int h,
                                          int r0, int n, int rows, int d) {
  const float* base = x + b * st[0] + h * st[1];
  for (int i = threadIdx.x; i < n * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    tile[r * (DP + 1) + c] = r0 + r < rows && c < d
                                 ? base[(r0 + r) * st[2] + c]
                                 : 0.f;
  }
}

// Sum over the 16 threads (tx) of one row.
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// ------------------------------------------------------------- forward
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_fma_kernel(const Args a) {
  constexpr int P = DP + 1, BK = 64, NC = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // 64 x P
  float* ks = qs + kRows * P;    // 64 x P
  float* vs = ks + BK * P;       // 64 x P
  float* ps = vs + BK * P;       // 64 x (BK + 1)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_qt = (a.Lq + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  int qt = blockIdx.x % n_qt;
  if (a.causal) qt = n_qt - 1 - qt;  // the longest rows start first
  const int b = bh / a.H, h = bh % a.H, q0 = qt * kRows;
  load_tile<DP>(qs, a.q, a.st[0], b, h, q0, kRows, a.Lq, a.d);

  const float c = a.scale * kLog2e;  // exp(x scale) = exp2(x c)
  float m[4], l[4], o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[i][j] = 0.f;
  }
  const int n_kt = (a.Lk + BK - 1) / BK;
  const int kt_end = a.causal ? min(n_kt, (q0 + kRows - 1) / BK + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's K, V and P are read
    load_tile<DP>(ks, a.k, a.st[1], b, h, k0, BK, a.Lk, a.d);
    load_tile<DP>(vs, a.v, a.st[2], b, h, k0, BK, a.Lk, a.d);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int kk = 0; kk < a.d; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * P + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * P + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool visible = key < a.Lk && (!a.causal || key <= row);
        s[i][j] = visible ? s[i][j] * c : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max16(mx));
      // a row with nothing visible yet subtracts 0: its P stays 0
      const float mu = mn <= kNegInf ? 0.f : mn;
      const float alpha = exp2f(m[i] - mu);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = s[i][j] <= kNegInf ? 0.f : exp2f(s[i][j] - mu);
        sum += pr;
        ps[(4 * ty + i) * (BK + 1) + tx + 16 * j] = pr;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NC; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    for (int key = 0; key < BK; ++key) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * (BK + 1) + key];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = vs[key * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
      }
    }
  }
  // Epilogue: O / l through out's strides; lse = (m + log2 l) ln 2.
  float* ob = a.o0 + b * a.st[3][0] + h * a.st[3][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const float lt = row_sum16(l[i]);
    if (row >= a.Lq) continue;
    const float inv = lt == 0.f ? 0.f : 1.f / lt;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      if (col < a.d) ob[row * a.st[3][2] + col] = o[i][j] * inv;
    }
    if (tx == 0)
      a.lse_out[static_cast<long long>(bh) * a.Lq + row] =
          lt == 0.f ? kNegInf : (m[i] + log2f(lt)) * kLn2;
  }
}

// ---------------------------------------------------------------- host side
template <int DP>
constexpr int fwd_smem() {
  return (3 * kRows * (DP + 1) + kRows * 65) * 4;
}
static_assert(fwd_smem<256>() <= 232448, "shared memory");

template <typename Kernel>
cudaError_t launch(Kernel kernel, int blocks, int smem, cudaStream_t s,
                   const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The forward at the width of head dim d: d rounded up to 32, above the
// TF32 forward's widest (160) and up to 256.
cudaError_t dispatch(int B, const Args& a, cudaStream_t s) {
  if (a.d <= 160 || a.d > 256) return cudaErrorInvalidValue;
  const int blocks = B * a.H * ((a.Lq + kRows - 1) / kRows);
  switch ((a.d + 31) / 32 * 32) {
    case 192:
      return launch(flash_fwd_f32_fma_kernel<192>, blocks, fwd_smem<192>(), s,
                    a);
    case 224:
      return launch(flash_fwd_f32_fma_kernel<224>, blocks, fwd_smem<224>(), s,
                    a);
    default:
      return launch(flash_fwd_f32_fma_kernel<256>, blocks, fwd_smem<256>(), s,
                    a);
  }
}

// `n` tensors' (batch, head, seq) element strides into a.st.
Args make_args(int H, int Lq, int Lk, int d, const long long* strides,
               int n, float scale, int causal) {
  Args a = {};
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.d = d;
  a.causal = causal != 0;
  for (int t = 0; t < n; ++t)
    for (int i = 0; i < 3; ++i) a.st[t][i] = strides[3 * t + i];
  a.scale = scale;
  return a;
}

}  // namespace

// K1 in fp32 on the CUDA cores. strides: (batch, head, seq) element strides
// of q, k, v, out (12 values); the head-dim stride is 1. lse is (B, H, Lq)
// contiguous fp32. Head dims 161 to 256, without a mask or causal.
extern "C" int fdsd_flash_fwd_f32_fma(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int H, int Lq, int Lk, int d,
                                      const long long* strides, float scale,
                                      int causal, void* stream) {
  Args a = make_args(H, Lq, Lk, d, strides, 4, scale, causal);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o0 = static_cast<float*>(out);
  a.lse_out = static_cast<float*>(lse);
  return static_cast<int>(
      dispatch(B, a, static_cast<cudaStream_t>(stream)));
}
