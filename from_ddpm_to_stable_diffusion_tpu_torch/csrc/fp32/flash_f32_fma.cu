// Flash attention on fp32 inputs in plain fp32 arithmetic on the CUDA cores:
// the fp32 forms of K1 (forward), K3 (dq) and K4 (dk, dv), without a mask
// and causal, at the head dims the TF32 kernels of flash_f32_fwd.cu and
// flash_f32_bwd.cu do not take: 161 to 256 in the forward, 129 to 256 in the
// backward.
//
// Replaces, for fp32 q, k, v at those head dims, the Pallas TPU kernels
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel_wide
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_fwd_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dq_kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/flash_attention.py:_bwd_dkv_kernel
// (tiny-SD's UNet in fp32 at wide heads: 192 at `channel: 96`, 160 in the
// backward at `channel: 320`), which ask for
// Precision.HIGHEST on fp32 inputs. Same contract as the TF32 kernels: out,
// lse and the gradients fp32; a row that sees no key gives out = 0 and
// lse = -1e30; masked probabilities are selected to 0. Every product is an
// fp32 FMA, so nothing is rounded below fp32.
//
// Why not the TF32 kernels: their split keeps each resident operand twice
// (hi and lo terms), and above d = 128 (backward: Q and dO, or K and V, of a
// 64-row tile, 1 KB a column) or 160 (forward) those tiles no longer fit in
// shared memory beside the streamed ones. This file is the simple form; a
// TF32 design for the wide head dims (operands streamed in column chunks) is
// later work.
//
// What bounds it on the H100: operations, at the 67 TFLOP/s of fp32 FMAs,
// and in practice the shared-memory reads that feed them (each FMA's operand
// pair is 1.5 loads); the exponentials are one per logit.
//
// Design. 256 threads a block as a 16 x 16 grid (tx = tid % 16, ty = tid /
// 16); every tile in shared memory with rows padded by one float, so that
// sixteen threads reading sixteen rows at one column hit sixteen banks.
//  - forward (one block per (b*h, 64 queries)): Q resident; K and V tiles of
//    64 keys loaded by all threads; each thread computes S for 4 rows x 4
//    keys (keys tx + 16 j), the online softmax (row max over the 16 threads
//    of a row by shuffles, exp2 of the logit times scale * log2 e), writes P
//    to a shared tile, and accumulates O for its 4 rows x DP / 16 columns
//    (columns tx + 16 j: consecutive threads, consecutive words).
//  - dq (one block per (b*h, 64 queries)): Q and dO resident, K and V tiles
//    of 32 keys; S and dP for 4 rows x 2 keys a thread, P = exp(s scale -
//    lse) selected to 0 where masked, dS = P (dP - delta) into a shared
//    tile, dQ += dS K for 4 rows x DP / 16 columns.
//  - dk / dv (one block per (b*h, 64 keys)): K and V resident, Q and dO
//    tiles of 32 queries with their lse and delta; S^T and dP^T for 4 keys x
//    2 queries a thread, P^T and dS^T into shared tiles, dV += P^T dO and
//    dK += dS^T Q for 4 keys x DP / 16 columns.
// DP is the head dim rounded up to 32: 192, 224, 256 in the forward, 160 -
// 256 in the backward (columns past d are zeros in shared memory and never
// written); causal (key <= query, from index 0 on both
// sides) is a runtime flag: the key (query) tiles past the diagonal are not
// visited, and the logits across it are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 256;
constexpr int kRows = 64;  // queries (forward, dq) or keys (dk / dv) a block

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* g;      // dO (backward)
  const float* lse;    // (B, H, Lq): written by the forward, read after
  const float* delta;  // (B, H, Lq), backward
  float* o0;           // out, dq or dk
  float* o1;           // dv
  float* lse_out;      // the forward's lse
  int H, Lq, Lk, d, causal;
  long long st[6][3];  // (batch, head, seq) strides: q, k, v, dO / out, ...
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

// ------------------------------------------------------------------ dq
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_fma_kernel(const Args a) {
  constexpr int P = DP + 1, BK = 32, NC = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // 64 x P
  float* gs = qs + kRows * P;    // 64 x P
  float* ks = gs + kRows * P;    // 32 x P
  float* vs = ks + BK * P;       // 32 x P
  float* ds = vs + BK * P;       // 64 x (BK + 1)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_qt = (a.Lq + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  int qt = blockIdx.x % n_qt;
  if (a.causal) qt = n_qt - 1 - qt;
  const int b = bh / a.H, h = bh % a.H, q0 = qt * kRows;
  load_tile<DP>(qs, a.q, a.st[0], b, h, q0, kRows, a.Lq, a.d);
  load_tile<DP>(gs, a.g, a.st[3], b, h, q0, kRows, a.Lq, a.d);

  const float c = a.scale * kLog2e;
  float lse[4], dl[4], dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const long long at = static_cast<long long>(bh) * a.Lq + row;
    lse[i] = row < a.Lq ? a.lse[at] * kLog2e : 0.f;
    dl[i] = row < a.Lq ? a.delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) dq[i][j] = 0.f;
  }
  const int n_kt = (a.Lk + BK - 1) / BK;
  const int kt_end = a.causal ? min(n_kt, (q0 + kRows - 1) / BK + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<DP>(ks, a.k, a.st[1], b, h, k0, BK, a.Lk, a.d);
    load_tile<DP>(vs, a.v, a.st[2], b, h, k0, BK, a.Lk, a.d);
    __syncthreads();
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int kk = 0; kk < a.d; ++kk) {
      float qv[4], gv[4], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(4 * ty + i) * P + kk];
        gv[i] = gs[(4 * ty + i) * P + kk];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = ks[(tx + 16 * j) * P + kk];
        vv[j] = vs[(tx + 16 * j) * P + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
    // P = exp(s scale - lse), selected to 0 where the key is hidden or
    // past Lk and on rows past Lq; dS = P (dP - delta).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool visible =
            row < a.Lq && key < a.Lk && (!a.causal || key <= row);
        const float pr = visible ? exp2f(fmaf(s[i][j], c, -lse[i])) : 0.f;
        ds[(4 * ty + i) * (BK + 1) + tx + 16 * j] = pr * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    for (int key = 0; key < BK; ++key) {
      float dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = ds[(4 * ty + i) * (BK + 1) + key];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float kv = ks[key * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(dv[i], kv, dq[i][j]);
      }
    }
  }
  float* ob = a.o0 + b * a.st[4][0] + h * a.st[4][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      if (col < a.d) ob[row * a.st[4][2] + col] = dq[i][j] * a.scale;
    }
  }
}

// -------------------------------------------------------------- dk / dv
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_fma_kernel(const Args a) {
  constexpr int P = DP + 1, BQ = 32, NC = DP / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // 64 x P
  float* vs = ks + kRows * P;    // 64 x P
  float* qs = vs + kRows * P;    // 32 x P
  float* gs = qs + BQ * P;       // 32 x P
  float* pt = gs + BQ * P;       // P^T: 64 x (BQ + 1)
  float* dst = pt + kRows * (BQ + 1);  // dS^T: 64 x (BQ + 1)
  float* stat = dst + kRows * (BQ + 1);  // lse * log2 e, delta: 2 x BQ
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_kt = (a.Lk + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_kt;
  const int b = bh / a.H, h = bh % a.H, k0 = (blockIdx.x % n_kt) * kRows;
  load_tile<DP>(ks, a.k, a.st[1], b, h, k0, kRows, a.Lk, a.d);
  load_tile<DP>(vs, a.v, a.st[2], b, h, k0, kRows, a.Lk, a.d);

  const float c = a.scale * kLog2e;
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int n_qt = (a.Lq + BQ - 1) / BQ;
  const int qt_begin = a.causal ? k0 / BQ : 0;
  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<DP>(qs, a.q, a.st[0], b, h, q0, BQ, a.Lq, a.d);
    load_tile<DP>(gs, a.g, a.st[3], b, h, q0, BQ, a.Lq, a.d);
    if (threadIdx.x < BQ) {
      const int q = q0 + threadIdx.x;
      const long long at = static_cast<long long>(bh) * a.Lq + q;
      stat[threadIdx.x] = q < a.Lq ? a.lse[at] * kLog2e : 0.f;
      stat[BQ + threadIdx.x] = q < a.Lq ? a.delta[at] : 0.f;
    }
    __syncthreads();
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int kk = 0; kk < a.d; ++kk) {
      float kv[4], vv[4], qv[2], gv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(4 * ty + i) * P + kk];
        vv[i] = vs[(4 * ty + i) * P + kk];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        qv[j] = qs[(tx + 16 * j) * P + kk];
        gv[j] = gs[(tx + 16 * j) * P + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }
    // P^T = exp(s scale - lse) selected to 0 where the key is hidden from
    // the query, past Lk, or the query past Lq; dS^T = P^T (dP^T - delta).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = tx + 16 * j, q = q0 + qc;
        const bool visible =
            q < a.Lq && key < a.Lk && (!a.causal || key <= q);
        const float pr =
            visible ? exp2f(fmaf(s[i][j], c, -stat[qc])) : 0.f;
        pt[(4 * ty + i) * (BQ + 1) + qc] = pr;
        dst[(4 * ty + i) * (BQ + 1) + qc] = pr * (dp[i][j] - stat[BQ + qc]);
      }
    }
    __syncthreads();
    for (int qc = 0; qc < BQ; ++qc) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt[(4 * ty + i) * (BQ + 1) + qc];
        sv[i] = dst[(4 * ty + i) * (BQ + 1) + qc];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float gq = gs[qc * P + tx + 16 * j];
        const float qq = qs[qc * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pv[i], gq, dv[i][j]);
          dk[i][j] = fmaf(sv[i], qq, dk[i][j]);
        }
      }
    }
  }
  float* kb = a.o0 + b * a.st[4][0] + h * a.st[4][1];
  float* vb = a.o1 + b * a.st[5][0] + h * a.st[5][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= a.Lk) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      if (col < a.d) {
        kb[key * a.st[4][2] + col] = dk[i][j] * a.scale;
        vb[key * a.st[5][2] + col] = dv[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------- host side
template <int DP>
constexpr int fwd_smem() {
  return (3 * kRows * (DP + 1) + kRows * 65) * 4;
}
template <int DP>
constexpr int dq_smem() {
  return (2 * kRows * (DP + 1) + 2 * 32 * (DP + 1) + kRows * 33) * 4;
}
template <int DP>
constexpr int dkv_smem() {
  return (2 * kRows * (DP + 1) + 2 * 32 * (DP + 1) + 2 * kRows * 33 + 64) *
         4;
}
static_assert(fwd_smem<256>() <= 232448 && dq_smem<256>() <= 232448 &&
                  dkv_smem<256>() <= 232448,
              "shared memory");

template <typename Kernel>
cudaError_t launch(Kernel kernel, int blocks, int smem, cudaStream_t s,
                   const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// kind 0: forward (DP > 160), 1: dq, 2: dk / dv, at the width DP.
template <int DP>
cudaError_t run(int kind, int B, const Args& a, cudaStream_t s) {
  const int bh = B * a.H;
  if constexpr (DP > 160) {
    if (kind == 0)
      return launch(flash_fwd_f32_fma_kernel<DP>,
                    bh * ((a.Lq + kRows - 1) / kRows), fwd_smem<DP>(), s, a);
  }
  if (kind == 0) return cudaErrorInvalidValue;
  if (kind == 1)
    return launch(flash_bwd_dq_f32_fma_kernel<DP>,
                  bh * ((a.Lq + kRows - 1) / kRows), dq_smem<DP>(), s, a);
  return launch(flash_bwd_dkv_f32_fma_kernel<DP>,
                bh * ((a.Lk + kRows - 1) / kRows), dkv_smem<DP>(), s, a);
}

// The width of head dim d: d rounded up to 32, above the TF32 kernels'
// widest (160 forward, 128 backward) and up to 256.
cudaError_t dispatch(int kind, int B, const Args& a, cudaStream_t s) {
  if (a.d <= (kind == 0 ? 160 : 128) || a.d > 256)
    return cudaErrorInvalidValue;
  switch ((a.d + 31) / 32 * 32) {
    case 160:
      return run<160>(kind, B, a, s);
    case 192:
      return run<192>(kind, B, a, s);
    case 224:
      return run<224>(kind, B, a, s);
    default:
      return run<256>(kind, B, a, s);
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
      dispatch(0, B, a, static_cast<cudaStream_t>(stream)));
}

// K3 in fp32 on the CUDA cores. strides: q, k, v, dO, dq (15 values); lse
// and delta (B, H, Lq) contiguous fp32. Head dims 129 to 256, without a mask
// or causal.
extern "C" int fdsd_flash_bwd_dq_f32_fma(const void* q, const void* k,
                                         const void* v, const void* g,
                                         const void* lse, const void* delta,
                                         void* dq, int B, int H, int Lq,
                                         int Lk, int d,
                                         const long long* strides,
                                         float scale, int causal,
                                         void* stream) {
  Args a = make_args(H, Lq, Lk, d, strides, 5, scale, causal);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.g = static_cast<const float*>(g);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.o0 = static_cast<float*>(dq);
  return static_cast<int>(
      dispatch(1, B, a, static_cast<cudaStream_t>(stream)));
}

// K4 in fp32 on the CUDA cores. strides: q, k, v, dO, dk, dv (18 values).
// Head dims 129 to 256, without a mask or causal.
extern "C" int fdsd_flash_bwd_dkv_f32_fma(const void* q, const void* k,
                                          const void* v, const void* g,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int H,
                                          int Lq, int Lk, int d,
                                          const long long* strides,
                                          float scale, int causal,
                                          void* stream) {
  Args a = make_args(H, Lq, Lk, d, strides, 6, scale, causal);
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.g = static_cast<const float*>(g);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.o0 = static_cast<float*>(dk);
  a.o1 = static_cast<float*>(dv);
  return static_cast<int>(
      dispatch(2, B, a, static_cast<cudaStream_t>(stream)));
}
