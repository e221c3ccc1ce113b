// Fused GroupNorm (+ optional SiLU) over channels-last (B, HW, C) activations,
// one launch per call.
//
// Replaces the Pallas TPU kernel
//   from_ddpm_to_stable_diffusion_tpu/ops/groupnorm_pallas.py:_gn_kernel
// (fp32 statistics per (batch, group) over HW x C/G, then normalize,
// per-channel affine and optional SiLU, written in the input dtype).
//
// What bounds it on the H100: bytes. GroupNorm does a handful of flops per
// element, so its floor is reading x once and writing y once: 3.1 us for the
// SD1 UNet's (2, 64*64, 320) bf16 slab. At those sizes (at most 15.7 MB at
// 512^2 with CFG batch 2) a chain of kernels costs more in ramps, drains and
// launches than in bytes, and reading x a second time costs a third more.
//
// Design: one cooperative launch of a persistent grid, at most one block per
// SM, each block owning contiguous rows ("units": a chunk of the rows of one
// batch). Per block, in order:
//   1. One thread issues 1-D bulk copies (cp.async.bulk into mbarriers) of
//      the block's rows into shared memory in pieces of whole rows, and every
//      thread folds each piece as it lands into per-channel sums of d and
//      d^2, d = x - K about a shift K (the channel's value in the unit's
//      first row: no division per row): each thread owns a fixed 16-byte
//      vector of channels and a fixed residue of rows. At the end of a unit
//      the block sums its threads in order, derives each channel's (mean,
//      M2), merges the channels into groups (all of equal count) and writes
//      one (n, mean, M2) partial per (batch, group, chunk).
//   2. The grid meets at one grid-wide barrier (cooperative_groups).
//   3. Each block merges the chunk partials of each group of its batch in
//      one fixed order (a few lanes of a warp over the chunks, about the
//      first chunk's mean, then a butterfly of adds): every block derives
//      bitwise the same statistics, so rows of one group are never
//      normalised with two different means, and two runs give the same
//      bits. var = max(M2 / n, 0).
//   4. y = x * mul + add with mul = rstd * scale, add = bias - mean * mul,
//      then SiLU, from the rows still in shared memory, 16-byte stores.
// Where the block's rows do not fit its shared memory ("streaming": the VAE
// decoders' 256^2 and 512^2 levels, tiny-SD's batch 32, fp32 at the UNet's
// widest levels) the same kernel runs the pieces through a ring of slots and
// loads them again after the barrier, in reverse order: the last pieces are
// still in their slots, and the rows it read last are read again from L2
// first. The launch plan (ops/groupnorm.py: group_norm_plan) picks the
// block size, chunks, pieces and slots.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

namespace s9 = fdsd::sm90;

constexpr int kMaxThreads = 1024;
constexpr int kMergeLoads = 4;  // partials a lane loads at once
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

template <typename T>
struct VecIO;

template <>
struct VecIO<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct VecIO<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = x;
  }
};

// The launch plan, as ops/groupnorm.py's group_norm_plan writes it (int32).
struct Plan {
  int B, HW, C, G, is_bf16, threads, chunks, rpc, grid, rpp, stages,
      resident, smem;
};

struct Params {
  const void* x;
  const float* scale;
  const float* bias;
  void* y;
  float2* part;  // (B, G, chunks) partials (mean, M2)
  int HW, C, G;
  int chunks, rpc;  // chunks per batch, rows per chunk
  int units;        // B * chunks
  int rpp, ppu;     // rows per piece, pieces per unit
  int stages;       // shared-memory slots of one piece each
  int resident;     // every piece of the block has its own slot
  float eps;
  int silu;
};

__host__ __device__ constexpr int up16(int bytes) { return (bytes + 15) & ~15; }

// Shared memory: the slots' mbarriers, the group statistics (mean, rstd),
// the affine (scale, bias), the channels' shift then mean, and M2, the
// threads' sums (s1[V], s2[V]), then the slots.
struct Layout {
  int stats, affine, chan, red_s1, red_s2, slab;
  __host__ __device__ Layout(int stages, int G, int C, int threads,
                             int vec) {
    stats = up16(8 * stages);
    affine = stats + up16(8 * G);
    chan = affine + up16(8 * C);
    red_s1 = chan + up16(8 * C);
    red_s2 = red_s1 + up16(4 * threads * vec);
    slab = red_s2 + up16(4 * threads * vec);
  }
};

// Sum over the `width` lanes (a power of two, at most 32) of an aligned run
// of lanes; every lane of the run gets the same bits (a butterfly of
// commutative adds).
__device__ __forceinline__ float lanes_sum(float v, int width) {
  for (int off = width / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
gn_fused_kernel(const __grid_constant__ Params p) {
  constexpr int V = VecIO<T>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = blockDim.x, tid = threadIdx.x;
  const int vpr = p.C / V, rows_par = NT / vpr;
  const int cv = tid % vpr, rr = tid / vpr;
  const int cg = p.C / p.G;
  const int S = p.stages, slot_elems = p.rpp * p.C;
  const Layout lay(S, p.G, p.C, NT, V);
  const uint32_t bars = s9::smem_u32(smem);
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  float* scale = reinterpret_cast<float*>(smem + lay.affine);
  float* bias = scale + p.C;
  float* chan_mean = reinterpret_cast<float*>(smem + lay.chan);
  float* chan_m2 = chan_mean + p.C;
  float* red_s1 = reinterpret_cast<float*>(smem + lay.red_s1);
  float* red_s2 = reinterpret_cast<float*>(smem + lay.red_s2);
  T* slab = reinterpret_cast<T*>(smem + lay.slab);
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  // The group reductions: L lanes per group (a power of two, at most 32,
  // within one warp), (group, lane) = (tid / L, tid % L), groups in rounds
  // of gpr.
  int L = 1;
  while (2 * L <= 32 && 2 * L * p.G <= NT) L *= 2;
  const int gpr = NT / L, gl = tid / L, ll = tid % L;

  // The block's units u = blockIdx.x + i * gridDim.x, each p.ppu pieces of
  // p.rpp rows (a multiple of rows_par, so that a thread's rows of a piece
  // are piece_first + rr + m * rows_par). The statistics pass loads piece
  // li = i * ppu + j into slot li % S; the normalisation walks the pieces in
  // reverse: the last S are still in their slots, and each slot it frees is
  // loaded with the piece it reaches S steps later (streaming only).
  const int n_units = max(0, (p.units - static_cast<int>(blockIdx.x) +
                              static_cast<int>(gridDim.x) - 1) /
                                 static_cast<int>(gridDim.x));
  const int n1 = n_units * p.ppu;
  auto unit_of = [&](int i, int& b, int& first, int& rows) {
    const int u = blockIdx.x + i * gridDim.x;
    b = u / p.chunks;
    first = (u - b * p.chunks) * p.rpc;  // the unit's first row in batch b
    rows = min(p.rpc, p.HW - first);
  };
  auto issue = [&](int li, int slot) {  // thread 0: piece li into slot
    const int i = li / p.ppu, j = li - i * p.ppu;
    int b, first, rows;
    unit_of(i, b, first, rows);
    const int n = max(0, min(p.rpp, rows - j * p.rpp));
    const uint32_t bytes = n * p.C * sizeof(T);
    const uint32_t bar = bars + 8 * slot;
    s9::mbar_expect_tx(bar, bytes);  // an empty piece completes at once
    if (bytes > 0)
      s9::bulk_load(s9::smem_u32(slab + slot * slot_elems),
                    x + (static_cast<long long>(b) * p.HW + first +
                         j * p.rpp) * p.C,
                    bytes, bar);
  };
  // bit s: the parity of slot s's next completion (at most 32 slots)
  uint32_t parity = 0;
  auto wait = [&](int slot) {
    s9::mbar_wait(bars + 8 * slot, (parity >> slot) & 1u);
    parity ^= 1u << slot;
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) s9::mbar_init(bars + 8 * s, 1);
    s9::mbar_init_fence();
  }
  __syncthreads();
  if (tid < min(S, n1)) issue(tid, tid);  // the first pieces, in parallel
  for (int c = tid; c < p.C; c += NT) {  // read before the barrier
    scale[c] = p.scale[c];
    bias[c] = p.bias[c];
  }

  // ---------------------------------------------------- 1. statistics pass
  // Per channel, sums of d = x - K and d^2 about a shift K, the channel's
  // value in the unit's first row: no division per row, and the two-pass
  // precision where K lies within the data's spread.
  int slot = 0;
  for (int i = 0; i < n_units; ++i) {
    int b, first, rows;
    unit_of(i, b, first, rows);
    float k[V], s1[V], s2[V];
#pragma unroll
    for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
    for (int j = 0; j < p.ppu; ++j) {
      wait(slot);
      const T* src = slab + slot * slot_elems + cv * V;
      if (j == 0) {  // the unit's first row
        VecIO<T>::load(src, k);
        if (rr == 0)
#pragma unroll
          for (int e = 0; e < V; ++e) chan_mean[cv * V + e] = k[e];
      }
      const int n = min(p.rpp, rows - j * p.rpp);
      for (int r = rr; r < n; r += rows_par) {
        float v[V];
        VecIO<T>::load(src + r * p.C, v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = v[e] - k[e];
          s1[e] += d;
          s2[e] = fmaf(d, d, s2[e]);
        }
      }
      if (!p.resident) {  // the slot is read: load the next piece into it
        __syncthreads();
        const int li = i * p.ppu + j;
        if (tid == 0 && li + S < n1) issue(li + S, slot);
      }
      if (++slot == S) slot = 0;
    }
    // The unit's partials: each channel's sums over the row residues
    // (thread t's channel c is at red[t * V + c % V], the residue j's at
    // red[j * C + c]) added in order, the channel's (mean, M2) from them,
    // then each group's over its channels (all of `rows` rows): the mean of
    // the channels' means, M2 theirs plus rows * the spread of the means.
#pragma unroll
    for (int e = 0; e < V; ++e) {
      red_s1[tid * V + e] = s1[e];
      red_s2[tid * V + e] = s2[e];
    }
    __syncthreads();
    const float fr = static_cast<float>(rows), inv_rows = 1.f / fr;
    for (int c = tid; c < p.C; c += NT) {
      float a = 0.f, q = 0.f;
      for (int j = 0; j < rows_par; ++j) {
        a += red_s1[j * p.C + c];
        q += red_s2[j * p.C + c];
      }
      const float dm = a * inv_rows;
      chan_mean[c] += dm;
      chan_m2[c] = fmaf(-a, dm, q);
    }
    __syncthreads();
    for (int g0 = 0; g0 < p.G; g0 += gpr) {
      const int g = g0 + gl;
      const bool mine = gl < gpr && g < p.G;
      float sm = 0.f;
      if (mine)
        for (int c = g * cg + ll; c < (g + 1) * cg; c += L)
          sm += chan_mean[c];
      const float mg = lanes_sum(sm, L) / cg;
      float mm = 0.f;
      if (mine)
        for (int c = g * cg + ll; c < (g + 1) * cg; c += L) {
          const float d = chan_mean[c] - mg;
          mm += fmaf(fr * d, d, chan_m2[c]);
        }
      mm = lanes_sum(mm, L);
      if (mine && ll == 0)
        p.part[(static_cast<long long>(b) * p.G + g) * p.chunks +
               first / p.rpc] = make_float2(mg, mm);
    }
    __syncthreads();  // the sum and channel slots are free again
  }
  // ------------------------------------------------- 2. the grid's barrier
  cooperative_groups::this_grid().sync();

  // ------------------------------- 3. statistics, 4. normalise (+ SiLU)
  int cur_b = -1;
  float mul[V], add[V];
  auto normalise = [&](const T* src, T* out, int n) {  // n rows
#pragma unroll 2
    for (int r = rr; r < n; r += rows_par) {
      float v[V];
      VecIO<T>::load(src + r * p.C, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float o = fmaf(v[e], mul[e], add[e]);
        if (p.silu) o = __fdividef(o, 1.f + __expf(-o));
        v[e] = o;
      }
      VecIO<T>::store(out + static_cast<long long>(r) * p.C, v);
    }
  };
  slot = (n1 + S - 1) % S;
  int k_step = 0;  // pieces walked in this pass
  for (int i = n_units - 1; i >= 0; --i) {
    int b, first, rows;
    unit_of(i, b, first, rows);
    if (b != cur_b) {
      // Merge the chunk partials of each group of batch b in one pass
      // over them (from L2: other blocks wrote them), about a shift K, the
      // mean of chunk 0: the count (cg times the chunk's rows), the sum of
      // n (mean - K) and of M2 + n (mean - K)^2, then mean and M2 about it.
      __syncthreads();  // every thread has read the previous statistics
      for (int g0 = 0; g0 < p.G; g0 += gpr) {
        const int g = g0 + gl;
        const bool mine = gl < gpr && g < p.G;
        float sn = 0.f, sd = 0.f, sm = 0.f, kk = 0.f;
        const float2* pp =
            p.part + (static_cast<long long>(b) * p.G + g) * p.chunks;
        for (int j0 = 0; j0 < p.chunks; j0 += kMergeLoads * L) {
          float2 f[kMergeLoads];  // these loads in flight at once
#pragma unroll
          for (int q = 0; q < kMergeLoads; ++q) {
            const int j = j0 + q * L + ll;
            f[q] = mine && j < p.chunks ? __ldcg(pp + j)
                                        : make_float2(0.f, 0.f);
          }
          if (j0 == 0)  // the shift: lane 0's first, chunk 0's mean
            kk = __shfl_sync(0xffffffffu, f[0].x, (tid & 31) & ~(L - 1));
#pragma unroll
          for (int q = 0; q < kMergeLoads; ++q) {
            const int j = j0 + q * L + ll;
            const float n = mine && j < p.chunks
                                ? static_cast<float>(
                                      cg * min(p.rpc, p.HW - j * p.rpc))
                                : 0.f;
            const float d = f[q].x - kk;
            sn += n;
            sd = fmaf(n, d, sd);
            sm += fmaf(n * d, d, f[q].y);
          }
        }
        sn = lanes_sum(sn, L);
        sd = lanes_sum(sd, L);
        sm = lanes_sum(sm, L);
        if (mine && ll == 0) {
          const float dm = sd / sn;
          const float var = fmaxf(fmaf(-sd, dm, sm) / sn, 0.f);
          stats[2 * g] = kk + dm;
          stats[2 * g + 1] = rsqrtf(var + p.eps);
        }
      }
      __syncthreads();
      int g = cv * V / cg, g_end = (g + 1) * cg;  // the group of channel c
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = cv * V + e;
        if (c == g_end) {
          ++g;
          g_end += cg;
        }
        mul[e] = stats[2 * g + 1] * scale[c];
        add[e] = bias[c] - stats[2 * g] * mul[e];
      }
      cur_b = b;
    }
    T* dst = y + (static_cast<long long>(b) * p.HW + first) * p.C + cv * V;
    if (p.resident) {  // the unit's slots hold its rows back to back
      normalise(slab + i * p.ppu * slot_elems + cv * V, dst, rows);
      continue;
    }
    for (int j = p.ppu - 1; j >= 0; --j, ++k_step) {
      if (k_step >= S) wait(slot);
      normalise(slab + slot * slot_elems + cv * V,
                dst + static_cast<long long>(j) * p.rpp * p.C,
                min(p.rpp, rows - j * p.rpp));
      __syncthreads();
      const int li = i * p.ppu + j;  // this piece; the one S steps later
      if (tid == 0 && k_step + S < n1) issue(li - S, slot);
      if (--slot < 0) slot = S - 1;
    }
  }
}

// Lets the kernel take up to kMaxSmem bytes of dynamic shared memory, once.
template <typename T>
cudaError_t prepare() {
  static cudaError_t err = cudaFuncSetAttribute(
      gn_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  return err;
}

template <typename T>
cudaError_t launch(const Params& p, const Plan& plan, cudaStream_t stream) {
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.grid);
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gn_fused_kernel<T>, p);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? err : last;
}

}  // namespace

// x, y: (B, HW, C) contiguous and 16-byte aligned, bf16 (plan.is_bf16) or
// fp32; scale, bias: (C,) fp32; part: 2 * B * G * plan.chunks fp32 scratch;
// plan: the 13 int32 of ops/groupnorm.py's group_norm_plan: whole warps, a
// multiple of C / (16 / sizeof(x)) threads, pieces of a multiple of the
// threads' row residues, at most 32 slots, and smem as the kernel's Layout
// counts it. The launch is cooperative: a grid larger than
// the card holds at once is refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int fdsd_group_norm(const void* x, const void* scale,
                               const void* bias, void* y, void* part,
                               const void* plan, float eps, int silu,
                               void* stream) {
  const Plan& pl = *static_cast<const Plan*>(plan);
  const int vec = pl.is_bf16 ? 8 : 4;
  if (pl.smem != Layout(pl.stages, pl.G, pl.C, pl.threads, vec).slab +
                     pl.stages * pl.rpp * pl.C * (pl.is_bf16 ? 2 : 4) ||
      pl.threads % 32 != 0 || pl.threads % (pl.C / vec) != 0 ||
      pl.rpp % (pl.threads / (pl.C / vec)) != 0 || pl.stages > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.part = static_cast<float2*>(part);
  p.HW = pl.HW;
  p.C = pl.C;
  p.G = pl.G;
  p.chunks = pl.chunks;
  p.rpc = pl.rpc;
  p.units = pl.B * pl.chunks;
  p.rpp = pl.rpp;
  p.ppu = (pl.rpc + pl.rpp - 1) / pl.rpp;
  p.stages = pl.stages;
  p.resident = pl.resident;
  p.eps = eps;
  p.silu = silu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(pl.is_bf16 ? launch<__nv_bfloat16>(p, pl, s)
                                     : launch<float>(p, pl, s));
}

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory that
// one SM holds at once (the cooperative launch's limit), or minus the CUDA
// error.
extern "C" int fdsd_group_norm_blocks_per_sm(int is_bf16, int threads,
                                             int smem) {
  int n = 0;
  cudaError_t err = is_bf16 ? prepare<__nv_bfloat16>() : prepare<float>();
  if (err == cudaSuccess)
    err = is_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &n, gn_fused_kernel<__nv_bfloat16>, threads, smem)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &n, gn_fused_kernel<float>, threads, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
