// Dense skip-LoRA sum and its adapter gradients for Hopper (sm_90a) over
// fp32 rows, on CUDA cores: the fp32-row routes of skip_lora_fwd.cu (K1)
// and skip_lora_bwd.cu (K2). Their bf16 rows, and K3's int8 rows, run on
// the tensor cores (skip_sum_tc.cuh); fp32 rows stay here because the
// tensor cores' fp32 input is TF32 (about three decimal digits), which
// would break the float32 cases' 1e-5 bar.
//
//   forward   out[m]  = sum_l (x[l,m] @ A[l]) @ B[l]
//   backward  gA[l]   = x[l]^T  @ (g @ B[l]^T)
//             gB[l]   = (x[l] @ A[l])^T @ g
//
// with fp32 accumulation, the adapters (fp32 or bf16) read as fp32, as the
// reference casts them to the rows' dtype
// (src/repro/kernels/skip_lora/kernel.py, _fwd_kernel, _bwd_kernel).
//
// What bounds them: bytes. The rank R is 4..64, so each element of x meets
// 2R multiply-adds: at the cached-step shape (L 24, M 1024, D 2048, R 8)
// reading fp32 x (201 MB) takes ~60 us at 3.35 TB/s and the 0.8 GFLOP of
// fp32 FMAs ~12 us at 67 TFLOP/s. The TPU kernels keep an fp32 output tile
// resident while a sequential grid axis walks the layers (forward) or the
// row tiles (backward). GPU blocks run in parallel, so each is split in
// passes that a block finishes on its own:
//
//   project  (block per 16..64-row tile x layer): P[l, m, :] = X(l, m, :) @ W[l]
//     through shared memory, 128 columns of D per step; x is read once.
//     Used for z = x A (forward and backward) and gz = g B^T (backward,
//     W read through strides as B transposed, X the same g for every layer).
//   expand   (block per 32-row x 128-column tile, 4 x 4 outputs a thread):
//     out = sum_(l,r) z[l,m,r] B[l,r,:], the (layer, rank) pairs taken in
//     order k = l * R + r.
//   outer    (block per layer x 128 columns x chunk of M): per-chunk
//     fp32 partials of gA and gB, one column of D per thread.
//   reduce   sums the chunks' partials in chunk order: no atomics, so the
//     gradients are the same bits on every run (K2's bf16 route uses it too).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "numerics.cuh"

namespace ssk {

using rtk::to_f;

constexpr int R_MAX = 64;
constexpr int P_KC = 128;         // columns of D per project step
constexpr int P_LD = P_KC + 4;    // row stride of the staged x tile (banks)
constexpr int P_THREADS = 256;    // 16 column slices x 16 row groups
constexpr int E_TM = 32;          // rows per expand block
constexpr int E_TD = 128;         // columns per expand block
constexpr int E_KK = 32;          // (layer, rank) pairs per expand step
constexpr int E_THREADS = 256;
constexpr int O_TD = 128;         // columns per outer block, one per thread

// fp32 rows: `at(l, m, d)`. `layer_stride` 0 gives every layer the same
// matrix (g in the backward).
struct DenseRows {
  const float* x;
  size_t layer_stride;
  int D;
  __device__ __forceinline__ float at(int l, int m, int d) const {
    return x[(size_t)l * layer_stride + (size_t)m * D + d];
  }
};

// Rows a project thread owns: all RP ranks of TRW rows, so each staged x
// value feeds RP multiply-adds and each W value TRW of them.
template <int RP> struct ProjectShape {
  static constexpr int TRW = RP <= 8 ? 4 : (RP == 16 ? 2 : 1);
  static constexpr int TM = 16 * TRW;                  // rows per block
  static constexpr int LPT = TM * P_KC / P_THREADS;    // x values a thread stages per step
};

// project: P[l, m, r] = sum_d X(l, m, d) * W[l*wl + d*wd + r*wr], stored in
// P (L, M, R). RP is R rounded up to a power of two >= 4.
// Each step stages a TM x P_KC tile of x and the matching P_KC x RP block
// of W in shared memory, with loops of compile-time trip count so a
// thread's loads issue together (8 at a time for x, which keeps the
// registers under the bound below); lane dq = lane % 16 of each half-warp
// takes the columns dq + 16 c, and the 16 column slices are summed by
// shuffles at the end.
// At least 3 blocks per SM (2 at rank > 16): without the bound the
// compiler keeps every staged load in flight in its own registers (200 at
// rank 8), one block fits per SM and the grid runs in three waves.
template <typename Rows, typename W, int RP>
__global__ void __launch_bounds__(P_THREADS, RP <= 16 ? 3 : 2)
project(Rows rows, const W* __restrict__ w, size_t wl, size_t wd, size_t wr,
        float* __restrict__ out, int M, int D, int R) {
  using S = ProjectShape<RP>;
  constexpr int TRW = S::TRW, TM = S::TM, LPT = S::LPT;
  __shared__ float xs[TM * P_LD];
  __shared__ __align__(16) float ws[P_KC * RP];
  const int l = blockIdx.y, m0 = blockIdx.x * TM, tid = threadIdx.x;
  const int lane = tid & 31, dq = lane & 15;
  const int row0 = ((tid >> 5) * 2 + (lane >> 4)) * TRW;   // first of this thread's rows
  const W* wl_ = w + (size_t)l * wl;
  const bool w_rows = wr == 1;   // W[l] stored (D, R) row-major (A) or transposed (B)
  float acc[TRW][RP];
#pragma unroll
  for (int i = 0; i < TRW; ++i)
#pragma unroll
    for (int r = 0; r < RP; ++r) acc[i][r] = 0.f;

  for (int d0 = 0; d0 < D; d0 += P_KC) {
#pragma unroll 8
    for (int j = 0; j < LPT; ++j) {
      const int e = tid + j * P_THREADS, ii = e / P_KC, dd = e % P_KC;
      const int m = m0 + ii, d = d0 + dd;
      xs[ii * P_LD + dd] = (m < M && d < D) ? rows.at(l, m, d) : 0.f;
    }
    // W elements in the order that keeps neighbouring threads on
    // neighbouring addresses.
#pragma unroll
    for (int j = 0; j < P_KC * RP / P_THREADS; ++j) {
      const int e = tid + j * P_THREADS;
      const int dd = w_rows ? e / RP : e % P_KC, r = w_rows ? e % RP : e / P_KC, d = d0 + dd;
      ws[dd * RP + r] = (d < D && r < R) ? to_f<W>(wl_[(size_t)d * wd + (size_t)r * wr]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < P_KC / 16; ++c) {
      const int dd = dq + 16 * c;
      float xv[TRW];
#pragma unroll
      for (int i = 0; i < TRW; ++i) xv[i] = xs[(row0 + i) * P_LD + dd];
#pragma unroll
      for (int r4 = 0; r4 < RP; r4 += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(&ws[dd * RP + r4]);
#pragma unroll
        for (int i = 0; i < TRW; ++i) {
          acc[i][r4] = fmaf(xv[i], wv.x, acc[i][r4]);
          acc[i][r4 + 1] = fmaf(xv[i], wv.y, acc[i][r4 + 1]);
          acc[i][r4 + 2] = fmaf(xv[i], wv.z, acc[i][r4 + 2]);
          acc[i][r4 + 3] = fmaf(xv[i], wv.w, acc[i][r4 + 3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TRW; ++i)
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      float v = acc[i][r];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[i][r] = v;
    }
  if (dq == 0) {
#pragma unroll
    for (int i = 0; i < TRW; ++i) {
      const int m = m0 + row0 + i;
#pragma unroll
      for (int r = 0; r < RP; ++r)
        if (m < M && r < R) out[((size_t)l * M + m) * R + r] = acc[i][r];
    }
  }
}

template <typename Rows, typename W, int RP>
cudaError_t launch_project_rp(Rows rows, const W* w, size_t wl, size_t wd, size_t wr, float* out,
                              int L, int M, int D, int R, cudaStream_t s) {
  const dim3 grid((M + ProjectShape<RP>::TM - 1) / ProjectShape<RP>::TM, L);
  project<Rows, W, RP><<<grid, P_THREADS, 0, s>>>(rows, w, wl, wd, wr, out, M, D, R);
  return cudaGetLastError();
}

template <typename Rows, typename W>
cudaError_t launch_project(Rows rows, const W* w, size_t wl, size_t wd, size_t wr, float* out,
                           int L, int M, int D, int R, cudaStream_t s) {
  if (R <= 4) return launch_project_rp<Rows, W, 4>(rows, w, wl, wd, wr, out, L, M, D, R, s);
  if (R <= 8) return launch_project_rp<Rows, W, 8>(rows, w, wl, wd, wr, out, L, M, D, R, s);
  if (R <= 16) return launch_project_rp<Rows, W, 16>(rows, w, wl, wd, wr, out, L, M, D, R, s);
  if (R <= 32) return launch_project_rp<Rows, W, 32>(rows, w, wl, wd, wr, out, L, M, D, R, s);
  return launch_project_rp<Rows, W, 64>(rows, w, wl, wd, wr, out, L, M, D, R, s);
}

// expand: out[m, d] = sum_k z[k / R, m, k % R] * B[k, d], k = l * R + r.
// Thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3,
// read as one float4 each from the staged (transposed) z and B tiles.
template <typename W>
__global__ void __launch_bounds__(E_THREADS)
expand(const float* __restrict__ z, const W* __restrict__ b, float* __restrict__ out,
       int L, int M, int D, int R) {
  constexpr int ZLD = E_TM + 4;
  __shared__ __align__(16) float zs[E_KK * ZLD];     // [kk][row]
  __shared__ __align__(16) float bs[E_KK * E_TD];    // [kk][column]
  const int m0 = blockIdx.x * E_TM, d0 = blockIdx.y * E_TD, tid = threadIdx.x;
  const int ty = tid >> 5, tx = tid & 31;
  const int K = L * R;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < K; k0 += E_KK) {
#pragma unroll
    for (int j = 0; j < E_TM * E_KK / E_THREADS; ++j) {
      const int e = tid + j * E_THREADS, ii = e / E_KK, kk = e % E_KK, m = m0 + ii, k = k0 + kk;
      zs[kk * ZLD + ii] = (m < M && k < K) ? z[((size_t)(k / R) * M + m) * R + k % R] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < E_KK * E_TD / E_THREADS; ++j) {
      const int e = tid + j * E_THREADS, kk = e / E_TD, dd = e % E_TD, k = k0 + kk, d = d0 + dd;
      bs[e] = (k < K && d < D) ? to_f<W>(b[(size_t)k * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < E_KK; ++kk) {
      const float4 zv = *reinterpret_cast<const float4*>(&zs[kk * ZLD + ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk * E_TD + tx * 4]);
      const float zr[4] = {zv.x, zv.y, zv.z, zv.w};
      const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(zr[i], bc[c], acc[i][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = d0 + tx * 4 + c;
      if (m < M && d < D) out[(size_t)m * D + d] = acc[i][c];
    }
  }
}

template <typename W>
cudaError_t launch_expand(const float* z, const W* b, float* out, int L, int M, int D, int R,
                          cudaStream_t s) {
  const dim3 grid((M + E_TM - 1) / E_TM, (D + E_TD - 1) / E_TD);
  expand<W><<<grid, E_THREADS, 0, s>>>(z, b, out, L, M, D, R);
  return cudaGetLastError();
}

// Forward: project then expand. z is an (L, M, R) fp32 scratch buffer.
template <typename W>
int forward(const float* x, const W* a, const W* b, float* z, float* out, int L, int M, int D, int R,
            cudaStream_t s) {
  if (L < 1 || M < 1 || D < 1 || R < 1 || R > R_MAX) return (int)cudaErrorInvalidValue;
  const DenseRows rows{x, (size_t)M * D, D};
  cudaError_t err = launch_project(rows, a, (size_t)D * R, (size_t)R, (size_t)1, z, L, M, D, R, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_expand(z, b, out, L, M, D, R, s);
}

// outer: for rows [c * chunk, (c + 1) * chunk) of layer l,
//   pa[c, l, d, r] = sum_m x[l, m, d] * gz[l, m, r]
//   pb[c, l, r, d] = sum_m g[m, d]    * z[l, m, r]
// one column d per thread, 2 RP fp32 accumulators. SUB rows at a time: their
// z and gz rows are staged in shared memory, and each thread loads its SUB
// x and g values together before using them.
template <int RP>
__global__ void __launch_bounds__(O_TD, RP <= 16 ? 4 : 2)
outer(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ z,
      const float* __restrict__ gz, float* __restrict__ pa, float* __restrict__ pb,
      int L, int M, int D, int R, int chunk) {
  constexpr int SUB = RP <= 16 ? 32 : 8;
  __shared__ __align__(16) float zs[SUB * RP];
  __shared__ __align__(16) float gzs[SUB * RP];
  const int l = blockIdx.x, c = blockIdx.z, tid = threadIdx.x;
  const int d = blockIdx.y * O_TD + tid;
  const int m_lo = c * chunk, m_hi = min(M, m_lo + chunk);
  float acc_a[RP], acc_b[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) acc_a[r] = acc_b[r] = 0.f;
  for (int s0 = m_lo; s0 < m_hi; s0 += SUB) {
    const int n = min(SUB, m_hi - s0);
#pragma unroll
    for (int j = 0; j < (SUB * RP + O_TD - 1) / O_TD; ++j) {
      const int e = tid + j * O_TD, i = e / RP, r = e % RP;
      if (e < SUB * RP) {
        const bool live = i < n && r < R;
        const size_t at = ((size_t)l * M + s0 + i) * R + r;
        zs[e] = live ? z[at] : 0.f;
        gzs[e] = live ? gz[at] : 0.f;
      }
    }
    float xv[SUB], gv[SUB];
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const bool live = i < n && d < D;
      xv[i] = live ? x[((size_t)l * M + s0 + i) * D + d] : 0.f;
      gv[i] = live ? g[(size_t)(s0 + i) * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
#pragma unroll
      for (int r4 = 0; r4 < RP; r4 += 4) {
        const float4 gzv = *reinterpret_cast<const float4*>(&gzs[i * RP + r4]);
        const float4 zv = *reinterpret_cast<const float4*>(&zs[i * RP + r4]);
        acc_a[r4] = fmaf(xv[i], gzv.x, acc_a[r4]);
        acc_a[r4 + 1] = fmaf(xv[i], gzv.y, acc_a[r4 + 1]);
        acc_a[r4 + 2] = fmaf(xv[i], gzv.z, acc_a[r4 + 2]);
        acc_a[r4 + 3] = fmaf(xv[i], gzv.w, acc_a[r4 + 3]);
        acc_b[r4] = fmaf(gv[i], zv.x, acc_b[r4]);
        acc_b[r4 + 1] = fmaf(gv[i], zv.y, acc_b[r4 + 1]);
        acc_b[r4 + 2] = fmaf(gv[i], zv.z, acc_b[r4 + 2]);
        acc_b[r4 + 3] = fmaf(gv[i], zv.w, acc_b[r4 + 3]);
      }
    }
    __syncthreads();
  }
  if (d < D) {
    const size_t base = (size_t)c * L + l;
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      if (r < R) {
        pa[(base * D + d) * R + r] = acc_a[r];
        pb[(base * R + r) * D + d] = acc_b[r];
      }
    }
  }
}

// reduce: out[i] = sum_c part[c * n + i] in chunk order, for gA and gB.
__global__ void reduce_chunks(const float* __restrict__ pa, const float* __restrict__ pb,
                              float* __restrict__ ga, float* __restrict__ gb, size_t n, int chunks) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float sa = 0.f, sb = 0.f;
    for (int c = 0; c < chunks; ++c) {
      sa += pa[(size_t)c * n + i];
      sb += pb[(size_t)c * n + i];
    }
    ga[i] = sa;
    gb[i] = sb;
  }
}

// gA, gB (n elements each) from `chunks` partials of each, added in chunk order.
inline cudaError_t launch_reduce(const float* pa, const float* pb, float* ga, float* gb, size_t n, int chunks,
                                 cudaStream_t s) {
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  reduce_chunks<<<blocks, 256, 0, s>>>(pa, pb, ga, gb, n, chunks);
  return cudaGetLastError();
}

// Backward, the sum over M in chunks of `chunk` rows. Scratch: z, gz
// (L, M, R) fp32; pa, pb (chunks, L, D, R) / (chunks, L, R, D) fp32, unused
// (may be null) when there is one chunk, in which case outer writes gA and
// gB directly.
template <typename W>
int backward(const float* x, const W* a, const W* b, const float* g, float* z, float* gz, float* pa,
             float* pb, float* ga, float* gb, int L, int M, int D, int R, int chunk, cudaStream_t s) {
  if (L < 1 || M < 1 || D < 1 || R < 1 || R > R_MAX || chunk < 1) return (int)cudaErrorInvalidValue;
  const DenseRows xr{x, (size_t)M * D, D};
  const DenseRows gr{g, 0, D};
  cudaError_t err = launch_project(xr, a, (size_t)D * R, (size_t)R, (size_t)1, z, L, M, D, R, s);
  if (err != cudaSuccess) return (int)err;
  // gz[l, m, r] = sum_d g[m, d] B[l, r, d]: B[l] read as a (D, R) matrix with strides (1, D).
  err = launch_project(gr, b, (size_t)R * D, (size_t)1, (size_t)D, gz, L, M, D, R, s);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (M + chunk - 1) / chunk;
  float* oa = chunks == 1 ? ga : pa;
  float* ob = chunks == 1 ? gb : pb;
  const dim3 grid(L, (D + O_TD - 1) / O_TD, chunks);
  if (R <= 4)
    outer<4><<<grid, O_TD, 0, s>>>(x, g, z, gz, oa, ob, L, M, D, R, chunk);
  else if (R <= 8)
    outer<8><<<grid, O_TD, 0, s>>>(x, g, z, gz, oa, ob, L, M, D, R, chunk);
  else if (R <= 16)
    outer<16><<<grid, O_TD, 0, s>>>(x, g, z, gz, oa, ob, L, M, D, R, chunk);
  else if (R <= 32)
    outer<32><<<grid, O_TD, 0, s>>>(x, g, z, gz, oa, ob, L, M, D, R, chunk);
  else
    outer<64><<<grid, O_TD, 0, s>>>(x, g, z, gz, oa, ob, L, M, D, R, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  return (int)launch_reduce(pa, pb, ga, gb, (size_t)L * D * R, chunks, s);
}

}  // namespace ssk
