// Grouped skip-LoRA forward for Hopper (sm_90a): the body shared by the
// float-pool kernel (grouped_skip_sum_fwd.cu) and the int8-pool kernel
// (grouped_skip_sum_fwd_int8.cu).
//
//   out[m] = sum_l cast_x( x[l, m] @ cast_x(A[g, l]) ) @ cast_x(B[g, l])
//
// with g the adapter slot of the row's tile, fp32 accumulation, and every
// cast to the activation type placed where the reference puts it
// (src/repro/kernels/skip_lora/kernel.py, _grouped_fwd_kernel).
//
// What bounds it: bytes. The adapter rank R is 4..64, so each x element
// meets at most 2R multiply-adds; at the serve shapes (a handful of rows,
// L = 24, D = 2048) the kernel must read every active slot's A and B blocks
// (2 L D R elements per slot) and little else. The design reads each adapter
// element once per row tile, neighbouring threads on neighbouring addresses,
// and keeps many independent loads in flight per thread, since at a few rows
// the time goes to memory latency, not to arithmetic:
//
//   phase 1, one block per (row tile, layer): threads stride over D, U
//     columns per step with all their loads issued together; each thread
//     loads the R values of one A row and the tile's x values at that
//     column, and accumulates (rows x R) partial sums in registers. A warp
//     shuffle plus one pass through shared memory reduces them; z
//     is rounded to the activation type and stored as fp32 in a small
//     (L, M_pad, R) scratch buffer.
//   phase 2, one block per (row tile, P2_THREADS output columns): each
//     thread owns one output column and walks the L*R (layer, rank) pairs
//     KC at a time: KC loads of B issued together, the z values of RG tile
//     rows for those pairs staged in shared memory, one fp32 accumulator per
//     row. Rows are written straight back to their original positions, so
//     no grouped copy of x or out is made.
//
// Rows reach a tile through `row_src` (M_pad,) int32: the original row of
// each grouped position, or -1 for padding. `tile_slot` (M_pad / tm,) int32
// gives each tile's slot; a tile with no live rows returns at once.
// Tensor cores, TMA and a fused single pass are left for later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "numerics.cuh"

namespace gss {

constexpr int TM_MAX = 32;       // most rows in one tile (one warp's ballot)
constexpr int R_MAX = 64;        // highest adapter rank
constexpr int ACC = 64;          // phase-1 register accumulators per thread
constexpr int P1_THREADS = 256;
constexpr int P2_THREADS = 64;   // one output column per thread
constexpr int KC = 32;           // (layer, rank) pairs per phase-2 step
constexpr int RG = 8;            // tile rows per phase-2 pass

using rtk::from_f;
using rtk::round_to;
using rtk::to_f;

// Adapter elements as fp32, before the cast to the activation type. A pool
// is (N, L, D, R) and B pool (N, L, R, D), so both read as 2-D row-major:
// A row `(g * L + l) * D + d` holds R values, B row `(g * L + l) * R + r`
// holds D values.
template <typename P> struct FloatPool {
  const P* A;
  const P* B;
  __device__ __forceinline__ float a(size_t row, int R, int r) const {
    return to_f<P>(A[row * R + r]);
  }
  __device__ __forceinline__ float b(size_t row, int D, int d) const {
    return to_f<P>(B[row * D + d]);
  }
};

// int8 payload times its fp32 rowwise scale (scales over the last axis:
// SA (N, L, D) and SB (N, L, R) are indexed by the same rows).
struct Int8Pool {
  const int8_t* QA;
  const float* SA;
  const int8_t* QB;
  const float* SB;
  __device__ __forceinline__ float a(size_t row, int R, int r) const {
    return (float)QA[row * R + r] * SA[row];
  }
  __device__ __forceinline__ float b(size_t row, int D, int d) const {
    return (float)QB[row * D + d] * SB[row];
  }
};

// Live rows of tile t, in grouped order, into rows[]; returns their count.
// Warp 0 reads the tile's row_src entries (tm <= 32) and compacts them with
// a ballot; the block waits at the barrier.
__device__ __forceinline__ int tile_rows(const int* row_src, int t, int tm, int* rows, int* n_live) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int s = lane < tm ? row_src[(size_t)t * tm + lane] : -1;
    const unsigned live = __ballot_sync(0xffffffffu, s >= 0);
    if (s >= 0) rows[__popc(live & ((1u << lane) - 1u))] = s;
    if (lane == 0) *n_live = __popc(live);
  }
  __syncthreads();
  return *n_live;
}

// Phase 1: z[l, t*tm + i, :] = cast_x( x[l, rows[i], :] @ cast_x(A[g, l]) ).
// RP is R rounded up to a power of two >= 4; G = ACC / RP rows per pass;
// U columns per thread per step (fewer at high rank, to fit registers).
template <typename T, typename Pool, int RP>
__global__ void __launch_bounds__(P1_THREADS)
project_a(const T* __restrict__ x, Pool pool, const int* __restrict__ row_src,
          const int* __restrict__ tile_slot, float* __restrict__ z,
          int L, int M, int D, int R, int tm, int m_pad) {
  constexpr int G = ACC / RP;
  constexpr int U = RP <= 16 ? 4 : 1;
  __shared__ int rows[TM_MAX];
  __shared__ int n_live;
  __shared__ float red[P1_THREADS / 32][ACC];
  const int t = blockIdx.x, l = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nlive = tile_rows(row_src, t, tm, rows, &n_live);
  if (nlive == 0) return;
  const size_t gl = (size_t)tile_slot[t] * L + l;

  for (int i0 = 0; i0 < nlive; i0 += G) {
    const int n = min(G, nlive - i0);
    float acc[ACC];
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
    for (int d0 = tid; d0 < D; d0 += P1_THREADS * U) {
      float a[U][RP];
      float xv[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int d = d0 + u * P1_THREADS;
#pragma unroll
        for (int r = 0; r < RP; ++r)
          a[u][r] = (d < D && r < R) ? round_to<T>(pool.a(gl * D + d, R, r)) : 0.f;
#pragma unroll
        for (int i = 0; i < G; ++i)
          xv[u][i] = (d < D && i < n) ? to_f<T>(x[((size_t)l * M + rows[i0 + i]) * D + d]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < G; ++i)
#pragma unroll
          for (int r = 0; r < RP; ++r) acc[i * RP + r] = fmaf(xv[u][i], a[u][r], acc[i * RP + r]);
    }
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      float v = acc[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][j] = v;
    }
    __syncthreads();
    if (tid < ACC) {
      const int i = tid / RP, r = tid % RP;
      if (i < n && r < R) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < P1_THREADS / 32; ++w) s += red[w][tid];
        z[((size_t)l * m_pad + (size_t)t * tm + i0 + i) * R + r] = round_to<T>(s);
      }
    }
    __syncthreads();
  }
}

// Phase 2: out[rows[i], d] = cast_x( sum_(l,r) z[l, t*tm + i, r] * cast_x(B[g, l, r, d]) ),
// the (layer, rank) pairs taken in order k = l * R + r. Rows go RG at a
// time with rows past the tile's end zero-filled, so every register array
// is indexed by compile-time constants only (a bound that depends on the
// live-row count sends the accumulators to local memory).
template <typename T, typename Pool>
__global__ void __launch_bounds__(P2_THREADS)
project_b(const float* __restrict__ z, Pool pool, const int* __restrict__ row_src,
          const int* __restrict__ tile_slot, T* __restrict__ out,
          int L, int D, int R, int tm, int m_pad) {
  __shared__ int rows[TM_MAX];
  __shared__ int n_live;
  __shared__ float zs[RG][KC];
  __shared__ float res[RG][P2_THREADS];
  const int t = blockIdx.x, tid = threadIdx.x;
  const int d = blockIdx.y * P2_THREADS + tid;
  const int nlive = tile_rows(row_src, t, tm, rows, &n_live);
  if (nlive == 0) return;
  const size_t row0 = (size_t)tile_slot[t] * L * R;   // B row of (g, l=0, r=0)
  const int K = L * R;

  for (int i0 = 0; i0 < nlive; i0 += RG) {
    const int n = min(RG, nlive - i0);
    float acc[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
      float bv[KC];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        bv[kk] = (d < D && k0 + kk < K) ? round_to<T>(pool.b(row0 + k0 + kk, D, d)) : 0.f;
      for (int e = tid; e < RG * KC; e += P2_THREADS) {
        const int i = e / KC, k = k0 + e % KC;
        zs[i][e % KC] = (i < n && k < K)
            ? z[((size_t)(k / R) * m_pad + (size_t)t * tm + i0 + i) * R + k % R] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
#pragma unroll
        for (int i = 0; i < RG; ++i) acc[i] = fmaf(zs[i][kk], bv[kk], acc[i]);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) res[i][tid] = acc[i];
    if (d < D)
      for (int i = 0; i < n; ++i) out[(size_t)rows[i0 + i] * D + d] = from_f<T>(res[i][tid]);
  }
}

// Both phases on `stream`; returns the first launch error (0 if none).
template <typename T, typename Pool>
int run(const void* x, Pool pool, const int* row_src, const int* tile_slot, float* z,
        void* out, int L, int M, int D, int R, int tm, int n_tiles, cudaStream_t stream) {
  if (tm < 1 || tm > TM_MAX || R < 1 || R > R_MAX || L < 1 || D < 1 || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  const int m_pad = n_tiles * tm;
  const T* xt = static_cast<const T*>(x);
  const dim3 g1(n_tiles, L);
  if (R <= 4)
    project_a<T, Pool, 4><<<g1, P1_THREADS, 0, stream>>>(xt, pool, row_src, tile_slot, z, L, M, D, R, tm, m_pad);
  else if (R <= 8)
    project_a<T, Pool, 8><<<g1, P1_THREADS, 0, stream>>>(xt, pool, row_src, tile_slot, z, L, M, D, R, tm, m_pad);
  else if (R <= 16)
    project_a<T, Pool, 16><<<g1, P1_THREADS, 0, stream>>>(xt, pool, row_src, tile_slot, z, L, M, D, R, tm, m_pad);
  else if (R <= 32)
    project_a<T, Pool, 32><<<g1, P1_THREADS, 0, stream>>>(xt, pool, row_src, tile_slot, z, L, M, D, R, tm, m_pad);
  else
    project_a<T, Pool, 64><<<g1, P1_THREADS, 0, stream>>>(xt, pool, row_src, tile_slot, z, L, M, D, R, tm, m_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(n_tiles, (D + P2_THREADS - 1) / P2_THREADS);
  project_b<T, Pool><<<g2, P2_THREADS, 0, stream>>>(z, pool, row_src, tile_slot, static_cast<T*>(out),
                                                    L, D, R, tm, m_pad);
  return (int)cudaGetLastError();
}

}  // namespace gss
