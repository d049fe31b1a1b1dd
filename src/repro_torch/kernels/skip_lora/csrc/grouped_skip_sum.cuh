// Grouped skip-LoRA for Hopper (sm_90a): the bodies shared by the grouped
// kernels of this directory.
//
//   forward   out[m] = sum_l cast_x( x[l, m] @ cast_x(A[g, l]) ) @ cast_x(B[g, l])
//   backward  gA[n, l] = sum_{m in n} x[l, m]^T cast_x(g[m] @ cast_x(B[n, l])^T)
//             gB[n, l] = sum_{m in n} cast_x(x[l, m] @ cast_x(A[n, l]))^T g[m]
//
// with g the adapter slot of the row's tile, fp32 accumulation, and every
// cast to the activation type placed where the reference puts it
// (src/repro/kernels/skip_lora/kernel.py, _grouped_fwd_kernel and its int8,
// q4 and actint8 forms, _grouped_bwd_kernel). The forward's activations are
// float rows (K5, K6, K7) or int8 rows with a per-row scale (K8); its pool is
// float (K5, K8), int8 (K6) or packed 4-bit (K7). The backward (K9) takes
// float rows and a float pool.
//
// What bounds them: bytes. The adapter rank R is 4..64, so each x element
// meets at most 2R multiply-adds; at the serve shapes (a handful of rows,
// L = 24, D = 2048) the forward must read every active slot's A and B blocks
// (2 L D R elements per slot) and little else, at the fleet shape (M = 1024
// rows) x itself. The design reads each adapter element once per row tile,
// neighbouring threads on neighbouring addresses, and keeps many independent
// loads in flight per thread, since at a few rows the time goes to memory
// latency, not to arithmetic:
//
//   project, one block per (row tile, layer): threads stride over D, U
//     columns per step with all their loads issued together; each thread
//     loads the R values of one W row and the tile's x values at that
//     column, and accumulates (rows x R) partial sums in registers. A warp
//     shuffle plus one pass through shared memory reduces them; the result
//     is rounded to the activation type and stored as fp32 in a small
//     (L, M_pad, R) scratch buffer. W is A (z = x A), or B read as its
//     transpose (gz = g B^T in the backward, x the same g for every layer).
//   expand (forward), one block per (row tile, P2_THREADS output columns):
//     each thread owns one output column and walks the L*R (layer, rank)
//     pairs KC at a time: KC loads of B issued together, the z values of RG
//     tile rows for those pairs staged in shared memory, one fp32
//     accumulator per row. Rows are written straight back to their original
//     positions, so no grouped copy of x or out is made.
//   outer (backward), one block per (slot, layer, O_TD columns): the block
//     finds its slot's contiguous run of tiles in `tile_slot` (non-decreasing)
//     by binary search and walks those tiles' rows in order, one column of D
//     per thread, 2 R fp32 accumulators. A GPU grid has no order, so the
//     TPU kernel's first-visit init on a sequential grid becomes this loop
//     inside one block: each (slot, layer) block is summed by one block in a
//     fixed order, with no atomics and no cross-block reduction, so the
//     gradients are the same bits on every run. A slot with no rows gets
//     zeros.
//
// Rows reach a tile through `row_src` (M_pad,) int32: the original row of
// each grouped position, or -1 for padding. `tile_slot` (M_pad / tm,) int32
// gives each tile's slot; a tile with no live rows is skipped. Tensor cores,
// TMA and fused single passes are left for later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "numerics.cuh"

namespace gss {

constexpr int TM_MAX = 32;       // most rows in one tile (one warp's ballot)
constexpr int R_MAX = 64;        // highest adapter rank
constexpr int ACC = 64;          // project register accumulators per thread
constexpr int P1_THREADS = 256;
constexpr int P2_THREADS = 64;   // one output column per thread
constexpr int KC = 32;           // (layer, rank) pairs per expand step
constexpr int RG = 8;            // tile rows per expand pass
constexpr int O_TD = 128;        // columns per outer block, one per thread

using rtk::from_f;
using rtk::round_to;
using rtk::to_f;

// ---------------------------------------------------------------------------
// Pools: adapter elements as fp32, before the cast to the activation type.
// A pool is (N, L, D, R) and B pool (N, L, R, D), so both read as 2-D
// row-major: A row `(g * L + l) * D + d` holds R values, B row
// `(g * L + l) * R + r` holds D values. `stage` copies what the pool keeps
// in shared memory (the 4-bit codebook) and `bind` points the accessors at
// it; both are no-ops for the other pools.
// ---------------------------------------------------------------------------

template <typename P> struct FloatPool {
  const P* A;
  const P* B;
  static constexpr int SMEM = 1;
  __device__ __forceinline__ void stage(float*) const {}
  __device__ __forceinline__ void bind(const float*) {}
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
  static constexpr int SMEM = 1;
  __device__ __forceinline__ void stage(float*) const {}
  __device__ __forceinline__ void bind(const float*) {}
  __device__ __forceinline__ float a(size_t row, int R, int r) const {
    return (float)QA[row * R + r] * SA[row];
  }
  __device__ __forceinline__ float b(size_t row, int D, int d) const {
    return (float)QB[row * D + d] * SB[row];
  }
};

// Packed 4-bit payload: two codebook indices per byte along the last axis,
// the even position in the low nibble; QA (N, L, D, R/2), QB (N, L, R, D/2).
// An element is code[nibble] * rowwise scale in fp32. The 16-entry codebook
// (int4 or nf4 levels) sits in shared memory, where the divergent lookups
// of a warp hit distinct banks.
struct Q4Pool {
  const uint8_t* QA;
  const float* SA;
  const uint8_t* QB;
  const float* SB;
  const float* code;   // (16,) in device memory
  const float* cs;     // the same 16 values in shared memory, after bind()
  static constexpr int SMEM = 16;
  __device__ __forceinline__ void stage(float* sm) const {
    if (threadIdx.x < 16) sm[threadIdx.x] = code[threadIdx.x];
  }
  __device__ __forceinline__ void bind(const float* sm) { cs = sm; }
  __device__ __forceinline__ float a(size_t row, int R, int r) const {
    const unsigned byte = QA[row * (size_t)(R >> 1) + (r >> 1)];
    return cs[(r & 1) ? (byte >> 4) : (byte & 15u)] * SA[row];
  }
  __device__ __forceinline__ float b(size_t row, int D, int d) const {
    const unsigned byte = QB[row * (size_t)(D >> 1) + (d >> 1)];
    return cs[(d & 1) ? (byte >> 4) : (byte & 15u)] * SB[row];
  }
};

// The (D, R) matrix a project pass multiplies by, for pool row block gl =
// g * L + l: A itself, or B read as its transpose.
template <typename Pool> struct ViewA {
  static constexpr int SMEM = Pool::SMEM;
  Pool p;
  int D, R;
  __device__ __forceinline__ float w(size_t gl, int d, int r) const { return p.a(gl * D + d, R, r); }
};
template <typename Pool> struct ViewBT {
  static constexpr int SMEM = Pool::SMEM;
  Pool p;
  int D, R;
  __device__ __forceinline__ float w(size_t gl, int d, int r) const { return p.b(gl * R + r, D, d); }
};

// ---------------------------------------------------------------------------
// Activation rows, read as fp32 values of the activation type:
// `at(l, m, d, row_scale(l, m))`. `layer_stride` 0 gives every layer the
// same matrix (g in the backward).
// ---------------------------------------------------------------------------

template <typename T> struct DenseActs {
  const T* x;
  size_t layer_stride;
  int D;
  __device__ __forceinline__ float row_scale(int, int) const { return 1.f; }
  __device__ __forceinline__ float at(int l, int m, int d, float) const {
    return to_f<T>(x[(size_t)l * layer_stride + (size_t)m * D + d]);
  }
};

// int8 payload times its fp32 per-row scale, rounded to bf16 as the
// reference's `(q.astype(f32) * s).astype(bf16)`.
struct Int8Acts {
  const int8_t* q;
  const float* s;
  int M, D;
  __device__ __forceinline__ float row_scale(int l, int m) const { return s[(size_t)l * M + m]; }
  __device__ __forceinline__ float at(int l, int m, int d, float scale) const {
    return round_to<__nv_bfloat16>((float)q[((size_t)l * M + m) * D + d] * scale);
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

// project: P[l, t*tm + i, :] = cast_T( X(l, rows[i], :) @ cast_T(W[g, l]) ).
// RP is R rounded up to a power of two >= 4; G = ACC / RP rows per pass;
// U columns per thread per step (fewer at high rank, to fit registers).
template <typename T, typename Acts, typename W, int RP>
__global__ void __launch_bounds__(P1_THREADS)
project_a(Acts acts, W w, const int* __restrict__ row_src, const int* __restrict__ tile_slot,
          float* __restrict__ z, int L, int D, int R, int tm, int m_pad) {
  constexpr int G = ACC / RP;
  constexpr int U = RP <= 16 ? 4 : 1;
  __shared__ int rows[TM_MAX];
  __shared__ float rs[TM_MAX];   // per-row scales (int8 rows), staged once
  __shared__ int n_live;
  __shared__ float pool_sm[W::SMEM];
  __shared__ float red[P1_THREADS / 32][ACC];
  const int t = blockIdx.x, l = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  w.p.stage(pool_sm);
  w.p.bind(pool_sm);
  const int nlive = tile_rows(row_src, t, tm, rows, &n_live);
  if (nlive == 0) return;
  if (tid < nlive) rs[tid] = acts.row_scale(l, rows[tid]);
  __syncthreads();
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
          a[u][r] = (d < D && r < R) ? round_to<T>(w.w(gl, d, r)) : 0.f;
#pragma unroll
        for (int i = 0; i < G; ++i)
          xv[u][i] = (d < D && i < n) ? acts.at(l, rows[i0 + i], d, rs[i0 + i]) : 0.f;
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
        for (int wi = 0; wi < P1_THREADS / 32; ++wi) s += red[wi][tid];
        z[((size_t)l * m_pad + (size_t)t * tm + i0 + i) * R + r] = round_to<T>(s);
      }
    }
    __syncthreads();
  }
}

// expand: out[rows[i], d] = cast_x( sum_(l,r) z[l, t*tm + i, r] * cast_x(B[g, l, r, d]) ),
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
  __shared__ float pool_sm[Pool::SMEM];
  __shared__ float zs[RG][KC];
  __shared__ float res[RG][P2_THREADS];
  const int t = blockIdx.x, tid = threadIdx.x;
  const int d = blockIdx.y * P2_THREADS + tid;
  pool.stage(pool_sm);
  pool.bind(pool_sm);
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

template <typename T, typename Acts, typename W>
cudaError_t launch_project(Acts acts, W w, const int* row_src, const int* tile_slot, float* z,
                           int L, int D, int R, int tm, int n_tiles, cudaStream_t s) {
  const int m_pad = n_tiles * tm;
  const dim3 g(n_tiles, L);
  if (R <= 4)
    project_a<T, Acts, W, 4><<<g, P1_THREADS, 0, s>>>(acts, w, row_src, tile_slot, z, L, D, R, tm, m_pad);
  else if (R <= 8)
    project_a<T, Acts, W, 8><<<g, P1_THREADS, 0, s>>>(acts, w, row_src, tile_slot, z, L, D, R, tm, m_pad);
  else if (R <= 16)
    project_a<T, Acts, W, 16><<<g, P1_THREADS, 0, s>>>(acts, w, row_src, tile_slot, z, L, D, R, tm, m_pad);
  else if (R <= 32)
    project_a<T, Acts, W, 32><<<g, P1_THREADS, 0, s>>>(acts, w, row_src, tile_slot, z, L, D, R, tm, m_pad);
  else
    project_a<T, Acts, W, 64><<<g, P1_THREADS, 0, s>>>(acts, w, row_src, tile_slot, z, L, D, R, tm, m_pad);
  return cudaGetLastError();
}

inline bool bad_geometry(int L, int D, int R, int tm, int n_tiles) {
  return tm < 1 || tm > TM_MAX || R < 1 || R > R_MAX || L < 1 || D < 1 || n_tiles < 1;
}

// Forward, both passes on `stream`; returns the first launch error (0 if
// none). T is the activation (and output) type.
template <typename T, typename Acts, typename Pool>
int run(Acts acts, Pool pool, const int* row_src, const int* tile_slot, float* z, void* out,
        int L, int D, int R, int tm, int n_tiles, cudaStream_t stream) {
  if (bad_geometry(L, D, R, tm, n_tiles)) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_project<T>(acts, ViewA<Pool>{pool, D, R}, row_src, tile_slot, z,
                                      L, D, R, tm, n_tiles, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(n_tiles, (D + P2_THREADS - 1) / P2_THREADS);
  project_b<T, Pool><<<g2, P2_THREADS, 0, stream>>>(z, pool, row_src, tile_slot, static_cast<T*>(out),
                                                    L, D, R, tm, n_tiles * tm);
  return (int)cudaGetLastError();
}

// First index in the non-decreasing a[0..n) whose value is >= v.
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// outer: for slot n = blockIdx.x and layer l = blockIdx.y,
//   gA[n, l, d, r] = sum over the slot's rows of x[l, row, d] * gz[l, pos, r]
//   gB[n, l, r, d] = sum over the slot's rows of g[row, d]    * z[l, pos, r]
// tile by tile in grouped order, SUB rows at a time; each tile's z and gz
// rows are staged in shared memory, and each thread loads its SUB x and g
// values together before using them.
template <typename T, int RP>
__global__ void __launch_bounds__(O_TD)
outer(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ z,
      const float* __restrict__ gz, const int* __restrict__ row_src,
      const int* __restrict__ tile_slot, float* __restrict__ ga, float* __restrict__ gb,
      int L, int M, int D, int R, int tm, int n_tiles) {
  constexpr int SUB = RP <= 16 ? 16 : 8;
  __shared__ int range[2];
  __shared__ int rows[TM_MAX];
  __shared__ int n_live;
  __shared__ __align__(16) float zs[TM_MAX * RP];
  __shared__ __align__(16) float gzs[TM_MAX * RP];
  const int n = blockIdx.x, l = blockIdx.y, tid = threadIdx.x;
  const int d = blockIdx.z * O_TD + tid;
  const size_t m_pad = (size_t)n_tiles * tm;
  if (tid == 0) {
    range[0] = lower_bound(tile_slot, n_tiles, n);
    range[1] = lower_bound(tile_slot, n_tiles, n + 1);
  }
  __syncthreads();
  const int t_lo = range[0], t_hi = range[1];
  float acc_a[RP], acc_b[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) acc_a[r] = acc_b[r] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int nlive = tile_rows(row_src, t, tm, rows, &n_live);
    for (int e = tid; e < TM_MAX * RP; e += O_TD) {
      const int i = e / RP, r = e % RP;
      const bool live = i < nlive && r < R;
      const size_t at = ((size_t)l * m_pad + (size_t)t * tm + i) * R + r;
      zs[e] = live ? z[at] : 0.f;
      gzs[e] = live ? gz[at] : 0.f;
    }
    __syncthreads();
    for (int i0 = 0; i0 < nlive; i0 += SUB) {
      float xv[SUB], gv[SUB];
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const bool live = i0 + i < nlive && d < D;
        const int row = live ? rows[i0 + i] : 0;
        xv[i] = live ? to_f<T>(x[((size_t)l * M + row) * D + d]) : 0.f;
        gv[i] = live ? to_f<T>(g[(size_t)row * D + d]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const float* zr = &zs[(i0 + i) * RP];
        const float* gzr = &gzs[(i0 + i) * RP];
#pragma unroll
        for (int r4 = 0; r4 < RP; r4 += 4) {
          const float4 gzv = *reinterpret_cast<const float4*>(gzr + r4);
          const float4 zv = *reinterpret_cast<const float4*>(zr + r4);
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
    }
    __syncthreads();   // rows[], n_live, zs and gzs are rewritten by the next tile
  }
  if (d < D) {
    const size_t nl = (size_t)n * L + l;
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      if (r < R) {
        ga[(nl * D + d) * R + r] = acc_a[r];
        gb[(nl * R + r) * D + d] = acc_b[r];
      }
    }
  }
}

// Backward. Scratch: z, gz (L, n_tiles * tm, R) fp32. Writes every element
// of gA (N, L, D, R) and gB (N, L, R, D), zeros for slots with no rows.
template <typename T, typename Pool>
int backward(const T* x, const T* g, Pool pool, const int* row_src, const int* tile_slot, float* z,
             float* gz, float* ga, float* gb, int L, int M, int D, int R, int tm, int n_tiles,
             int n_slots, cudaStream_t s) {
  if (bad_geometry(L, D, R, tm, n_tiles) || M < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_project<T>(DenseActs<T>{x, (size_t)M * D, D}, ViewA<Pool>{pool, D, R},
                                      row_src, tile_slot, z, L, D, R, tm, n_tiles, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_project<T>(DenseActs<T>{g, 0, D}, ViewBT<Pool>{pool, D, R}, row_src, tile_slot, gz,
                          L, D, R, tm, n_tiles, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_slots, L, (D + O_TD - 1) / O_TD);
  if (R <= 4)
    outer<T, 4><<<grid, O_TD, 0, s>>>(x, g, z, gz, row_src, tile_slot, ga, gb, L, M, D, R, tm, n_tiles);
  else if (R <= 8)
    outer<T, 8><<<grid, O_TD, 0, s>>>(x, g, z, gz, row_src, tile_slot, ga, gb, L, M, D, R, tm, n_tiles);
  else if (R <= 16)
    outer<T, 16><<<grid, O_TD, 0, s>>>(x, g, z, gz, row_src, tile_slot, ga, gb, L, M, D, R, tm, n_tiles);
  else if (R <= 32)
    outer<T, 32><<<grid, O_TD, 0, s>>>(x, g, z, gz, row_src, tile_slot, ga, gb, L, M, D, R, tm, n_tiles);
  else
    outer<T, 64><<<grid, O_TD, 0, s>>>(x, g, z, gz, row_src, tile_slot, ga, gb, L, M, D, R, tm, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace gss
