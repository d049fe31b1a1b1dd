// Per-slot adapter gradients of the grouped skip-LoRA sum (K9), for Hopper
// (sm_90a). Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_grouped_bwd.
//
//   gA[n, l] = sum_{m in slot n} x[l, m]^T cast_x(g[m] cast_x(B[n, l])^T)
//   gB[n, l] = sum_{m in slot n} cast_x(x[l, m] cast_x(A[n, l]))^T g[m]
//
// fp32, one (N, L, D, R) and one (N, L, R, D) block per slot; zeros for a
// slot with no rows. No gradient for x: the cached activations are
// constants. The TPU kernel keeps each (slot, layer) block resident while a
// sequential grid walks the slot's contiguous run of row tiles, zeroing it
// on the first visit. Here two project passes write z = cast(x A) and
// gz = cast(g B^T) per (tile, layer) into (L, M_pad, R) scratch, and an outer
// pass gives each (slot, layer, 128 columns) to one block, which finds the
// slot's tile run by binary search in the non-decreasing tile->slot map and
// sums its rows in order: the same bits on every run, no atomics, no final
// cross-block reduction, no host synchronisation.
//
// Bandwidth-bound: x (L M D) is read by both the z projection and the outer
// pass, g (M D) once per layer (from L2 after the first), and gA, gB
// (2 N L D R fp32) written once. See grouped_skip_sum.cuh.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "grouped_skip_sum.cuh"

template <typename T>
static int run_bwd(const void* x, const void* g, const void* a, const void* b, int pool_bf16,
                   const int* row_src, const int* tile_slot, float* z, float* gz, float* ga,
                   float* gb, int L, int M, int D, int R, int tm, int n_tiles, int n_slots,
                   cudaStream_t s) {
  using bf = __nv_bfloat16;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  if (pool_bf16)
    return gss::backward<T>(xt, gt, gss::FloatPool<bf>{(const bf*)a, (const bf*)b}, row_src,
                            tile_slot, z, gz, ga, gb, L, M, D, R, tm, n_tiles, n_slots, s);
  return gss::backward<T>(xt, gt, gss::FloatPool<float>{(const float*)a, (const float*)b}, row_src,
                          tile_slot, z, gz, ga, gb, L, M, D, R, tm, n_tiles, n_slots, s);
}

extern "C" int grouped_skip_sum_bwd(
    const void* x,            // (L, M, D) fp32 or bf16, original row order
    const void* g,            // (M, D), type of x
    const void* a_pool,       // (N, L, D, R) fp32 or bf16
    const void* b_pool,       // (N, L, R, D), same type as a_pool
    const int* row_src,       // (n_tiles * tm,) original row or -1
    const int* tile_slot,     // (n_tiles,) slot of each row tile, non-decreasing
    float* z,                 // (L, n_tiles * tm, R) scratch
    float* gz,                // (L, n_tiles * tm, R) scratch
    float* ga,                // (N, L, D, R)
    float* gb,                // (N, L, R, D)
    int L, int M, int D, int R, int tm, int n_tiles, int n_slots,
    int x_bf16, int pool_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return run_bwd<__nv_bfloat16>(x, g, a_pool, b_pool, pool_bf16, row_src, tile_slot, z, gz, ga, gb,
                                  L, M, D, R, tm, n_tiles, n_slots, s);
  return run_bwd<float>(x, g, a_pool, b_pool, pool_bf16, row_src, tile_slot, z, gz, ga, gb,
                        L, M, D, R, tm, n_tiles, n_slots, s);
}
