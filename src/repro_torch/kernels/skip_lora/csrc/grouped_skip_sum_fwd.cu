// Grouped skip-LoRA forward over a float adapter pool (fp32 or bf16), for
// Hopper (sm_90a). Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_grouped_fwd.
//
// Bandwidth-bound: per call it must move x (L M D elements), each active
// slot's A and B blocks (2 L D R elements) and out (M D). At the serve
// shapes the adapter blocks dominate. See grouped_skip_sum.cuh for the
// two-phase design.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "grouped_skip_sum.cuh"

extern "C" int grouped_skip_sum_fwd(
    const void* x,            // (L, M, D) fp32 or bf16
    const void* a_pool,       // (N, L, D, R) fp32 or bf16
    const void* b_pool,       // (N, L, R, D), same type as a_pool
    const int* row_src,       // (n_tiles * tm,) original row or -1
    const int* tile_slot,     // (n_tiles,) slot of each row tile
    float* z,                 // (L, n_tiles * tm, R) scratch
    void* out,                // (M, D), type of x
    int L, int M, int D, int R, int tm, int n_tiles,
    int x_bf16, int pool_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (pool_bf16)
      return gss::run<__nv_bfloat16>(x, gss::FloatPool<__nv_bfloat16>{(const __nv_bfloat16*)a_pool, (const __nv_bfloat16*)b_pool},
                                     row_src, tile_slot, z, out, L, M, D, R, tm, n_tiles, s);
    return gss::run<__nv_bfloat16>(x, gss::FloatPool<float>{(const float*)a_pool, (const float*)b_pool},
                                   row_src, tile_slot, z, out, L, M, D, R, tm, n_tiles, s);
  }
  if (pool_bf16)
    return gss::run<float>(x, gss::FloatPool<__nv_bfloat16>{(const __nv_bfloat16*)a_pool, (const __nv_bfloat16*)b_pool},
                           row_src, tile_slot, z, out, L, M, D, R, tm, n_tiles, s);
  return gss::run<float>(x, gss::FloatPool<float>{(const float*)a_pool, (const float*)b_pool},
                         row_src, tile_slot, z, out, L, M, D, R, tm, n_tiles, s);
}
