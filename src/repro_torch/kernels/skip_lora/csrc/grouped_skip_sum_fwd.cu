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
  using bf = __nv_bfloat16;
  const gss::FloatPool<bf> pb{(const bf*)a_pool, (const bf*)b_pool};
  const gss::FloatPool<float> pf{(const float*)a_pool, (const float*)b_pool};
  if (x_bf16) {
    const gss::DenseActs<bf> acts{(const bf*)x, (size_t)M * D, D};
    if (pool_bf16) return gss::run<bf>(acts, pb, row_src, tile_slot, z, out, L, D, R, tm, n_tiles, s);
    return gss::run<bf>(acts, pf, row_src, tile_slot, z, out, L, D, R, tm, n_tiles, s);
  }
  const gss::DenseActs<float> acts{(const float*)x, (size_t)M * D, D};
  if (pool_bf16) return gss::run<float>(acts, pb, row_src, tile_slot, z, out, L, D, R, tm, n_tiles, s);
  return gss::run<float>(acts, pf, row_src, tile_slot, z, out, L, D, R, tm, n_tiles, s);
}
