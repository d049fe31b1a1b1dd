// Grouped skip-LoRA forward over int8 *activations* (K8), for Hopper
// (sm_90a). Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_grouped_fwd_actint8.
//
// K5 with x[l, m] = bf16(q[l, m] * s[l, m]): the int8 activation cache and
// its fp32 per-row scales are dequantised in registers as the rows are
// read (each tile's row scales staged once in shared memory), so the cache
// never goes through device memory as bf16. As in the reference, x, the
// float pool's A and B, and z are bf16, the sums fp32, and the output is
// bf16 whatever the pool's type.
//
// Bandwidth-bound: per call it must read q (L M D bytes) and s (4 L M),
// each active slot's A and B blocks (2 L D R elements), and write out
// (2 M D bytes). See grouped_skip_sum.cuh for the two-pass design.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "grouped_skip_sum.cuh"

extern "C" int grouped_skip_sum_fwd_actint8(
    const int8_t* q,          // (L, M, D)
    const float* s,           // (L, M)
    const void* a_pool,       // (N, L, D, R) fp32 or bf16
    const void* b_pool,       // (N, L, R, D), same type as a_pool
    const int* row_src,       // (n_tiles * tm,) original row or -1
    const int* tile_slot,     // (n_tiles,) slot of each row tile
    float* z,                 // (L, n_tiles * tm, R) scratch
    void* out,                // (M, D) bf16
    int L, int M, int D, int R, int tm, int n_tiles,
    int pool_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const gss::Int8Acts acts{q, s, M, D};
  if (pool_bf16)
    return gss::run<bf>(acts, gss::FloatPool<bf>{(const bf*)a_pool, (const bf*)b_pool}, row_src,
                        tile_slot, z, out, L, D, R, tm, n_tiles, st);
  return gss::run<bf>(acts, gss::FloatPool<float>{(const float*)a_pool, (const float*)b_pool}, row_src,
                      tile_slot, z, out, L, D, R, tm, n_tiles, st);
}
