// Grouped skip-LoRA forward over int8 *activations* (K8), for Hopper
// (sm_90a). Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_grouped_fwd_actint8.
//
// K5 with x[l, m] = bf16(q[l, m] * s[l, m]), on K5's tensor-core passes
// (skip_sum_tc.cuh) with the int8 row loader `stc::Int8Rows`: each chunk of
// the int8 activation cache is copied as it is into shared memory, the
// block's row scales are staged once a layer, and each A fragment element is
// built as bf16(float(q) s) on its way to the tensor cores, so the cache
// crosses device memory once, as int8, and never as bf16. As in the
// reference, x, the float pool's A and B, and z are bf16, the sums fp32, and
// the output is bf16 whatever the pool's type (kernel.py, grouped_fwd_route:
// always the tensor cores).
//
// Bandwidth-bound: per call it must read q (L M D bytes) and s (4 L M),
// each active slot's A and B blocks (2 L D R elements), and write out
// (2 M D bytes): 67.2 MB, 20.1 us at 3.35 TB/s, at the fleet step's shape
// (L 24, M 1024 in 4 slots, D 2048, R 8, fp32 pools). `few` picks the
// few-row geometry (kernel.py, grouped_fwd_geometry).
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "grouped_skip_sum.cuh"
#include "skip_sum_tc.cuh"

extern "C" int grouped_skip_sum_fwd_actint8(
    const int8_t* q,          // (L, M, D)
    const float* s,           // (L, M)
    const void* a_pool,       // (N, L, D, R) fp32 or bf16
    const void* b_pool,       // (N, L, R, D), same type as a_pool
    const int* row_src,       // (n_tiles * tm,) original row or -1
    const int* tile_slot,     // (n_tiles,) slot of each row tile, non-decreasing
    void* z,                  // (n_tiles * tm, L RP) bf16 scratch
    void* out,                // (M, D) bf16
    int L, int M, int D, int R, int tm, int n_tiles,
    int pool_bf16, int few, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (gss::bad_geometry(L, D, R, tm, n_tiles)) return (int)cudaErrorInvalidValue;
  const stc::Int8Rows rows{q, s};
  bf* zt = static_cast<bf*>(z);
  bf* ot = static_cast<bf*>(out);
  return stc::by_rank(R, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    if (pool_bf16)
      return stc::grouped_forward<NT>(rows, stc::FloatPool<bf>{(const bf*)a_pool, (const bf*)b_pool}, row_src,
                                      tile_slot, zt, ot, L, M, D, R, tm, n_tiles, few, st);
    return stc::grouped_forward<NT>(rows, stc::FloatPool<float>{(const float*)a_pool, (const float*)b_pool}, row_src,
                                    tile_slot, zt, ot, L, M, D, R, tm, n_tiles, few, st);
  });
}
