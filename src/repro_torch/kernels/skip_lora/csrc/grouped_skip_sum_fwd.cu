// Grouped skip-LoRA forward over a float adapter pool (fp32 or bf16), for
// Hopper (sm_90a). Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_grouped_fwd.
//
// Bandwidth-bound: per call it must move x (L M D elements), each active
// slot's A and B blocks (2 L D R elements) and out (M D). At the serve
// shapes (a few rows) the adapter blocks dominate; at the fleet step's
// (M 1024 in 4 slots, L 24, D 2048, R 8, bf16 rows, fp32 pools: 117.4 MB,
// 35.1 us at 3.35 TB/s) x does.
//
// Two routes, by the rows' type (kernel.py, grouped_fwd_route):
//   bf16 rows: the tensor-core passes of skip_sum_tc.cuh. project_tc forms
//     z = bf16(x bf16(A)) with x read exactly once and each slab shared by
//     the block's rows, into a (M_pad, L RP) bf16 scratch whose row is one
//     grouped position and whose k = l RP + r; expand_tc forms
//     out = bf16(z bf16(B)) with the slot's B stack staged 32 k at a time,
//     and writes each row back to its original position. `few` picks the
//     few-row geometry (kernel.py, grouped_fwd_geometry; the same bits).
//   fp32 rows: the CUDA-core passes of grouped_skip_sum.cuh; the tensor
//     cores' fp32 input is TF32, which would break the float32 cases' 1e-5
//     bar.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "grouped_skip_sum.cuh"
#include "skip_sum_tc.cuh"

extern "C" int grouped_skip_sum_fwd(
    const void* x,            // (L, M, D) fp32 or bf16
    const void* a_pool,       // (N, L, D, R) fp32 or bf16
    const void* b_pool,       // (N, L, R, D), same type as a_pool
    const int* row_src,       // (n_tiles * tm,) original row or -1
    const int* tile_slot,     // (n_tiles,) slot of each row tile, non-decreasing
    void* z,                  // scratch: bf16 x (n_tiles * tm, L RP) bf16, fp32 x (L, n_tiles * tm, R) fp32
    void* out,                // (M, D), type of x
    int L, int M, int D, int R, int tm, int n_tiles,
    int x_bf16, int pool_bf16,
    int few,                  // few-row geometry (bf16 rows)
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (gss::bad_geometry(L, D, R, tm, n_tiles)) return (int)cudaErrorInvalidValue;
  if (x_bf16) {
    const bf* xt = static_cast<const bf*>(x);
    bf* zt = static_cast<bf*>(z);
    bf* ot = static_cast<bf*>(out);
    return stc::by_rank(R, [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      if (pool_bf16)
        return stc::grouped_forward<NT>(stc::Bf16Rows{xt}, stc::FloatPool<bf>{(const bf*)a_pool, (const bf*)b_pool},
                                        row_src, tile_slot, zt, ot, L, M, D, R, tm, n_tiles, few, s);
      return stc::grouped_forward<NT>(stc::Bf16Rows{xt},
                                      stc::FloatPool<float>{(const float*)a_pool, (const float*)b_pool}, row_src,
                                      tile_slot, zt, ot, L, M, D, R, tm, n_tiles, few, s);
    });
  }
  float* zf = static_cast<float*>(z);
  const gss::DenseActs<float> acts{(const float*)x, (size_t)M * D, D};
  if (pool_bf16)
    return gss::run<float>(acts, gss::FloatPool<bf>{(const bf*)a_pool, (const bf*)b_pool}, row_src, tile_slot, zf,
                           out, L, D, R, tm, n_tiles, s);
  return gss::run<float>(acts, gss::FloatPool<float>{(const float*)a_pool, (const float*)b_pool}, row_src,
                         tile_slot, zf, out, L, D, R, tm, n_tiles, s);
}
