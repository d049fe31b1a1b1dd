// Grouped skip-LoRA forward over an int8 adapter pool (K6), for Hopper
// (sm_90a). Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_grouped_fwd_int8.
//
// K5 with each pool element dequantised as (q * rowwise scale) in fp32, then
// cast to the activation type, as the reference does. The pool stays int8
// in device memory: QA (N, L, D, R) and QB (N, L, R, D) with fp32 scales
// over the last axis, SA (N, L, D) and SB (N, L, R). A slot whose scales are
// 0 dequantises to exact zeros.
//
// Two routes, by the rows' type (kernel.py, grouped_fwd_route):
//   bf16 rows: K5's tensor-core passes (skip_sum_tc.cuh) with the pool
//     policy `stc::Int8Pool`: the int8 A slabs and B rows and their scales
//     are copied as they are into shared memory and each element is
//     dequantised where it becomes an mma fragment, as bf16(float(q) scale).
//     `few` picks the few-row geometry (kernel.py, grouped_fwd_geometry),
//     which every launch of serving takes (one row a slot).
//   fp32 rows: the CUDA-core passes of grouped_skip_sum.cuh (`gss::Int8Pool`);
//     the tensor cores' fp32 input is TF32, which would break the float32
//     cases' 1e-5 bar.
//
// Bandwidth-bound: per call it must move x (L M D elements), each active
// slot's payload (2 L D R bytes) and scales (4 L (D + R) bytes), and out
// (M D): 1.30 us at 3.35 TB/s at the serve shape (L 24, M 4 in 4 slots,
// D 2048, R 8, bf16 rows).
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "grouped_skip_sum.cuh"
#include "skip_sum_tc.cuh"

extern "C" int grouped_skip_sum_fwd_int8(
    const void* x,            // (L, M, D) fp32 or bf16
    const int8_t* qa,         // (N, L, D, R)
    const float* sa,          // (N, L, D)
    const int8_t* qb,         // (N, L, R, D)
    const float* sb,          // (N, L, R)
    const int* row_src,       // (n_tiles * tm,) original row or -1
    const int* tile_slot,     // (n_tiles,) slot of each row tile, non-decreasing
    void* z,                  // scratch: bf16 x (n_tiles * tm, L RP) bf16, fp32 x (L, n_tiles * tm, R) fp32
    void* out,                // (M, D), type of x
    int L, int M, int D, int R, int tm, int n_tiles,
    int x_bf16, int few, void* stream) {
  if (gss::bad_geometry(L, D, R, tm, n_tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16) {
    const stc::Int8Pool pool{qa, sa, qb, sb};
    const stc::Bf16Rows rows{static_cast<const bf*>(x)};
    return stc::by_rank(R, [&](auto nt) {
      return stc::grouped_forward<decltype(nt)::value>(rows, pool, row_src, tile_slot, static_cast<bf*>(z),
                                                       static_cast<bf*>(out), L, M, D, R, tm, n_tiles, few, s);
    });
  }
  const gss::Int8Pool pool{qa, sa, qb, sb};
  const gss::DenseActs<float> acts{(const float*)x, (size_t)M * D, D};
  return gss::run<float>(acts, pool, row_src, tile_slot, static_cast<float*>(z), out, L, D, R, tm, n_tiles, s);
}
