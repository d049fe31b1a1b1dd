// Grouped skip-LoRA forward over an int8 adapter pool, for Hopper (sm_90a).
// Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_grouped_fwd_int8.
//
// The pool stays int8 in device memory; each gathered element is
// dequantised in registers as (q * rowwise scale) in fp32, then cast to the
// activation type, as the reference does. Bandwidth-bound: per call it must
// move x (L M D elements), each active slot's payload (2 L D R bytes) and
// scales (4 L (D + R) bytes), and out (M D). See grouped_skip_sum.cuh for the
// two-phase design.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "grouped_skip_sum.cuh"

extern "C" int grouped_skip_sum_fwd_int8(
    const void* x,            // (L, M, D) fp32 or bf16
    const int8_t* qa,         // (N, L, D, R)
    const float* sa,          // (N, L, D)
    const int8_t* qb,         // (N, L, R, D)
    const float* sb,          // (N, L, R)
    const int* row_src,       // (n_tiles * tm,) original row or -1
    const int* tile_slot,     // (n_tiles,) slot of each row tile
    float* z,                 // (L, n_tiles * tm, R) scratch
    void* out,                // (M, D), type of x
    int L, int M, int D, int R, int tm, int n_tiles,
    int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const gss::Int8Pool pool{qa, sa, qb, sb};
  if (x_bf16) {
    const gss::DenseActs<__nv_bfloat16> acts{(const __nv_bfloat16*)x, (size_t)M * D, D};
    return gss::run<__nv_bfloat16>(acts, pool, row_src, tile_slot, z, out, L, D, R, tm, n_tiles, s);
  }
  const gss::DenseActs<float> acts{(const float*)x, (size_t)M * D, D};
  return gss::run<float>(acts, pool, row_src, tile_slot, z, out, L, D, R, tm, n_tiles, s);
}
