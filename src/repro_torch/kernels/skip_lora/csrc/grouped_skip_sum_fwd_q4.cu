// Grouped skip-LoRA forward over a packed 4-bit adapter pool (K7), for
// Hopper (sm_90a). Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_grouped_fwd_q4.
//
// K5 with each gathered pool element dequantised in registers as
// code[nibble] * rowwise scale (fp32), then cast to the activation type, as
// the reference does. The payload stays packed in device memory: two 4-bit
// codebook indices a byte along the last axis, even index in the low nibble,
// so A (N, L, D, R/2) is packed along R and B (N, L, R, D/2) along D; the two
// gathers unpack along different axes. The 16-entry codebook (int4 or nf4
// levels) is staged in shared memory. A slot whose scales are 0 dequantises
// to exact zeros, so a base-model row through the pinned zero slot stays
// bitwise base-model.
//
// Bandwidth-bound: per call it must move x (L M D elements), each active
// slot's payload (L D R bytes) and scales (4 L (D + R) bytes), and out
// (M D). See grouped_skip_sum.cuh for the two-pass design.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "grouped_skip_sum.cuh"

extern "C" int grouped_skip_sum_fwd_q4(
    const void* x,            // (L, M, D) fp32 or bf16
    const uint8_t* qa,        // (N, L, D, R / 2) packed nibbles
    const float* sa,          // (N, L, D)
    const uint8_t* qb,        // (N, L, R, D / 2) packed nibbles
    const float* sb,          // (N, L, R)
    const float* code,        // (16,) codebook
    const int* row_src,       // (n_tiles * tm,) original row or -1
    const int* tile_slot,     // (n_tiles,) slot of each row tile
    float* z,                 // (L, n_tiles * tm, R) scratch
    void* out,                // (M, D), type of x
    int L, int M, int D, int R, int tm, int n_tiles,
    int x_bf16, void* stream) {
  if ((R & 1) || (D & 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const gss::Q4Pool pool{qa, sa, qb, sb, code, nullptr};
  if (x_bf16) {
    const gss::DenseActs<__nv_bfloat16> acts{(const __nv_bfloat16*)x, (size_t)M * D, D};
    return gss::run<__nv_bfloat16>(acts, pool, row_src, tile_slot, z, out, L, D, R, tm, n_tiles, s);
  }
  const gss::DenseActs<float> acts{(const float*)x, (size_t)M * D, D};
  return gss::run<float>(acts, pool, row_src, tile_slot, z, out, L, D, R, tm, n_tiles, s);
}
