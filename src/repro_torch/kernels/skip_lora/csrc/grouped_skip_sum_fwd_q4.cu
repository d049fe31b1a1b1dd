// Grouped skip-LoRA forward over a packed 4-bit adapter pool (K7), for
// Hopper (sm_90a). Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_grouped_fwd_q4.
//
// K5 with each pool element dequantised as code[nibble] * rowwise scale
// (fp32), then cast to the activation type, as the reference does. The
// payload stays packed in device memory: two 4-bit codebook indices a byte
// along the last axis, even index in the low nibble, so A (N, L, D, R/2) is
// packed along R and B (N, L, R, D/2) along D. The 16-entry codebook (int4
// or nf4 levels) is staged in shared memory. A slot whose scales are 0
// dequantises to exact zeros, so a base-model row through the pinned zero
// slot stays bitwise base-model.
//
// Two routes, by the rows' type (kernel.py, grouped_fwd_route):
//   bf16 rows: K5's tensor-core passes (skip_sum_tc.cuh) with the pool
//     policy `stc::Q4Pool`: the packed A slabs and B rows and their scales
//     are copied as they are into shared memory and each element is
//     dequantised where it becomes an mma fragment, as bf16(code[nibble]
//     scale). `few` picks the few-row geometry (kernel.py,
//     grouped_fwd_geometry), which the decode steps of serving take.
//   fp32 rows: the CUDA-core passes of grouped_skip_sum.cuh (`gss::Q4Pool`);
//     the tensor cores' fp32 input is TF32, which would break the float32
//     cases' 1e-5 bar.
//
// Bandwidth-bound: per call it must move x (L M D elements), each active
// slot's payload (L D R bytes) and scales (4 L (D + R) bytes), and out
// (M D).
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "grouped_skip_sum.cuh"
#include "skip_sum_tc.cuh"

extern "C" int grouped_skip_sum_fwd_q4(
    const void* x,            // (L, M, D) fp32 or bf16
    const uint8_t* qa,        // (N, L, D, R / 2) packed nibbles
    const float* sa,          // (N, L, D)
    const uint8_t* qb,        // (N, L, R, D / 2) packed nibbles
    const float* sb,          // (N, L, R)
    const float* code,        // (16,) codebook
    const int* row_src,       // (n_tiles * tm,) original row or -1
    const int* tile_slot,     // (n_tiles,) slot of each row tile, non-decreasing
    void* z,                  // scratch: bf16 x (n_tiles * tm, L RP) bf16, fp32 x (L, n_tiles * tm, R) fp32
    void* out,                // (M, D), type of x
    int L, int M, int D, int R, int tm, int n_tiles,
    int x_bf16, int few, void* stream) {
  if ((R & 1) || (D & 1)) return (int)cudaErrorInvalidValue;
  if (gss::bad_geometry(L, D, R, tm, n_tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16) {
    const stc::Q4Pool pool{qa, sa, qb, sb, code};
    const stc::Bf16Rows rows{static_cast<const bf*>(x)};
    return stc::by_rank(R, [&](auto nt) {
      return stc::grouped_forward<decltype(nt)::value>(rows, pool, row_src, tile_slot, static_cast<bf*>(z),
                                                       static_cast<bf*>(out), L, M, D, R, tm, n_tiles, few, s);
    });
  }
  const gss::Q4Pool pool{qa, sa, qb, sb, code, nullptr};
  const gss::DenseActs<float> acts{(const float*)x, (size_t)M * D, D};
  return gss::run<float>(acts, pool, row_src, tile_slot, static_cast<float*>(z), out, L, D, R, tm, n_tiles, s);
}
