// Skip-LoRA forward over an int8 activation cache (K3), for Hopper
// (sm_90a). Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_fwd_int8.
//
// K1 with x[l, m] = bf16(q[l, m] * s[l, m]): the int8 payload and its fp32
// per-row scale are dequantised in registers as the rows are staged, so the
// cache never goes through device memory as bf16. The output is bf16.
// Bandwidth-bound: q (L M D bytes) and s (4 L M) are read once, out (2 M D)
// written once. See skip_sum.cuh for the two passes.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "skip_sum.cuh"

extern "C" int skip_lora_fwd_int8(
    const int8_t* q,    // (L, M, D)
    const float* s,     // (L, M)
    const void* a,      // (L, D, R) fp32 or bf16
    const void* b,      // (L, R, D), same type as a
    float* z,           // (L, M, R) scratch
    void* out,          // (M, D) bf16
    int L, int M, int D, int R, int w_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ssk::Int8Rows rows{q, s, M, D};
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (w_bf16)
    return ssk::forward<__nv_bfloat16>(rows, (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, z, o,
                                       L, M, D, R, st);
  return ssk::forward<__nv_bfloat16>(rows, (const float*)a, (const float*)b, z, o, L, M, D, R, st);
}
