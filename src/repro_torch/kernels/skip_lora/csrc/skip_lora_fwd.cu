// Skip-LoRA forward over all layers (K1), for Hopper (sm_90a). Replaces
// the TPU kernel src/repro/kernels/skip_lora/kernel.py::skip_lora_fwd.
//
//   out[m] = sum_l cast_x(x[l, m] @ cast_x(A[l])) @ cast_x(B[l])
//
// Bandwidth-bound: x (L M D elements) is read once, out (M D) written once;
// the adapters (2 L D R) are small. See skip_sum.cuh for the two passes.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "skip_sum.cuh"

template <typename T>
static int run(const void* x, const void* a, const void* b, float* z, void* out, int L, int M,
               int D, int R, int w_bf16, cudaStream_t s) {
  const ssk::DenseRows<T> rows{static_cast<const T*>(x), (size_t)M * D, D};
  T* o = static_cast<T*>(out);
  if (w_bf16)
    return ssk::forward<T>(rows, (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, z, o, L, M, D, R, s);
  return ssk::forward<T>(rows, (const float*)a, (const float*)b, z, o, L, M, D, R, s);
}

extern "C" int skip_lora_fwd(
    const void* x,      // (L, M, D) fp32 or bf16
    const void* a,      // (L, D, R) fp32 or bf16
    const void* b,      // (L, R, D), same type as a
    float* z,           // (L, M, R) scratch
    void* out,          // (M, D), type of x
    int L, int M, int D, int R, int x_bf16, int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return run<__nv_bfloat16>(x, a, b, z, out, L, M, D, R, w_bf16, s);
  return run<float>(x, a, b, z, out, L, M, D, R, w_bf16, s);
}
