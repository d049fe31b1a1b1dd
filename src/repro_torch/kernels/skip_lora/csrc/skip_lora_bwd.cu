// Adapter gradients of the skip-LoRA sum (K2), for Hopper (sm_90a).
// Replaces the TPU kernel src/repro/kernels/skip_lora/kernel.py::skip_lora_bwd.
//
//   gA[l] = x[l]^T cast_x(g cast_x(B[l])^T),   gB[l] = cast_x(x[l] cast_x(A[l]))^T g
//
// fp32, summed over all M rows. No gradient for x: the cached activations
// are constants. Bandwidth-bound: x (L M D) and g (M D) are read, gA and gB
// (2 L D R fp32) written. The sum over M is split in 256-row chunks whose
// fp32 partials a last pass adds in chunk order, so the result is the same
// on every run (no atomics). See skip_sum.cuh.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "skip_sum.cuh"

template <typename T>
static int run(const void* x, const void* a, const void* b, const void* g, float* z, float* gz,
               float* pa, float* pb, float* ga, float* gb, int L, int M, int D, int R, int w_bf16,
               cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  if (w_bf16)
    return ssk::backward<T>(xt, (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, gt, z, gz, pa, pb,
                            ga, gb, L, M, D, R, s);
  return ssk::backward<T>(xt, (const float*)a, (const float*)b, gt, z, gz, pa, pb, ga, gb, L, M, D,
                          R, s);
}

extern "C" int skip_lora_bwd(
    const void* x,      // (L, M, D) fp32 or bf16
    const void* a,      // (L, D, R) fp32 or bf16
    const void* b,      // (L, R, D), same type as a
    const void* g,      // (M, D), type of x
    float* z,           // (L, M, R) scratch
    float* gz,          // (L, M, R) scratch
    float* pa,          // (chunks, L, D, R) scratch, null when chunks == 1
    float* pb,          // (chunks, L, R, D) scratch, null when chunks == 1
    float* ga,          // (L, D, R) fp32
    float* gb,          // (L, R, D) fp32
    int L, int M, int D, int R, int x_bf16, int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return run<__nv_bfloat16>(x, a, b, g, z, gz, pa, pb, ga, gb, L, M, D, R, w_bf16, s);
  return run<float>(x, a, b, g, z, gz, pa, pb, ga, gb, L, M, D, R, w_bf16, s);
}
