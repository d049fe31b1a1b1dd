// Conversions shared by the port's CUDA kernels: fp32 <-> the activation
// type (fp32 or bf16), and the round trip that stands for the reference's
// `.astype(x.dtype)` between two fp32-accumulated products.

#pragma once

#include <cuda_bf16.h>

namespace rtk {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round to the activation type and back: the reference's `.astype(x.dtype)`.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

}  // namespace rtk
