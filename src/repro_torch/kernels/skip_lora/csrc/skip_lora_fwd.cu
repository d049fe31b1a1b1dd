// Skip-LoRA forward over all layers (K1), for Hopper (sm_90a). Replaces
// the TPU kernel src/repro/kernels/skip_lora/kernel.py::skip_lora_fwd.
//
//   out[m] = sum_l cast_x(x[l, m] @ cast_x(A[l])) @ cast_x(B[l])
//
// Two routes, by the rows' type:
//   bf16 rows: the one-slot form of K5 on the tensor-core passes of
//     skip_sum_tc.cuh, as K3 is K8's: the rows through `stc::Bf16Rows`, the
//     adapters as a pool of one slot (`stc::FloatPool<P>` over a (L, D, R)
//     and b (L, R, D) as they are), null `row_src` and `tile_slot`
//     (position p is row p, every position slot 0), row tiles of one row.
//     z = bf16(x bf16(A)) goes through an (M, L RP) bf16 scratch,
//     k = l RP + r, and expand_tc sums over k in one fp32 accumulation in
//     order, where the plain version adds each layer's product into an fp32
//     output: the two round at most one bf16 ulp apart.
//   fp32 rows: the CUDA-core passes of skip_sum.cuh, z an (L, M, R) fp32
//     scratch; the tensor cores' fp32 input is TF32, which would break the
//     float32 cases' 1e-5 bar.
//
// Bandwidth-bound: x (L M D elements) read once, a and b (2 L D R) once,
// out (M D) written once. At the cached step (L 24, M 1024, D 2048, R 8,
// bf16 rows, fp32 adapters) that is 108.0 MB, 32.2 us at 3.35 TB/s, against
// 1.6 GFLOP, under 2 us on the bf16 tensor cores. `few` comes from
// kernel.py's grouped_fwd_geometry(M, M): the many-row geometry, 32 x 24
// project blocks and 16 x 16 expand blocks at the cached step, as K3's.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "skip_sum.cuh"
#include "skip_sum_tc.cuh"

extern "C" int skip_lora_fwd(
    const void* x,      // (L, M, D) fp32 or bf16
    const void* a,      // (L, D, R) fp32 or bf16
    const void* b,      // (L, R, D), same type as a
    void* z,            // scratch: bf16 x (M, L RP) bf16, fp32 x (L, M, R) fp32 (kernel.py, _grouped_scratch)
    void* out,          // (M, D), type of x
    int L, int M, int D, int R, int x_bf16, int w_bf16,
    int few,            // few-row geometry (bf16 rows)
    void* stream) {
  if (L < 1 || M < 1 || D < 1 || R < 1 || R > stc::R_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (!x_bf16) {
    const float* xf = static_cast<const float*>(x);
    float* zf = static_cast<float*>(z);
    float* of = static_cast<float*>(out);
    if (w_bf16) return ssk::forward(xf, (const bf*)a, (const bf*)b, zf, of, L, M, D, R, s);
    return ssk::forward(xf, (const float*)a, (const float*)b, zf, of, L, M, D, R, s);
  }
  const stc::Bf16Rows rows{static_cast<const bf*>(x)};
  bf* zt = static_cast<bf*>(z);
  bf* ot = static_cast<bf*>(out);
  return stc::by_rank(R, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    if (w_bf16)
      return stc::grouped_forward<NT>(rows, stc::FloatPool<bf>{(const bf*)a, (const bf*)b}, nullptr, nullptr, zt,
                                      ot, L, M, D, R, 1, M, few, s);
    return stc::grouped_forward<NT>(rows, stc::FloatPool<float>{(const float*)a, (const float*)b}, nullptr, nullptr,
                                    zt, ot, L, M, D, R, 1, M, few, s);
  });
}
