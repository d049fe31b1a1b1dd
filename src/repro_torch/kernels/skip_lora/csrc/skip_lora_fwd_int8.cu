// Skip-LoRA forward over an int8 activation cache (K3), for Hopper
// (sm_90a). Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_fwd_int8.
//
// K1 with x[l, m] = bf16(q[l, m] * s[l, m]): a and b cast to bf16,
// z = bf16(x a), fp32 sums, bf16 output, as the reference computes it
// (kernel.py, _fwd_int8_kernel). It is the one-slot form of K8 on the
// tensor-core passes of skip_sum_tc.cuh: the rows through `stc::Int8Rows`
// (int8 tiles copied as they are into shared memory, the block's row scales
// staged once, each A fragment element built as bf16(float(q) s), so the
// cache crosses device memory once, as int8), the adapters as a pool of one
// slot (`stc::FloatPool<P>` over a (L, D, R) and b (L, R, D) as they are),
// null `row_src` and `tile_slot` (position p is row p, every position slot
// 0), row tiles of one row. z goes through an (M, L RP) bf16 scratch,
// k = l RP + r, and expand_tc sums over k in one fp32 accumulation in order,
// where the plain version adds each layer's product into an fp32 output: the
// two round at most one bf16 ulp apart.
//
// Bandwidth-bound: q (L M D bytes) and s (4 L M) read once, a and b (2 L D R
// elements) once, out (2 M D bytes) written once: 57.7 MB, 17.2 us at
// 3.35 TB/s at the cached step (L 24, M 1024, D 2048, R 8, fp32 adapters),
// against 1.6 GFLOP, under 2 us on the bf16 tensor cores. `few` comes from
// kernel.py's grouped_fwd_geometry(M, M): the many-row geometry, 32 x 24
// project blocks and 16 x 16 expand blocks at the cached step, as K8's.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "skip_sum_tc.cuh"

extern "C" int skip_lora_fwd_int8(
    const int8_t* q,    // (L, M, D)
    const float* s,     // (L, M)
    const void* a,      // (L, D, R) fp32 or bf16
    const void* b,      // (L, R, D), same type as a
    void* z,            // (M, L RP) bf16 scratch
    void* out,          // (M, D) bf16
    int L, int M, int D, int R, int w_bf16, int few, void* stream) {
  if (L < 1 || M < 1 || D < 1 || R < 1 || R > stc::R_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const stc::Int8Rows rows{q, s};
  bf* zt = static_cast<bf*>(z);
  bf* ot = static_cast<bf*>(out);
  return stc::by_rank(R, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    if (w_bf16)
      return stc::grouped_forward<NT>(rows, stc::FloatPool<bf>{(const bf*)a, (const bf*)b}, nullptr, nullptr, zt,
                                      ot, L, M, D, R, 1, M, few, st);
    return stc::grouped_forward<NT>(rows, stc::FloatPool<float>{(const float*)a, (const float*)b}, nullptr, nullptr,
                                    zt, ot, L, M, D, R, 1, M, few, st);
  });
}
