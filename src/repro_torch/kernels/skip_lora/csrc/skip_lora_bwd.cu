// Adapter gradients of the skip-LoRA sum (K2), for Hopper (sm_90a).
// Replaces the TPU kernel src/repro/kernels/skip_lora/kernel.py::skip_lora_bwd.
//
//   gA[l] = x[l]^T cast_x(g cast_x(B[l])^T),   gB[l] = cast_x(x[l] cast_x(A[l]))^T g
//
// fp32, summed over all M rows. No gradient for x: the cached activations
// are constants. Bandwidth-bound: x (L M D) and g (M D) are read, gA and gB
// (2 L D R fp32) written; at the cached step (L 24, M 1024, D 2048, R 8,
// bf16 rows, fp32 adapters) 111.1 MB, 33.2 us at 3.35 TB/s. The sum over M
// is split in chunks of BWD_CHUNK rows (kernel.py) whose fp32 partials a
// last pass adds in chunk order, so the result is the same on every run (no
// atomics); at M <= one chunk the outer pass writes gA and gB directly.
//
// bf16 rows, on the tensor cores (skip_sum_tc.cuh), K9's passes with one
// slot: project_tc forms z = bf16(x[l] bf16(A[l])) and gz = bf16(g
// bf16(B[l])^T) per (32 rows, layer), x read once and g once a layer from
// L2; outer_tc forms gA = x^T gz and gB^T = g^T z per (M chunk, 4 layers,
// 128 columns), 4 chunks at M 1024 so the grid (384 blocks) covers the 132
// SMs; then ssk::reduce_chunks. So x is read twice: this design's floor is
// ~60 us.
// fp32 rows stay on CUDA cores (skip_sum.cuh): the tensor cores' fp32 input
// is TF32, which would break the float32 cases' 1e-5 bar.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "skip_sum.cuh"
#include "skip_sum_tc.cuh"

extern "C" int skip_lora_bwd(
    const void* x,      // (L, M, D) fp32 or bf16
    const void* a,      // (L, D, R) fp32 or bf16
    const void* b,      // (L, R, D), same type as a
    const void* g,      // (M, D), type of x
    void* z,            // scratch: (L, M, R) fp32 for fp32 x, (L, M, RP) bf16 for bf16 x
    void* gz,           //   (kernel.py, bwd_scratch_rank)
    float* pa,          // (chunks, L, D, R) scratch, null when chunks == 1
    float* pb,          // (chunks, L, R, D) scratch, null when chunks == 1
    float* ga,          // (L, D, R) fp32
    float* gb,          // (L, R, D) fp32
    int L, int M, int D, int R, int chunk, int x_bf16, int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || M < 1 || D < 1 || R < 1 || R > ssk::R_MAX || chunk < 1) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (!x_bf16) {
    const float* xf = static_cast<const float*>(x);
    const float* gf = static_cast<const float*>(g);
    float *zf = static_cast<float*>(z), *gzf = static_cast<float*>(gz);
    if (w_bf16)
      return ssk::backward(xf, (const bf*)a, (const bf*)b, gf, zf, gzf, pa, pb, ga, gb, L, M, D, R, chunk, s);
    return ssk::backward(xf, (const float*)a, (const float*)b, gf, zf, gzf, pa, pb, ga, gb, L, M, D, R, chunk, s);
  }
  const int chunks = (M + chunk - 1) / chunk;
  float* oa = chunks == 1 ? ga : pa;
  float* ob = chunks == 1 ? gb : pb;
  const int err = stc::by_rank(R, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    if (w_bf16)
      return stc::backward<bf, NT>((const bf*)x, (const bf*)g, (const bf*)a, (const bf*)b, nullptr, nullptr, (bf*)z,
                                   (bf*)gz, oa, ob, L, M, D, R, 1, M, chunks, chunk, s);
    return stc::backward<float, NT>((const bf*)x, (const bf*)g, (const float*)a, (const float*)b, nullptr, nullptr,
                                    (bf*)z, (bf*)gz, oa, ob, L, M, D, R, 1, M, chunks, chunk, s);
  });
  if (err != cudaSuccess || chunks == 1) return err;
  return (int)ssk::launch_reduce(pa, pb, ga, gb, (size_t)L * D * R, chunks, s);
}
