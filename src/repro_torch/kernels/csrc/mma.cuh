// Tensor-core and asynchronous-copy building blocks shared by the port's
// bf16 kernels (K4 flash_attn_fwd; K2, K3, K5, K6, K7, K8 and K9 through
// skip_lora/csrc/skip_sum_tc.cuh), as inline PTX for sm_80 and later: 16- and
// 4-byte `cp.async` copies into shared memory (with zero fill), `ldmatrix`
// (plain and transposed) and the `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`
// product.
//
// Fragment layout of m16n8k16 for lane = 4 * grp + tig (grp 0..7, tig 0..3):
//   A (16 x 16, row-major):  a0 (grp,     2 tig..+1)  a1 (grp + 8, 2 tig..+1)
//                            a2 (grp, 2 tig + 8..+9)  a3 (grp + 8, 2 tig + 8..+9)
//   B (16 x 8, k by n):      b0 (k 2 tig..+1, n grp)  b1 (k 2 tig + 8..+9, n grp)
//   C (16 x 8, fp32):        c0, c1 (grp, 2 tig..+1)  c2, c3 (grp + 8, 2 tig..+1)
// Each a/b register holds two bf16, the lower column (or k) in the low half.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; only the first `src_bytes` (0..16) are
// read, the rest of the 16 are zero-filled. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
// 4 bytes from global to shared, through L1 (cp.async takes 16-byte copies
// only through L2); the same zero fill.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane i gives the address of one 16-byte row of
// matrix i / 8. Register j holds this lane's part of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// Two matrices from the addresses of lanes 0..15 (the others are ignored).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b, bf16 inputs, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (nearest even) in one register, `lo` in
// the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tc
