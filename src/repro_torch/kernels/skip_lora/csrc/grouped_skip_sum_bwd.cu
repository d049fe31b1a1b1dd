// Per-slot adapter gradients of the grouped skip-LoRA sum (K9), for Hopper
// (sm_90a). Replaces the TPU kernel
// src/repro/kernels/skip_lora/kernel.py::skip_lora_grouped_bwd.
//
//   gA[n, l] = sum_{m in slot n} x[l, m]^T cast_x(g[m] cast_x(B[n, l])^T)
//   gB[n, l] = sum_{m in slot n} cast_x(x[l, m] cast_x(A[n, l]))^T g[m]
//
// fp32, one (N, L, D, R) and one (N, L, R, D) block per slot; zeros for a
// slot with no rows. No gradient for x: the cached activations are
// constants. The TPU kernel keeps each (slot, layer) block resident while a
// sequential grid walks the slot's contiguous run of row tiles, zeroing it
// on the first visit, and runs the four products of one (tile, layer) with
// x read once (kernel.py:449-467).
//
// What bounds it on this card: bytes. At the fleet shape (L 24, M 1024,
// D 2048, R 8, bf16 rows, fp32 pools) x is 100.7 MB, g 4.2 MB, the pools
// and the gradients 12.6 MB each: 130 MB, 38.8 us at 3.35 TB/s, against
// 1.6 GFLOP, under 2 us on the bf16 tensor cores. Every product is an
// M x 8 x K matrix product in bf16 with fp32 sums: exactly
// mma.sync m16n8k16 with the rank as n.
//
// bf16 rows, on the tensor cores (stc::project_tc and stc::outer_tc in
// skip_sum_tc.cuh, which K2 and K5 share):
//   pass 1, one block per (32 grouped positions, layer) at R <= 16 (16
//     positions above), 8 warps: D streams in 128-column chunks through a
//     3-stage `cp.async` ring shared by the block, 16-byte copies: the
//     positions' x and g rows (gathered through `row_src`, -1 gives a zero
//     row; 256 contiguous bytes a row) and the slot's A and B slabs. Warp w
//     takes columns 16 w .. 16 w + 15 of each chunk and forms z = x bf16(A)
//     and gz = g bf16(B)^T with `ldmatrix` and `mma` (the pool is cast to
//     bf16 as the reference does, from either pool type). The positions'
//     slots are non-decreasing, so the block takes them one slot at a time
//     (one round at the fleet shape), reading each slab once for 32 rows.
//     The warps' partial fragments are summed through shared memory in a
//     fixed order, rounded to bf16 as the reference rounds them, and stored
//     to a small (L, M_pad, RP) bf16 scratch (RP: R rounded up to 8, 16, 32
//     or 64). x is read once here; g once a layer, from L2.
//   pass 2, one block per (slot, 4 layers at R <= 8 (2 at R <= 16, else 1),
//     128 columns of D), 8 warps of 16 columns: the block finds its slot's
//     run of tiles in the non-decreasing `tile_slot` by binary search and
//     walks the run's grouped positions in order, 16 at a time (one tile at
//     tm 16; any tm from 1 to 32 by gathering positions across tiles).
//     g's rows once for the block's layers, and each layer's x, z and gz
//     rows, arrive by `cp.async` in a 3-stage ring, x and g rows
//     XOR-swizzled in 16-byte chunks; `ldmatrix.trans` gives x^T and g^T as
//     A operands and z, gz as B operands, and gA = x^T gz, gB^T = g^T z
//     accumulate in fp32 fragments. No atomics and no split of the sum
//     across blocks: the same bits on every run, zeros for a slot with no
//     rows.
// So x is read twice (200 MB, ~60 us): the one-pass form that holds each
// (slot, layer) gradient resident while the slot's rows stream, as the TPU
// kernel does, is later work. D not a multiple of 8, or pointers not
// 16-byte aligned, take plain loads into the same layouts.
//
// fp32 rows (gss::backward in grouped_skip_sum.cuh) stay on CUDA cores: the
// tensor cores' fp32 input is TF32, about three decimal digits, which would
// break the float32 cases' 1e-5 bar. Float32 runs only in the reduced
// card-against-CPU checks and the float32 kernel cases.
//
// Plain C interface for ctypes; returns the CUDA error code of the launches
// (0 on success). The caller owns every buffer and the stream.

#include "grouped_skip_sum.cuh"
#include "skip_sum_tc.cuh"

extern "C" int grouped_skip_sum_bwd(
    const void* x,            // (L, M, D) fp32 or bf16, original row order
    const void* g,            // (M, D), type of x
    const void* a_pool,       // (N, L, D, R) fp32 or bf16
    const void* b_pool,       // (N, L, R, D), same type as a_pool
    const int* row_src,       // (n_tiles * tm,) original row or -1
    const int* tile_slot,     // (n_tiles,) slot of each row tile, non-decreasing
    void* z,                  // scratch: (L, n_tiles * tm, R) fp32 for fp32 x,
    void* gz,                 //   (L, n_tiles * tm, RP) bf16 for bf16 x (kernel.py, bwd_scratch_rank)
    float* ga,                // (N, L, D, R)
    float* gb,                // (N, L, R, D)
    int L, int M, int D, int R, int tm, int n_tiles, int n_slots,
    int x_bf16, int pool_bf16, void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gss::bad_geometry(L, D, R, tm, n_tiles) || M < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  if (x_bf16) {
    const bf* xt = static_cast<const bf*>(x);
    const bf* gt = static_cast<const bf*>(g);
    bf* zt = static_cast<bf*>(z);
    bf* gzt = static_cast<bf*>(gz);
    return stc::by_rank(R, [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      if (pool_bf16)
        return stc::backward<bf, NT>(xt, gt, (const bf*)a_pool, (const bf*)b_pool, row_src, tile_slot, zt, gzt, ga,
                                     gb, L, M, D, R, tm, n_tiles, n_slots, 0, s);
      return stc::backward<float, NT>(xt, gt, (const float*)a_pool, (const float*)b_pool, row_src, tile_slot, zt,
                                      gzt, ga, gb, L, M, D, R, tm, n_tiles, n_slots, 0, s);
    });
  }
  const float* xt = static_cast<const float*>(x);
  const float* gt = static_cast<const float*>(g);
  float* zt = static_cast<float*>(z);
  float* gzt = static_cast<float*>(gz);
  if (pool_bf16)
    return gss::backward<float>(xt, gt, gss::FloatPool<bf>{(const bf*)a_pool, (const bf*)b_pool}, row_src,
                                tile_slot, zt, gzt, ga, gb, L, M, D, R, tm, n_tiles, n_slots, s);
  return gss::backward<float>(xt, gt, gss::FloatPool<float>{(const float*)a_pool, (const float*)b_pool},
                              row_src, tile_slot, zt, gzt, ga, gb, L, M, D, R, tm, n_tiles, n_slots, s);
}
