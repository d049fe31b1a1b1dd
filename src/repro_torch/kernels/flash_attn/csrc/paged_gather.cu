// Paged KV block gather (K10) for Hopper (sm_90a). Replaces the TPU kernel
// src/repro/kernels/flash_attn/paged.py::paged_gather.
//
//   out[l, b, j * block : (j + 1) * block] = pool[l, tables[b, j]]
//
// for a pool of (L, NB, block, n_kv, hd) blocks (L = 1 without a layer axis)
// and block tables (B, T) of int32 pool ids. Pure data movement: the output
// is the pool's bytes, so it is bitwise the plain version's (index_select)
// whatever the element type.
//
// What bounds it: bytes. Each gathered block is read once and written once;
// at the scheduler's reuse wave on full-width stablelm-1.6b (L 24, block 32,
// n_kv 32, hd 64, bf16, tables (2, 14)) one gather moves 2 x 88,080,384 B,
// 52.6 us at 3.35 TB/s. The TPU kernel scalar-prefetches the table so each
// grid step DMAs one block; here each CTA loads its own table entry and
// copies one (layer, row, slot) block (128 KB at that shape) with 16-byte
// vector loads and stores, neighbouring threads on neighbouring addresses,
// four loads in flight a thread before their stores. A block whose byte
// width is not a multiple of 16 is copied in 4-, 2- or 1-byte units. An id
// outside [0, NB) writes zeros instead of reading outside the pool. TMA bulk
// copies (cp.async.bulk) and gathering straight into the admission caches
// are left for later work.
//
// Plain C interface for ctypes; returns the CUDA error code of the launch
// (0 on success). The caller owns every buffer and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace pg {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

template <typename V>
__global__ void __launch_bounds__(THREADS) gather_blocks(const V* __restrict__ pool,
                                                         const int* __restrict__ tables,
                                                         V* __restrict__ out, int n_blocks,
                                                         int rows_slots, long long units) {
  const long long bs = blockIdx.x;      // row * T + slot: the table entry of this block
  const long long layer = blockIdx.y;
  const int id = __ldg(tables + bs);
  V* dst = out + (layer * rows_slots + bs) * units;
  if (id < 0 || id >= n_blocks) {
    for (long long i = threadIdx.x; i < units; i += THREADS) dst[i] = V{};
    return;
  }
  const V* src = pool + (layer * n_blocks + id) * units;
  long long i = threadIdx.x;
  for (; i + (UNROLL - 1) * THREADS < units; i += UNROLL * THREADS) {
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(src + i + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) dst[i + u * THREADS] = v[u];
  }
  for (; i < units; i += THREADS) dst[i] = __ldg(src + i);
}

template <typename V>
int launch(const void* pool, const int* tables, void* out, int n_layers, int n_blocks,
           int rows_slots, long long block_bytes, cudaStream_t s) {
  const dim3 grid(rows_slots, n_layers);
  gather_blocks<V><<<grid, THREADS, 0, s>>>(static_cast<const V*>(pool), tables,
                                            static_cast<V*>(out), n_blocks, rows_slots,
                                            block_bytes / (long long)sizeof(V));
  return (int)cudaGetLastError();
}

}  // namespace pg

extern "C" int paged_gather(
    const void* pool,     // (L, NB, block, n_kv, hd), any element type
    const void* tables,   // (B, T) int32 pool ids
    void* out,            // (L, B, T * block, n_kv, hd), type of pool
    int n_layers, int n_blocks, int rows_slots, int block_bytes, void* stream) {
  if (n_layers < 1 || n_layers > 65535 || n_blocks < 1 || rows_slots < 1 || block_bytes < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const uintptr_t align = reinterpret_cast<uintptr_t>(pool) | reinterpret_cast<uintptr_t>(out);
  if (block_bytes % 16 == 0 && align % 16 == 0)
    return pg::launch<uint4>(pool, tbl, out, n_layers, n_blocks, rows_slots, block_bytes, s);
  if (block_bytes % 4 == 0 && align % 4 == 0)
    return pg::launch<uint32_t>(pool, tbl, out, n_layers, n_blocks, rows_slots, block_bytes, s);
  if (block_bytes % 2 == 0 && align % 2 == 0)
    return pg::launch<uint16_t>(pool, tbl, out, n_layers, n_blocks, rows_slots, block_bytes, s);
  return pg::launch<uint8_t>(pool, tbl, out, n_layers, n_blocks, rows_slots, block_bytes, s);
}
