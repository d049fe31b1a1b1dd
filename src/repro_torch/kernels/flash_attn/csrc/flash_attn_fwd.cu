// Causal flash attention, forward (K4), for Hopper (sm_90a). Replaces the
// TPU kernel src/repro/kernels/flash_attn/kernel.py::flash_attention_fwd.
//
//   out[bh, i] = sum_j softmax_j( mask(softcap(scale * q[bh, i] . k[kv(bh), j])) ) v[kv(bh), j]
//
// with the key j attended iff j <= i and, for a sliding window w > 0,
// j > i - w; GQA is folded by reading KV head kv(bh) = b * Hkv + h / group,
// so the repeated K/V the reference builds are never made. Scale, then
// softcap, then the mask, in the reference kernel's order.
//
// What bounds it: at the populate shape (B*H 256, S 128, hd 64, bf16) the
// q, k, v and out tiles are 16.8 MB, ~5 us at 3.35 TB/s, and the causal
// half of 4 S^2 hd multiply-adds per head is 0.27 GFLOP: bytes bound it on
// paper, but a kernel on CUDA cores (67 TFLOP/s fp32) is bound by its
// operations first. The design is the TPU kernel's online softmax with the
// (S, S) scores never written out: one block per (64-row query tile, b*h),
// looping over 64-key tiles staged in shared memory as fp32; running max,
// normaliser and accumulator in fp32; tiles wholly outside the causal
// window are never visited. The TPU kernel's 128-row query tile is halved
// so that the fp32 accumulator of a 64 x 256 tile fits the registers of 256
// threads (64 per thread at head_dim 256). Tensor cores (mma / wgmma) and
// TMA are left for later work.
//
// Plain C interface for ctypes; returns the CUDA error code of the launch
// (0 on success). The caller owns every buffer and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "numerics.cuh"

namespace fa {

using rtk::from_f;
using rtk::round_to;
using rtk::to_f;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per step
constexpr int THREADS = 256;  // 8 warps
constexpr int HD_MAX = 256;

// Shared memory, as fp32: q (BQ, HDP+1), k (BK, HDP+1), v (BK, HDP),
// p (BQ, BK+1), alpha (BQ), l (BQ).
inline size_t smem_bytes(int hdp) {
  return sizeof(float) * ((size_t)BQ * (hdp + 1) + (size_t)BK * (hdp + 1) + (size_t)BK * hdp +
                          (size_t)BQ * (BK + 1) + 2 * BQ);
}

// NC = head_dim rounded up to a multiple of 32, over 32: output columns per lane.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, int H, int group, int S, int hd, int window, float softcap,
          float scale) {
  constexpr int HDP = NC * 32;
  extern __shared__ float smem[];
  float* qs = smem;                        // [BQ][HDP + 1]
  float* ks = qs + BQ * (HDP + 1);         // [BK][HDP + 1]
  float* vs = ks + BK * (HDP + 1);         // [BK][HDP]
  float* ps = vs + BK * HDP;               // [BQ][BK + 1]
  float* alpha_s = ps + BQ * (BK + 1);     // [BQ]
  float* l_s = alpha_s + BQ;               // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int kvh = (bh / H) * (H / group) + (bh % H) / group;
  const T* qb = q + (size_t)bh * S * hd;
  const T* kb = k + (size_t)kvh * S * hd;
  const T* vb = v + (size_t)kvh * S * hd;

  // Staging loops have compile-time trip counts, so their loads issue together.
#pragma unroll 8
  for (int j = 0; j < BQ * HDP / THREADS; ++j) {
    const int e = tid + j * THREADS, i = e / HDP, c = e % HDP;
    qs[i * (HDP + 1) + c] = (q0 + i < S && c < hd) ? to_f<T>(qb[(size_t)(q0 + i) * hd + c]) : 0.f;
  }

  // Softmax threads: 4 per query row, 16 keys each; they keep the row's
  // running max and normaliser. PV threads: warp w owns rows 8w .. 8w + 7,
  // lane owns columns lane + 32 j.
  const int srow = tid >> 2, spart = tid & 3;
  float m_run = -INFINITY, l_run = 0.f;
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const int q_last = min(S, q0 + BQ) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = k_first / BK * BK; k0 <= q_last; k0 += BK) {
#pragma unroll 8
    for (int jj = 0; jj < BK * HDP / THREADS; ++jj) {
      const int e = tid + jj * THREADS, j = e / HDP, c = e % HDP;
      const bool live = k0 + j < S && c < hd;
      ks[j * (HDP + 1) + c] = live ? to_f<T>(kb[(size_t)(k0 + j) * hd + c]) : 0.f;
      vs[j * HDP + c] = live ? to_f<T>(vb[(size_t)(k0 + j) * hd + c]) : 0.f;
    }
    __syncthreads();

    // Scores: thread (ty, tx) owns rows 4 ty + i and keys tx + 16 j.
    {
      const int ty = tid >> 4, tx = tid & 15;
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < HDP; ++c) {   // columns past hd are staged as zeros
        float kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (HDP + 1) + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qv = qs[(ty * 4 + i) * (HDP + 1) + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv, kv[j], sc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty * 4 + i, qi = q0 + row;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = tx + 16 * j, kj = k0 + key;
          float s = sc[i][j] * scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          const bool live = qi < S && kj < S && kj <= qi && (window <= 0 || kj > qi - window);
          ps[row * (BK + 1) + key] = live ? s : -INFINITY;   // -inf marks a masked key
        }
      }
    }
    __syncthreads();

    // Online softmax: the tile's max, the rescale of what came before, and
    // p = exp(s - m) (zero where masked), rounded to the value type for the
    // product with v; the normaliser sums the fp32 p.
    {
      float* prow = ps + srow * (BK + 1) + spart * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, prow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m_run - m_new);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float p = prow[j] == -INFINITY ? 0.f : expf(prow[j] - m_new);
          sum += p;
          prow[j] = round_to<T>(p);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) prow[j] = 0.f;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (spart == 0) alpha_s[srow] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = alpha_s[warp * 8 + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= a;
    }
    for (int key = 0; key < BK; ++key) {
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = vs[key * HDP + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = ps[(warp * 8 + i) * (BK + 1) + key];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if (spart == 0) l_s[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = warp * 8 + i, qi = q0 + row;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l_s[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < hd) out[((size_t)bh * S + qi) * hd + c] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int H, int group,
           int S, int hd, int window, float softcap, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(NC * 32);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_fwd<T, NC><<<grid, THREADS, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), H, group, S, hd, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int BH, int H, int group,
             int S, int hd, int window, float softcap, float scale, cudaStream_t s) {
  if (hd <= 32) return launch<T, 1>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
  if (hd <= 64) return launch<T, 2>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
  if (hd <= 128) return launch<T, 4>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
  return launch<T, 8>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
}

}  // namespace fa

extern "C" int flash_attn_fwd(
    const void* q,      // (B * H, S, hd) fp32 or bf16
    const void* k,      // (B * Hkv, S, hd), type of q
    const void* v,      // (B * Hkv, S, hd), type of q
    void* out,          // (B * H, S, hd), type of q
    int BH, int H, int group, int S, int hd, int window, float softcap, float scale,
    int bf16, void* stream) {
  if (BH < 1 || H < 1 || group < 1 || H % group || BH % H || S < 1 || hd < 1 || hd > fa::HD_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fa::dispatch<__nv_bfloat16>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
  return fa::dispatch<float>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
}
