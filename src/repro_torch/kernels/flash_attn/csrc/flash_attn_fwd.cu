// Causal flash attention, forward (K4), for Hopper (sm_90a). Replaces the
// TPU kernel src/repro/kernels/flash_attn/kernel.py::flash_attention_fwd.
//
//   out[bh, i] = sum_j softmax_j( mask(softcap(scale * q[bh, i] . k[kv(bh), j])) ) v[kv(bh), j]
//
// with the key j attended iff j <= i and, for a sliding window w > 0,
// j > i - w; GQA is folded by reading KV head kv(bh) = b * Hkv + h / group,
// so the repeated K/V the reference builds are never made. Scale, then
// softcap, then the mask, in the reference kernel's order; p = exp(s - m)
// is rounded to the value type for the product with v while the normaliser
// l sums the fp32 p, and the output is acc / max(l, 1e-30), as the TPU
// kernel does.
//
// What bounds it on this card: at the populate shape (B*H 256, S 128,
// hd 64, bf16) q, k, v and out are 16.8 MB, 5.0 us at 3.35 TB/s, against
// 0.27 GFLOP of causal products, 0.3 us on the bf16 tensor cores: bytes on
// paper; in practice the latency of each block's one or two dependent
// tiles, and the issue rate of the softmax's per-element work once the
// tiles have landed. At the gemma-2-like shape (S 1024, hd 256, window
// 512) each 64-row query tile re-reads ~18 K/V tiles from L2.
//
// bf16 route (flash_fwd_bf16), FlashAttention-2-shaped: one block per
// (64-row query tile, b*h), 4 warps of 16 query rows. K and V tiles of 64
// keys (32 at head_dim > 128) arrive by 16-byte `cp.async` copies in a
// two-stage ring of bf16 shared memory, rows XOR-swizzled in 16-byte chunks
// so `ldmatrix` reads without bank conflicts; head_dim is padded to 64, 128
// or 256 with zeros there. K and V are separate copy groups, so the scores
// start before V lands. S = Q K^T and O += P V run on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 sums); the online softmax works on the
// S accumulator fragments in registers (row max and sum across the quad of
// lanes that share a row), in the log2 domain (one FMA and one ex2 an
// element; a softcap's tanh from one ex2 and one rcp), and skips the
// rescale of O when no row's max moved. P is repacked from the fragments as
// the A operand of the P V product, with V through `ldmatrix.trans`: P
// never touches shared memory. Only tiles that cross the diagonal, the
// window's edge or a ragged S are masked (bounds per row, precomputed), and
// there each warp skips the 16-key steps none of its rows sees; tiles wholly
// outside the window are never visited. The output goes through the warp's
// own rows of the Q buffer and out with 16-byte stores. Head dims that are
// not a multiple of 8, or pointers not 16-byte aligned, take plain loads
// and stores into the same layout.
//
// fp32 route (flash_fwd_f32): CUDA cores, fp32 staged in shared memory,
// scores and the value product as fp32 FMA loops. It stays there on
// purpose: the tensor cores' fp32 input is TF32, about three decimal digits,
// which would break the float32 cases' 1e-5 bar. Float32 runs only in the
// reduced card-against-CPU checks and the float32 kernel cases.
//
// Plain C interface for ctypes; returns the CUDA error code of the launch
// (0 on success). The caller owns every buffer and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace fa {

constexpr int HD_MAX = 256;
constexpr int BQ = 64;  // query rows per block, both routes

// ---------------------------------------------------------------------------
// bf16 route: tensor cores, cp.async ring
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_WARPS = 4;                 // 16 query rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x, -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softcap tanh(scale s / softcap) log2(e) as k - 2 k / (2^(s cap_in) + 1),
// cap_in = 2 scale log2(e) / softcap, k = cap_out = softcap log2(e): tanh
// from one exponential and one reciprocal, within ~1e-7 of tanh, saturating
// at +-1.
__device__ __forceinline__ float capped_log2(float s, float cap_in, float cap_out) {
  return fmaf(-2.f * cap_out, fast_rcp(fast_exp2(s * cap_in) + 1.f), cap_out);
}

// Element offset of (row, col) in a tile of HDP-wide bf16 rows whose
// 16-byte chunks are XOR-swizzled by the row (HDP >= 64: 8 or more chunks).
template <int HDP> __device__ __forceinline__ int swz(int row, int col) {
  return row * HDP + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

// Rows [r0, r0 + nrows) of a (S, hd) matrix into a swizzled tile: 16-byte
// cp.async copies, zero fill past S and past hd; with `vec` false, plain
// loads and stores (hd not a multiple of 8, or unaligned pointers).
template <int HDP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int nrows, int S,
                                          int hd, bool vec) {
  constexpr int CPR = HDP / 8;
  for (int e = threadIdx.x; e < nrows * CPR; e += TC_THREADS) {
    const int row = e / CPR, c = e % CPR, sr = r0 + row;
    bf16* d = dst + swz<HDP>(row, c * 8);
    if (vec) {
      const bool live = sr < S && c * 8 < hd;
      tc::cp_async16(d, live ? src + (size_t)sr * hd + c * 8 : src, live ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = c * 8 + i;
        d[i] = (sr < S && col < hd) ? src[(size_t)sr * hd + col] : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// EXACT: hd == HDP, so no 16-column step of head_dim is skipped.
template <int HDP, int BK, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ out, int H, int group, int S, int hd, int window, float softcap,
               float scale, int vec) {
  constexpr int NS = BK / 8;      // key n-tiles of S
  constexpr int NO = HDP / 8;     // head_dim n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][HDP]
  bf16* ks = qs + BQ * HDP;                       // [2][BK][HDP]
  bf16* vs = ks + 2 * BK * HDP;                   // [2][BK][HDP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int kvh = (bh / H) * (H / group) + (bh % H) / group;
  const bf16* qb = q + (size_t)bh * S * hd;
  const bf16* kb = k + (size_t)kvh * S * hd;
  const bf16* vb = v + (size_t)kvh * S * hd;
  const bool vc = vec != 0;

  const int q_last = min(S, q0 + BQ) - 1;
  const int kt_first = (window > 0 ? max(0, q0 - window + 1) : 0) / BK;
  const int kt_last = q_last / BK;
  // Without a softcap the raw scores are kept and exp(scale (s - m)) is
  // 2^(s cs - m cs), cs = scale log2(e); with one, s becomes
  // softcap tanh(scale s / softcap) log2(e) first and cs = 1.
  const float cs = softcap > 0.f ? 1.f : scale * LOG2E;
  const float cap_in = softcap > 0.f ? 2.f * scale * LOG2E / softcap : 0.f, cap_out = softcap * LOG2E;
  const int row_w = warp * 16;                     // this warp's first row in the tile
  const int wq_lo = q0 + row_w, wq_hi = min(q_last, wq_lo + 15);   // the warp's queries
  const int mj = lane >> 3;                        // the 8 x 8 matrix this lane addresses

  // Groups in order: {Q, K tile 0}, {V tile 0}, then {K t+1}, {V t+1} per tile.
  load_tile<HDP>(qs, qb, q0, BQ, S, hd, vc);
  load_tile<HDP>(ks, kb, kt_first * BK, BK, S, hd, vc);
  tc::cp_async_commit();
  load_tile<HDP>(vs, vb, kt_first * BK, BK, S, hd, vc);
  tc::cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // One key tile. EDGE: the tile crosses the diagonal, the window's edge or
  // S, so scores are masked, and 16-key steps that none of this warp's
  // queries sees are skipped.
  auto step = [&](auto edge_c, int k0, const bf16* kst, const bf16* vst) {
    constexpr bool EDGE = decltype(edge_c)::value;
    bool need[BK / 16];
#pragma unroll
    for (int p = 0; p < BK / 16; ++p) {
      const int ka = k0 + 16 * p;
      need[p] = !EDGE || (ka <= wq_hi && ka < S && (window <= 0 || ka + 15 > wq_lo - window));
    }

    // S = Q K^T over head_dim in steps of 16.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      if (EXACT || kk * 16 < hd) {
        uint32_t qa[4];
        tc::ldmatrix_x4(qa, qs + swz<HDP>(row_w + (lane & 15), kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int p = 0; p < NS / 2; ++p) {
          if (!need[p]) continue;
          uint32_t kf[4];
          tc::ldmatrix_x4(kf, kst + swz<HDP>(p * 16 + (mj >> 1) * 8 + (lane & 7), kk * 16 + (mj & 1) * 8));
          tc::mma_bf16(s[2 * p], qa, kf[0], kf[1]);
          tc::mma_bf16(s[2 * p + 1], qa, kf[2], kf[3]);
        }
      }
    }

    // Softcap, the mask, then the online softmax on the fragments: rows grp
    // (e 0, 1) and grp + 8 (e 2, 3), each shared by a quad of lanes.
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = capped_log2(s[j][e], cap_in, cap_out);
    }
    if (EDGE) {   // key k0 + 2 tig + off is kept for query qi iff lo <= off <= hi
      int hi[2], lo[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = wq_lo + grp + 8 * h, base = k0 + 2 * tig;
        hi[h] = min(qi, S - 1) - base;
        lo[h] = window > 0 ? qi - window + 1 - base : -(1 << 30);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = j * 8 + (e & 1), h = e >> 1;
          if (off > hi[h] || off < lo[h]) s[j][e] = -INFINITY;
        }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
      alpha[h] = fast_exp2((m_run[h] - m_use) * cs);
      const float mcs = m_use * cs;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = fast_exp2(fmaf(s[j][e], cs, -mcs));
          sum += p;
          s[j][e] = p;
        }
      l_run[h] = l_run[h] * alpha[h] + sum;   // this lane's part; the quad is summed at the end
      m_run[h] = m_new;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {   // a row's max moved
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    tc::cp_async_wait<2>();   // this tile's V
    __syncthreads();

    // O += P V: the S fragments of key n-tiles 2 kk2, 2 kk2 + 1 are the A
    // operand of one 16-key step; V arrives transposed by ldmatrix.
#pragma unroll
    for (int kk2 = 0; kk2 < BK / 16; ++kk2) {
      if (!need[kk2]) continue;
      const uint32_t pa[4] = {tc::pack_bf16(s[2 * kk2][0], s[2 * kk2][1]),
                              tc::pack_bf16(s[2 * kk2][2], s[2 * kk2][3]),
                              tc::pack_bf16(s[2 * kk2 + 1][0], s[2 * kk2 + 1][1]),
                              tc::pack_bf16(s[2 * kk2 + 1][2], s[2 * kk2 + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        if (EXACT || np * 16 < hd) {
          uint32_t vf[4];
          tc::ldmatrix_x4_trans(vf, vst + swz<HDP>(kk2 * 16 + (mj & 1) * 8 + (lane & 7), np * 16 + (mj >> 1) * 8));
          tc::mma_bf16(o[2 * np], pa, vf[0], vf[1]);
          tc::mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
  };

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int st = (kt - kt_first) & 1;
    if (kt < kt_last) load_tile<HDP>(ks + (st ^ 1) * BK * HDP, kb, (kt + 1) * BK, BK, S, hd, vc);
    tc::cp_async_commit();
    if (kt < kt_last) load_tile<HDP>(vs + (st ^ 1) * BK * HDP, vb, (kt + 1) * BK, BK, S, hd, vc);
    tc::cp_async_commit();
    tc::cp_async_wait<3>();   // this tile's K (and, on the first, Q)
    __syncthreads();
    const int k0 = kt * BK;
    const bool edge = k0 + BK - 1 > q0 || (window > 0 && k0 <= q_last - window) || k0 + BK > S;
    if (edge)
      step(std::true_type{}, k0, ks + st * BK * HDP, vs + st * BK * HDP);
    else
      step(std::false_type{}, k0, ks + st * BK * HDP, vs + st * BK * HDP);
    __syncthreads();   // the next tile's copies overwrite this stage
  }

  // Normalise, stage the warp's 16 rows in its own rows of the Q buffer, and
  // write them out in 16-byte chunks.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = row_w + grp + 8 * h;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(qs + swz<HDP>(row, n * 8 + 2 * tig)) = val;
    }
  }
  __syncwarp();
  constexpr int CPR = HDP / 8;
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = e / CPR, c = e % CPR, qi = wq_lo + r;
    if (qi >= S || c * 8 >= hd) continue;
    const bf16* src = qs + swz<HDP>(row_w + r, c * 8);
    bf16* dst = out + ((size_t)bh * S + qi) * hd + c * 8;
    if (vc) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && c * 8 + i < hd; ++i) dst[i] = src[i];
    }
  }
}

template <int HDP, int BK, bool EXACT>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int BH, int H, int group,
                int S, int hd, int window, float softcap, float scale, cudaStream_t s) {
  const size_t smem = sizeof(bf16) * (size_t)HDP * (BQ + 4 * BK);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<HDP, BK, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(out);
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_fwd_bf16<HDP, BK, EXACT><<<grid, TC_THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), H, group, S, hd, window, softcap, scale, vec);
  return (int)cudaGetLastError();
}

// head_dim padded to 64, 128 or 256; 64-key tiles, 32 at 256 (registers).
template <bool EXACT>
int dispatch_bf16(const void* q, const void* k, const void* v, void* out, int BH, int H, int group,
                  int S, int hd, int window, float softcap, float scale, cudaStream_t s) {
  if (hd <= 64) return launch_bf16<64, 64, EXACT>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
  if (hd <= 128) return launch_bf16<128, 64, EXACT>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
  return launch_bf16<256, 32, EXACT>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
}

// ---------------------------------------------------------------------------
// fp32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BK = 64;        // keys per step
constexpr int THREADS = 256;  // 8 warps

// Shared memory: q (BQ, HDP+1), k (BK, HDP+1), v (BK, HDP), p (BQ, BK+1),
// alpha (BQ), l (BQ).
inline size_t smem_bytes(int hdp) {
  return sizeof(float) * ((size_t)BQ * (hdp + 1) + (size_t)BK * (hdp + 1) + (size_t)BK * hdp +
                          (size_t)BQ * (BK + 1) + 2 * BQ);
}

// One block per (64-row query tile, b*h), looping over 64-key tiles staged
// in shared memory; running max, normaliser and accumulator in fp32. NC =
// head_dim rounded up to a multiple of 32, over 32: output columns per lane.
template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ out, int H, int group, int S, int hd, int window, float softcap,
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
  const float* qb = q + (size_t)bh * S * hd;
  const float* kb = k + (size_t)kvh * S * hd;
  const float* vb = v + (size_t)kvh * S * hd;

  // Staging loops have compile-time trip counts, so their loads issue together.
#pragma unroll 8
  for (int j = 0; j < BQ * HDP / THREADS; ++j) {
    const int e = tid + j * THREADS, i = e / HDP, c = e % HDP;
    qs[i * (HDP + 1) + c] = (q0 + i < S && c < hd) ? qb[(size_t)(q0 + i) * hd + c] : 0.f;
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
      ks[j * (HDP + 1) + c] = live ? kb[(size_t)(k0 + j) * hd + c] : 0.f;
      vs[j * HDP + c] = live ? vb[(size_t)(k0 + j) * hd + c] : 0.f;
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
    // p = exp(s - m) (zero where masked); the normaliser sums p.
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
          prow[j] = p;
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
      if (c < hd) out[((size_t)bh * S + qi) * hd + c] = acc[i][j] * inv;
    }
  }
}

template <int NC>
int launch_f32(const void* q, const void* k, const void* v, void* out, int BH, int H, int group,
               int S, int hd, int window, float softcap, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(NC * 32);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_fwd_f32<NC><<<grid, THREADS, smem, s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                static_cast<const float*>(v), static_cast<float*>(out), H,
                                                group, S, hd, window, softcap, scale);
  return (int)cudaGetLastError();
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
  if (bf16) {
    if (hd == 64 || hd == 128 || hd == 256)
      return fa::dispatch_bf16<true>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
    return fa::dispatch_bf16<false>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
  }
  if (hd <= 32) return fa::launch_f32<1>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
  if (hd <= 64) return fa::launch_f32<2>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
  if (hd <= 128) return fa::launch_f32<4>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
  return fa::launch_f32<8>(q, k, v, out, BH, H, group, S, hd, window, softcap, scale, s);
}
