// Skip-LoRA sums with bf16 rows on Hopper's tensor cores (sm_90a): the
// passes shared by K2 (skip_lora_bwd.cu, one adapter stack), K5
// (grouped_skip_sum_fwd.cu, many grouped rows) and K9
// (grouped_skip_sum_bwd.cu, per-slot gradients). Every product is an
// M x n x K matrix product in bf16 with fp32 sums, the rank (padded to whole
// 8-wide n-tiles) as n: exactly `mma.sync` m16n8k16 (mma.cuh), fed by
// `ldmatrix` from tiles that 16-byte `cp.async` copies bring into a ring of
// shared-memory stages. Casts sit where the reference puts them
// (src/repro/kernels/skip_lora/kernel.py): the adapters are cast to bf16
// before use, z = x A and gz = g B^T are rounded to bf16 between the two
// products, sums are fp32.
//
// What bounds these sums on this card: bytes. At the main path's shapes
// (L 24, M 1024, D 2048, R 8, bf16 rows) x is 100.7 MB and the adapters a
// few MB, against under 2 GFLOP: a few us on the bf16 tensor cores. So
// each pass reads x in whole 256-byte row segments, shares every adapter
// slab across 32 rows, and sums in one fixed order (the same bits on every
// run, no atomics).
//
//   project_tc (z, and gz for K9 and K2), one block per (32 grouped
//     positions at R <= 16, else 16; one layer), 8 warps: D streams in
//     DC-column chunks,
//     the positions' rows gathered through `row_src` (-1 gives a zero row;
//     null: position p is row p), and the slab of the positions' slot
//     (`tile_slot`, non-decreasing; null: slot 0). Warp w takes columns
//     16 w .. 16 w + 15 of each chunk; the warps' partial fragments are
//     summed through shared memory in warp order, rounded to bf16 and stored
//     at (l, p, r) -> l * z_ls + p * z_ps + r, so K9 and K2 keep an
//     (L, M_pad, RP) scratch and K5 a (M_pad, L RP) one, k = l RP + r.
//     A block takes its positions' slots one at a time. g (4 MB at the
//     main path's shapes) is read once a layer, from L2: a separate pass
//     forming gz for all layers from one read of g (tried for K2) took
//     longer than gz beside z does (PERF.md, findings).
//   expand_tc (K5), one block per (64 grouped positions, DC columns of D):
//     out = bf16(sum_k z[p, k] bf16(B[slot, k, :])), z as the A operand in
//     k order, the slot's B stack (L R rows of D) staged 32 rows of k a
//     stage; the rows go straight back to their original positions through
//     `row_src`. Slots as in project_tc.
//   outer_tc (K9, K2), one block per (slot or M chunk, LG layers, DC
//     columns): gA = x^T gz and gB^T = g^T z over the block's positions in
//     order, 16 at a time; `ldmatrix.trans` gives x^T and g^T. K9 finds its
//     slot's run by binary search in `tile_slot`; K2 (null `tile_slot`)
//     takes rows [n chunk, (n + 1) chunk) and writes one fp32 partial per
//     chunk, which a last pass adds in chunk order.
//
// D not a multiple of 8, or pointers not 16-byte aligned, take plain loads
// into the same shared-memory layouts. fp32 rows never come here: the
// tensor cores' fp32 input is TF32 (about three decimal digits), which would
// break the float32 cases' 1e-5 bar; they stay on CUDA cores
// (skip_sum.cuh, grouped_skip_sum.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "numerics.cuh"

namespace stc {

using bf16 = __nv_bfloat16;
using rtk::to_f;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int DC = 16 * WARPS;   // columns of D a project / expand / outer stage takes, 16 per warp

__device__ __forceinline__ bf16 zero_bf16() { return __float2bfloat16_rn(0.f); }

// Original row of grouped position p (row_src null: p itself), -1 past m_pad.
__device__ __forceinline__ int row_at(const int* row_src, int p, int m_pad) {
  return p < m_pad ? (row_src ? row_src[p] : p) : -1;
}
__device__ __forceinline__ int slot_at(const int* tile_slot, int t) { return tile_slot ? tile_slot[t] : 0; }

// First index in the non-decreasing a[0..n) whose value is >= v.
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// 8 bf16 of `src` row `ri` from column `col` (ri < 0: zeros) into dst.
__device__ __forceinline__ void load8(bf16* dst, const bf16* src, const bf16* base, int ri, int col,
                                      int D, bool vec) {
  if (vec) {
    const bool ok = ri >= 0 && col < D;
    tc::cp_async16(dst, ok ? src + (size_t)ri * D + col : base, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = (ri >= 0 && col + i < D) ? src[(size_t)ri * D + col + i] : zero_bf16();
  }
}

// Element offset of (row, 8-column chunk c) in a [rows][DC] bf16 tile,
// chunks XOR-swizzled by the row: ldmatrix without bank conflicts.
__device__ __forceinline__ int wide(int row, int c) { return row * DC + ((c ^ (row & 7)) << 3); }

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---------------------------------------------------------------------------
// project_tc
// ---------------------------------------------------------------------------

// A block takes 16 MT grouped positions and streams D in chunks of DC
// columns: each chunk's x rows (and g's, WITH_G) ([16 MT][DC] bf16) and one
// slot's A slab (and B's) ([DC][R] and [R][DC] pool elements) in one stage.
template <typename P, int NT, bool WITH_G> struct P1 {
  static constexpr int MT = NT <= 2 ? 2 : 1;
  static constexpr int RP = 8 * NT;
  static constexpr int NX = WITH_G ? 2 : 1;
  static constexpr int XB = MT * 16 * DC * 2;                  // bytes of one x chunk
  static constexpr int SB = DC * RP * (int)sizeof(P);          // bytes of one slab, at most
  static constexpr int STAGE = NX * (XB + SB);
  static constexpr int STAGES = WITH_G ? (NT <= 2 ? 3 : 2) : (NT <= 2 ? 4 : 3);
  static constexpr size_t RING = (size_t)STAGES * STAGE;
  static constexpr size_t RED = (size_t)WARPS * MT * 16 * RP * sizeof(float);
  static constexpr size_t SMEM = RING > RED ? RING : RED;
};

// z[l, p, :] = bf16(x[l, row(p)] bf16(A[slot(p), l])) and, WITH_G, gz likewise
// with g and bf16(B[slot(p), l])^T, for the block's 16 MT grouped positions p.
// The slots of those positions are non-decreasing; the block takes them one
// at a time, each round streaming the rows of that slot (the others read as
// zeros) and its slabs.
template <typename P, int NT, bool WITH_G>
__global__ void __launch_bounds__(THREADS, WITH_G ? 1 : 3)
project_tc(const bf16* __restrict__ x, const bf16* __restrict__ g, const P* __restrict__ A,
           const P* __restrict__ B, const int* __restrict__ row_src, const int* __restrict__ tile_slot,
           bf16* __restrict__ z, bf16* __restrict__ gz, int L, int M, int D, int R, int tm, int m_pad,
           size_t z_ls, size_t z_ps, int vec) {
  using G = P1<P, NT, WITH_G>;
  constexpr int MT = G::MT, RP = G::RP, STAGES = G::STAGES;
  constexpr int E = (int)sizeof(P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p0 = blockIdx.x * MT * 16, l = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const bool vc = vec != 0;

  // This thread copies chunk tid & 15 of rows tid / 16 + 16 i.
  static_assert(DC / 8 == 16 && THREADS / 16 == 16, "16 rows of 16 chunks a pass");
  int ri[MT], sl[MT];
  bool any = false;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int p = p0 + (tid >> 4) + 16 * i;
    ri[i] = row_at(row_src, p, m_pad);
    sl[i] = p < m_pad ? slot_at(tile_slot, p / tm) : -1;
    any |= ri[i] >= 0;
  }
  if (!__syncthreads_or(any)) return;   // no live rows: nothing reads these positions
  const int s_lo = slot_at(tile_slot, p0 / tm);
  const int s_hi = slot_at(tile_slot, (min(p0 + MT * 16, m_pad) - 1) / tm);
  const bf16* xl = x + (size_t)l * M * D;
  const int nk = (D + DC - 1) / DC;
  auto stage_ptr = [&](int st) { return smem_raw + (size_t)st * G::STAGE; };

  float acc_z[MT][NT][4], acc_g[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_z[mt][j][e] = acc_g[mt][j][e] = 0.f;

  for (int slot = s_lo; slot <= s_hi; ++slot) {
    int rs[MT];   // this round's rows: the slot's, the others read as zeros
    bool mine = false;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      rs[i] = sl[i] == slot ? ri[i] : -1;
      mine |= rs[i] >= 0;
    }
    if (!__syncthreads_or(mine)) continue;
    const size_t gl = (size_t)slot * L + l;
    const P* a_gl = A + gl * D * R;       // (D, R) row-major
    const P* b_gl = B + gl * R * D;       // (R, D) row-major

    auto issue = [&](int kc, int st) {
      const int c0 = kc * DC, live = min(DC, D - c0);
      unsigned char* sp = stage_ptr(st);
      bf16* xs = reinterpret_cast<bf16*>(sp);
      bf16* gs = reinterpret_cast<bf16*>(sp + G::XB);
      P* as = reinterpret_cast<P*>(sp + G::NX * G::XB);
      P* bs = reinterpret_cast<P*>(sp + G::NX * G::XB + G::SB);
      const int c = tid & 15;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = (tid >> 4) + 16 * i;
        load8(xs + wide(row, c), xl, x, rs[i], c0 + 8 * c, D, vc);
        if constexpr (WITH_G) load8(gs + wide(row, c), g, g, rs[i], c0 + 8 * c, D, vc);
      }
      if (vc) {
        // A slab: the rows c0.. of (D, R) are contiguous, DC R elements.
        const char* asrc = reinterpret_cast<const char*>(a_gl + (size_t)c0 * R);
        for (int e = tid; e < DC * R * E / 16; e += THREADS) {
          const bool ok = e * 16 < live * R * E;
          tc::cp_async16(reinterpret_cast<char*>(as) + e * 16, ok ? asrc + e * 16 : asrc, ok ? 16 : 0);
        }
        if constexpr (WITH_G) {
          // B slab: R rows of DC columns, 16 / E elements a chunk.
          constexpr int CPR = DC * E / 16;
          for (int e = tid; e < R * CPR; e += THREADS) {
            const int r = e / CPR, col = (e % CPR) * (16 / E);
            const bool ok = col < live;
            tc::cp_async16(bs + r * DC + col, ok ? b_gl + (size_t)r * D + c0 + col : b_gl, ok ? 16 : 0);
          }
        }
      } else {
        for (int e = tid; e < DC * R; e += THREADS) {
          const int dd = e / R, r = e % R;
          as[e] = dd < live ? a_gl[(size_t)(c0 + dd) * R + r] : P(0.f);
          if constexpr (WITH_G) bs[r * DC + dd] = dd < live ? b_gl[(size_t)r * D + c0 + dd] : P(0.f);
        }
      }
    };

#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nk) issue(i, i);
      tc::cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
      if (i + STAGES - 1 < nk) issue(i + STAGES - 1, (i + STAGES - 1) % STAGES);
      tc::cp_async_commit();
      tc::cp_async_wait<STAGES - 1>();
      __syncthreads();
      if (i * DC + 16 * warp < D) {
        const unsigned char* sp = stage_ptr(i % STAGES);
        const bf16* xs = reinterpret_cast<const bf16*>(sp);
        const bf16* gs = reinterpret_cast<const bf16*>(sp + G::XB);
        const P* as = reinterpret_cast<const P*>(sp + G::NX * G::XB) + 16 * warp * R;
        const P* bs = reinterpret_cast<const P*>(sp + G::NX * G::XB + G::SB) + 16 * warp;
        uint32_t xa[MT][4], ga[MT][4];
        const int mj = lane >> 3;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int row = mt * 16 + (mj & 1) * 8 + (lane & 7), c = 2 * warp + (mj >> 1);
          tc::ldmatrix_x4(xa[mt], xs + wide(row, c));
          if constexpr (WITH_G) tc::ldmatrix_x4(ga[mt], gs + wide(row, c));
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int r = 8 * j + grp;
          float av[4] = {0.f, 0.f, 0.f, 0.f}, bv[4] = {0.f, 0.f, 0.f, 0.f};
          if (r < R) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int dd = 2 * tig + (u & 1) + (u >> 1) * 8;
              av[u] = to_f<P>(as[dd * R + r]);
              if constexpr (WITH_G) bv[u] = to_f<P>(bs[r * DC + dd]);
            }
          }
          const uint32_t a0 = tc::pack_bf16(av[0], av[1]), a1 = tc::pack_bf16(av[2], av[3]);
          const uint32_t b0 = tc::pack_bf16(bv[0], bv[1]), b1 = tc::pack_bf16(bv[2], bv[3]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma_bf16(acc_z[mt][j], xa[mt], a0, a1);
            if constexpr (WITH_G) tc::mma_bf16(acc_g[mt][j], ga[mt], b0, b1);
          }
        }
      }
      __syncthreads();   // the next issue overwrites this stage
    }
    tc::cp_async_wait<0>();
  }
  __syncthreads();

  // Sum the warps' partials in warp order, round to bf16, store.
  float* red = reinterpret_cast<float*>(smem_raw);   // [WARPS][MT*16][RP]
  const int n_pos = min(MT * 16, m_pad - p0);
#pragma unroll
  for (int which = 0; which < G::NX; ++which) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + grp + (e >> 1) * 8, col = 8 * j + 2 * tig + (e & 1);
          red[((size_t)warp * MT * 16 + row) * RP + col] = which ? acc_g[mt][j][e] : acc_z[mt][j][e];
        }
    __syncthreads();
    bf16* dst = (which ? gz : z) + (size_t)l * z_ls + (size_t)p0 * z_ps;
    for (int e = tid; e < n_pos * RP; e += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(size_t)w * MT * 16 * RP + e];
      dst[(size_t)(e / RP) * z_ps + e % RP] = __float2bfloat16_rn(s);
    }
    __syncthreads();
  }
}

template <typename P, int NT, bool WITH_G>
cudaError_t launch_project(const bf16* x, const bf16* g, const P* a, const P* b, const int* row_src,
                           const int* tile_slot, bf16* z, bf16* gz, int L, int M, int D, int R, int tm,
                           int m_pad, size_t z_ls, size_t z_ps, int vec, cudaStream_t s) {
  using G = P1<P, NT, WITH_G>;
  cudaError_t err = cudaFuncSetAttribute(project_tc<P, NT, WITH_G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((m_pad + G::MT * 16 - 1) / (G::MT * 16), L);
  project_tc<P, NT, WITH_G><<<grid, THREADS, G::SMEM, s>>>(x, g, a, b, row_src, tile_slot, z, gz, L, M, D, R,
                                                            tm, m_pad, z_ls, z_ps, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// expand_tc (K5)
// ---------------------------------------------------------------------------

// A block takes TP grouped positions and DC columns and walks k = l RP + r
// KC at a time: the positions' z ([TP][ZW] bf16) and the slot's B rows
// ([KC][BW] pool elements), each row padded by 16 bytes so ldmatrix and the
// fragment loads hit distinct banks. The output tile goes back through
// shared memory ([TP][OW] bf16) so each row leaves in 16-byte stores.
template <typename P, int NT> struct PE {
  static constexpr int RP = 8 * NT;
  static constexpr int TP = 64, MT = TP / 16;
  static constexpr int KC = 32;
  static constexpr int ZW = KC + 8;
  static constexpr int BW = DC + 16 / (int)sizeof(P);
  static constexpr int ZB = TP * ZW * 2;                       // bytes
  static constexpr int STAGE = ZB + KC * BW * (int)sizeof(P);
  static constexpr int STAGES = 3;
  static constexpr int OW = DC + 8;
  static constexpr size_t RING = (size_t)STAGES * STAGE;
  static constexpr size_t OUT = (size_t)TP * OW * 2;
  static constexpr size_t SMEM = RING > OUT ? RING : OUT;
};

// out[row(p), d] = bf16(sum_k z[p, k] bf16(B[slot(p), k, d])), z at p * L RP + k,
// the k in order, for the block's TP positions and DC columns. B's row k is
// B[slot, l, r] for r < R and zeros otherwise.
template <typename P, int NT>
__global__ void __launch_bounds__(THREADS)
expand_tc(const bf16* __restrict__ z, const P* __restrict__ B, const int* __restrict__ row_src,
          const int* __restrict__ tile_slot, bf16* __restrict__ out, int L, int D, int R, int tm, int m_pad,
          int vec) {
  using G = PE<P, NT>;
  constexpr int RP = G::RP, TP = G::TP, MT = G::MT, KC = G::KC, ZW = G::ZW, BW = G::BW;
  constexpr int STAGES = G::STAGES, OW = G::OW;
  constexpr int E = (int)sizeof(P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p0 = blockIdx.x * TP, dc0 = blockIdx.y * DC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const bool vc = vec != 0;
  const int K = L * RP, nk = (K + KC - 1) / KC;

  // This thread copies chunk tid & 3 of position tid / 4's z row.
  static_assert(TP * KC / 8 == THREADS, "one 16-byte chunk of z a thread");
  const int zrow = tid >> 2, zc = tid & 3, zp = p0 + zrow;
  const int ri = row_at(row_src, zp, m_pad);
  const int sl = zp < m_pad ? tile_slot[zp / tm] : -1;
  if (!__syncthreads_or(ri >= 0)) return;
  const int s_lo = tile_slot[p0 / tm], s_hi = tile_slot[(min(p0 + TP, m_pad) - 1) / tm];
  const bool live_cols = dc0 + 16 * warp < D;

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int slot = s_lo; slot <= s_hi; ++slot) {
    const bool mine = sl == slot && ri >= 0;   // this round's positions: the slot's, others read as zeros
    if (!__syncthreads_or(mine)) continue;
    const P* b_s = B + (size_t)slot * L * R * D;

    auto issue = [&](int kc, int st) {
      unsigned char* sp = smem_raw + (size_t)st * G::STAGE;
      bf16* zs = reinterpret_cast<bf16*>(sp);
      P* bs = reinterpret_cast<P*>(sp + G::ZB);
      const int kz = kc * KC + 8 * zc;
      const bool okz = mine && kz < K;
      tc::cp_async16(zs + zrow * ZW + 8 * zc, okz ? z + (size_t)zp * K + kz : z, okz ? 16 : 0);
      constexpr int CPR = DC * E / 16;   // 16-byte chunks of a B row
      for (int e = tid; e < KC * CPR; e += THREADS) {
        const int row = e / CPR, col = (e % CPR) * (16 / E);
        const int k = kc * KC + row, l = k / RP, r = k % RP;
        const bool ok = k < K && r < R;
        const P* src = b_s + ((size_t)l * R + r) * D + dc0 + col;
        if (vc) {
          const bool okc = ok && dc0 + col < D;
          tc::cp_async16(bs + row * BW + col, okc ? src : B, okc ? 16 : 0);
        } else {
#pragma unroll
          for (int i = 0; i < 16 / E; ++i) bs[row * BW + col + i] = ok && dc0 + col + i < D ? src[i] : P(0.f);
        }
      }
    };

#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nk) issue(i, i);
      tc::cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
      if (i + STAGES - 1 < nk) issue(i + STAGES - 1, (i + STAGES - 1) % STAGES);
      tc::cp_async_commit();
      tc::cp_async_wait<STAGES - 1>();
      __syncthreads();
      if (live_cols) {
        const unsigned char* sp = smem_raw + (size_t)(i % STAGES) * G::STAGE;
        const bf16* zs = reinterpret_cast<const bf16*>(sp);
        const P* bs = reinterpret_cast<const P*>(sp + G::ZB) + 16 * warp + grp;
        const int mj = lane >> 3;
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          uint32_t b0[2], b1[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float bv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) bv[u] = to_f<P>(bs[(ks * 16 + 2 * tig + (u & 1) + (u >> 1) * 8) * BW + 8 * j]);
            b0[j] = tc::pack_bf16(bv[0], bv[1]);
            b1[j] = tc::pack_bf16(bv[2], bv[3]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t za[4];
            tc::ldmatrix_x4(za, zs + (mt * 16 + (mj & 1) * 8 + (lane & 7)) * ZW + ks * 16 + (mj >> 1) * 8);
#pragma unroll
            for (int j = 0; j < 2; ++j) tc::mma_bf16(acc[mt][j], za, b0[j], b1[j]);
          }
        }
      }
      __syncthreads();   // the next issue overwrites this stage
    }
    tc::cp_async_wait<0>();
  }
  __syncthreads();

  // The tile through shared memory, then each live row to its original position.
  bf16* os = reinterpret_cast<bf16*>(smem_raw);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(os + (mt * 16 + grp + 8 * h) * OW + 16 * warp + 8 * j + 2 * tig) =
            tc::pack_bf16(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
  __syncthreads();
  for (int e = tid; e < TP * DC / 8; e += THREADS) {
    const int row = e / (DC / 8), c = e % (DC / 8), col = dc0 + 8 * c;
    const int orow = row_at(row_src, p0 + row, m_pad);
    if (orow < 0 || col >= D) continue;
    const bf16* src = os + row * OW + 8 * c;
    bf16* dst = out + (size_t)orow * D + col;
    if (vc) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && col + i < D; ++i) dst[i] = src[i];
    }
  }
}

// ---------------------------------------------------------------------------
// outer_tc (K9, K2)
// ---------------------------------------------------------------------------

// LG layers a block (4 at R <= 8, 2 at R <= 16, else 1), so g's rows are
// staged once for LG layers; a stage holds g's 16 rows and, per layer, x's
// 16 rows ([16][DC] bf16 each) and z's and gz's ([16][ZW]).
template <int NT> struct P2 {
  static constexpr int LG = NT == 1 ? 4 : NT == 2 ? 2 : 1;
  static constexpr int RP = 8 * NT;
  static constexpr int ZW = RP + (NT % 2 ? 0 : 8);   // z rows padded to an odd number of 16-byte chunks
  static constexpr int XS = 16 * DC, ZS = 16 * ZW;   // bf16 elements
  static constexpr int LAYER = XS + 2 * ZS;
  static constexpr int STAGE = XS + LG * LAYER;
  static constexpr int STAGES = 3;
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)STAGES * STAGE;
};

// For n = blockIdx.x, layers l0 = blockIdx.y * LG .. and columns
// blockIdx.z * DC..: gA[n, l, d, :] = sum_p x[l, row(p), d] gz[l, p, :] and
// gB[n, l, :, d] = sum_p g[row(p), d] z[l, p, :] over positions p, 16 at a
// time in order; z and gz at (l * m_pad + p) * RP. With `tile_slot`, n is a
// slot and p its run of grouped positions; without (K2: rows in order, one
// stack), n is an M chunk: p in [n chunk, (n + 1) chunk), and gA / gB hold
// that chunk's partial.
template <int NT>
__global__ void __launch_bounds__(THREADS)
outer_tc(const bf16* __restrict__ x, const bf16* __restrict__ g, const bf16* __restrict__ z,
         const bf16* __restrict__ gz, const int* __restrict__ row_src, const int* __restrict__ tile_slot,
         float* __restrict__ ga, float* __restrict__ gb, int L, int M, int D, int R, int tm, int n_tiles,
         int chunk, int vec) {
  using G = P2<NT>;
  constexpr int LG = G::LG, RP = G::RP, ZW = G::ZW, XS = G::XS, ZS = G::ZS, STAGES = G::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int range[2];
  const int n = blockIdx.x, l0 = blockIdx.y * LG, dc0 = blockIdx.z * DC;
  const int nl = min(LG, L - l0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const bool vc = vec != 0;
  const int m_pad = n_tiles * tm;
  if (tid == 0) {
    if (tile_slot) {
      range[0] = lower_bound(tile_slot, n_tiles, n) * tm;
      range[1] = lower_bound(tile_slot, n_tiles, n + 1) * tm;
    } else {
      range[0] = n * chunk;
      range[1] = min(m_pad, (n + 1) * chunk);
    }
  }
  __syncthreads();
  const int p_lo = range[0], p_hi = range[1];
  const int nsteps = (p_hi - p_lo + 15) / 16;

  auto issue = [&](int step, int st) {
    bf16* gs = sm + st * G::STAGE;
    {   // g, then x of each layer: 16 rows x 16 chunks, one chunk of each per thread
      const int row = tid >> 4, c = tid & 15, p = p_lo + 16 * step + row;
      const int ri = p < p_hi ? row_at(row_src, p, m_pad) : -1;
      const int off = wide(row, c);
      load8(gs + off, g, g, ri, dc0 + 8 * c, D, vc);
#pragma unroll
      for (int li = 0; li < LG; ++li)
        if (li < nl) load8(gs + XS + li * G::LAYER + off, x + (size_t)(l0 + li) * M * D, x, ri, dc0 + 8 * c, D, vc);
    }
    for (int e = tid; e < nl * 4 * RP; e += THREADS) {   // z and gz: 16 rows x RP / 8 chunks each
      const int li = e / (4 * RP), e1 = e % (4 * RP);
      const int which = e1 >= 2 * RP, e2 = which ? e1 - 2 * RP : e1;
      const int row = e2 / (RP / 8), c = e2 % (RP / 8), p = p_lo + 16 * step + row;
      const bool ok = p < p_hi && row_at(row_src, p, m_pad) >= 0;   // padding positions read as zeros
      const bf16* src = (which ? gz : z) + ((size_t)(l0 + li) * m_pad + p) * RP + c * 8;
      bf16* dst = gs + XS + li * G::LAYER + XS + which * ZS + row * ZW + c * 8;
      tc::cp_async16(dst, ok ? src : z, ok ? 16 : 0);
    }
  };

  float acc_a[LG][NT][4], acc_b[LG][NT][4];
#pragma unroll
  for (int li = 0; li < LG; ++li)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_a[li][j][e] = acc_b[li][j][e] = 0.f;
  const bool live_cols = dc0 + warp * 16 < D;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nsteps) issue(i, i);
    tc::cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    if (i + STAGES - 1 < nsteps) issue(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    tc::cp_async_commit();
    tc::cp_async_wait<STAGES - 1>();
    __syncthreads();
    if (live_cols) {
      const bf16* gs = sm + (i % STAGES) * G::STAGE;
      // g^T and x^T (16 columns x 16 positions) as A operands.
      const int mj = lane >> 3, row = (mj >> 1) * 8 + (lane & 7), c = 2 * warp + (mj & 1);
      const int off = wide(row, c);
      uint32_t gaf[4];
      tc::ldmatrix_x4_trans(gaf, gs + off);
#pragma unroll
      for (int li = 0; li < LG; ++li) {
        if (li < nl) {
          const bf16* xs = gs + XS + li * G::LAYER;
          const bf16* zs = xs + XS;
          const bf16* gzs = zs + ZS;
          uint32_t xa[4];
          tc::ldmatrix_x4_trans(xa, xs + off);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t zb[2], gzb[2];
            tc::ldmatrix_x2_trans(gzb, gzs + (lane & 15) * ZW + 8 * j);
            tc::ldmatrix_x2_trans(zb, zs + (lane & 15) * ZW + 8 * j);
            tc::mma_bf16(acc_a[li][j], xa, gzb[0], gzb[1]);
            tc::mma_bf16(acc_b[li][j], gaf, zb[0], zb[1]);
          }
        }
      }
    }
    __syncthreads();   // the next issue overwrites this stage
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int li = 0; li < LG; ++li) {
    if (li >= nl) continue;
    const size_t nlx = (size_t)n * L + l0 + li;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = dc0 + warp * 16 + grp + (e >> 1) * 8, r = 8 * j + 2 * tig + (e & 1);
        if (d < D && r < R) {
          ga[(nlx * D + d) * R + r] = acc_a[li][j][e];
          gb[(nlx * R + r) * D + d] = acc_b[li][j][e];
        }
      }
  }
}

template <int NT>
cudaError_t launch_outer(const bf16* x, const bf16* g, const bf16* z, const bf16* gz, const int* row_src,
                         const int* tile_slot, float* ga, float* gb, int L, int M, int D, int R, int tm,
                         int n_tiles, int n_blocks, int chunk, int vec, cudaStream_t s) {
  using G = P2<NT>;
  cudaError_t err = cudaFuncSetAttribute(outer_tc<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, (L + G::LG - 1) / G::LG, (D + DC - 1) / DC);
  outer_tc<NT><<<grid, THREADS, G::SMEM, s>>>(x, g, z, gz, row_src, tile_slot, ga, gb, L, M, D, R, tm, n_tiles,
                                               chunk, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Entry points
// ---------------------------------------------------------------------------

// The adapter gradients, z and gz into (L, n_tiles * tm, RP) bf16 scratch.
// K9: per-slot gradients over the grouped positions, one outer block row
// per slot (n_blocks = slots, tile_slot non-decreasing). K2: one stack over
// rows in order (null row_src and tile_slot, tm 1, n_tiles M), one outer
// block row per `chunk` rows, each writing that chunk's partial.
template <typename P, int NT>
int backward(const bf16* x, const bf16* g, const P* a, const P* b, const int* row_src, const int* tile_slot,
             bf16* z, bf16* gz, float* ga, float* gb, int L, int M, int D, int R, int tm, int n_tiles, int n_blocks,
             int chunk, cudaStream_t s) {
  constexpr int RP = 8 * NT;
  const int vec = D % 8 == 0 && aligned16(x) && aligned16(g) && aligned16(a) && aligned16(b);
  const int m_pad = n_tiles * tm;
  cudaError_t err = launch_project<P, NT, true>(x, g, a, b, row_src, tile_slot, z, gz, L, M, D, R, tm, m_pad,
                                                (size_t)m_pad * RP, RP, vec, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_outer<NT>(x, g, z, gz, row_src, tile_slot, ga, gb, L, M, D, R, tm, n_tiles, n_blocks, chunk,
                               vec, s);
}

// K5 with bf16 rows: z (n_tiles * tm, L RP) bf16 scratch, out (M, D) bf16.
template <typename P, int NT>
int grouped_forward(const bf16* x, const P* a, const P* b, const int* row_src, const int* tile_slot, bf16* z,
                    bf16* out, int L, int M, int D, int R, int tm, int n_tiles, cudaStream_t s) {
  using G = PE<P, NT>;
  constexpr int RP = 8 * NT;
  const int vec = D % 8 == 0 && aligned16(x) && aligned16(a) && aligned16(b) && aligned16(out);
  const int m_pad = n_tiles * tm;
  cudaError_t err = launch_project<P, NT, false>(x, nullptr, a, nullptr, row_src, tile_slot, z, nullptr, L, M,
                                                 D, R, tm, m_pad, RP, (size_t)L * RP, vec, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(expand_tc<P, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m_pad + G::TP - 1) / G::TP, (D + DC - 1) / DC);
  expand_tc<P, NT><<<grid, THREADS, G::SMEM, s>>>(z, b, row_src, tile_slot, out, L, D, R, tm, m_pad, vec);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, NT>) for rank R: NT = ceil(R / 8) rounded up
// to a power of two, the 8-wide n-tiles of the bf16 scratch
// (kernel.py, bwd_scratch_rank).
template <typename F> int by_rank(int R, F f) {
  if (R <= 8) return f(std::integral_constant<int, 1>{});
  if (R <= 16) return f(std::integral_constant<int, 2>{});
  if (R <= 32) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, 8>{});
}

}  // namespace stc
