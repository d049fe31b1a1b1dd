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
// bf16 rows (gbw::project_tc, gbw::outer_tc), on the tensor cores:
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

#include <stdint.h>

#include "grouped_skip_sum.cuh"
#include "mma.cuh"

namespace gbw {

using bf16 = __nv_bfloat16;
using rtk::to_f;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int DC = 16 * WARPS;   // columns of D a stage takes, 16 per warp

__device__ __forceinline__ bf16 zero_bf16() { return __float2bfloat16_rn(0.f); }

// Pass 1 geometry: a block takes 16 MT grouped positions (MT m-tiles of
// 16 rows: 2 at R <= 16, else 1, for registers and shared memory) and
// streams D in chunks of DC columns, each chunk's x and g rows ([16 MT][DC]
// bf16 each) and one slot's A and B slabs ([DC][R] and [R][DC] pool
// elements) in one stage of a ring shared by the block; warp w takes the
// chunk's columns 16 w .. 16 w + 15.
template <typename P, int NT> struct P1 {
  static constexpr int MT = NT <= 2 ? 2 : 1;
  static constexpr int RP = 8 * NT;
  static constexpr int XB = MT * 16 * DC * 2;                  // bytes of one x chunk
  static constexpr int SB = DC * RP * (int)sizeof(P);          // bytes of one slab, at most
  static constexpr int STAGE = 2 * XB + 2 * SB;
  static constexpr int STAGES = NT <= 2 ? 3 : 2;
  static constexpr size_t RING = (size_t)STAGES * STAGE;
  static constexpr size_t RED = (size_t)WARPS * MT * 16 * RP * sizeof(float);
  static constexpr size_t SMEM = RING > RED ? RING : RED;
};

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

// pass 1: z[l, p, :] = bf16(x[l, row(p)] bf16(A[slot(p), l])), gz likewise
// with g and bf16(B[slot(p), l])^T, for the block's 16 MT grouped positions
// p. The slots of those positions are non-decreasing; the block takes them
// one at a time (one round at the fleet shape), each round streaming the
// rows of that slot (the others read as zeros) and its A and B slabs.
template <typename P, int NT>
__global__ void __launch_bounds__(THREADS)
project_tc(const bf16* __restrict__ x, const bf16* __restrict__ g, const P* __restrict__ A,
           const P* __restrict__ B, const int* __restrict__ row_src, const int* __restrict__ tile_slot,
           bf16* __restrict__ z, bf16* __restrict__ gz, int L, int M, int D, int R, int tm, int m_pad,
           int vec) {
  using G = P1<P, NT>;
  constexpr int MT = G::MT, RP = G::RP, STAGES = G::STAGES;
  constexpr int E = (int)sizeof(P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p0 = blockIdx.x * MT * 16, l = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const bool vc = vec != 0;

  // This thread copies chunk tid & 15 of rows tid / 16 + 16 i.
  int ri[MT], sl[MT];
  bool any = false;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int p = p0 + (tid >> 4) + 16 * i;
    ri[i] = p < m_pad ? row_src[p] : -1;
    sl[i] = p < m_pad ? tile_slot[p / tm] : -1;
    any |= ri[i] >= 0;
  }
  if (!__syncthreads_or(any)) return;   // no live rows: pass 2 reads none of these positions
  const int s_lo = tile_slot[p0 / tm], s_hi = tile_slot[(min(p0 + MT * 16, m_pad) - 1) / tm];
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
      P* as = reinterpret_cast<P*>(sp + 2 * G::XB);
      P* bs = reinterpret_cast<P*>(sp + 2 * G::XB + G::SB);
      const int c = tid & 15;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = (tid >> 4) + 16 * i;
        load8(xs + wide(row, c), xl, x, rs[i], c0 + 8 * c, D, vc);
        load8(gs + wide(row, c), g, g, rs[i], c0 + 8 * c, D, vc);
      }
      if (vc) {
        // A slab: the rows c0.. of (D, R) are contiguous, DC R elements.
        const char* asrc = reinterpret_cast<const char*>(a_gl + (size_t)c0 * R);
        for (int e = tid; e < DC * R * E / 16; e += THREADS) {
          const bool ok = e * 16 < live * R * E;
          tc::cp_async16(reinterpret_cast<char*>(as) + e * 16, ok ? asrc + e * 16 : asrc, ok ? 16 : 0);
        }
        // B slab: R rows of DC columns, 16 / E elements a chunk.
        constexpr int CPR = DC * E / 16;
        for (int e = tid; e < R * CPR; e += THREADS) {
          const int r = e / CPR, col = (e % CPR) * (16 / E);
          const bool ok = col < live;
          tc::cp_async16(bs + r * DC + col, ok ? b_gl + (size_t)r * D + c0 + col : b_gl, ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < DC * R; e += THREADS) {
          const int dd = e / R, r = e % R;
          as[e] = dd < live ? a_gl[(size_t)(c0 + dd) * R + r] : P(0.f);
          bs[r * DC + dd] = dd < live ? b_gl[(size_t)r * D + c0 + dd] : P(0.f);
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
        const P* as = reinterpret_cast<const P*>(sp + 2 * G::XB) + 16 * warp * R;
        const P* bs = reinterpret_cast<const P*>(sp + 2 * G::XB + G::SB) + 16 * warp;
        uint32_t xa[MT][4], ga[MT][4];
        const int mj = lane >> 3;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int row = mt * 16 + (mj & 1) * 8 + (lane & 7), c = 2 * warp + (mj >> 1);
          tc::ldmatrix_x4(xa[mt], xs + wide(row, c));
          tc::ldmatrix_x4(ga[mt], gs + wide(row, c));
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
              bv[u] = to_f<P>(bs[r * DC + dd]);
            }
          }
          const uint32_t a0 = tc::pack_bf16(av[0], av[1]), a1 = tc::pack_bf16(av[2], av[3]);
          const uint32_t b0 = tc::pack_bf16(bv[0], bv[1]), b1 = tc::pack_bf16(bv[2], bv[3]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma_bf16(acc_z[mt][j], xa[mt], a0, a1);
            tc::mma_bf16(acc_g[mt][j], ga[mt], b0, b1);
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
  for (int which = 0; which < 2; ++which) {
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
    bf16* dst = (which ? gz : z) + ((size_t)l * m_pad + p0) * RP;
    for (int e = tid; e < n_pos * RP; e += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(size_t)w * MT * 16 * RP + e];
      dst[e] = __float2bfloat16_rn(s);
    }
    __syncthreads();
  }
}

// Pass 2 geometry: LG layers a block (4 at R <= 8, 2 at R <= 16, else 1),
// so g's rows are staged once for LG layers; a stage holds g's 16 rows and,
// per layer, x's 16 rows ([16][DC] bf16 each) and z's and gz's ([16][ZW]).
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

// pass 2: for slot n = blockIdx.x, layers l0 = blockIdx.y * LG .. and
// columns blockIdx.z * DC.., gA[n, l, d, :] = sum_p x[l, row(p), d] gz[l, p, :]
// and gB[n, l, :, d] = sum_p g[row(p), d] z[l, p, :] over the slot's grouped
// positions p, 16 at a time in order.
template <int NT>
__global__ void __launch_bounds__(THREADS)
outer_tc(const bf16* __restrict__ x, const bf16* __restrict__ g, const bf16* __restrict__ z,
         const bf16* __restrict__ gz, const int* __restrict__ row_src, const int* __restrict__ tile_slot,
         float* __restrict__ ga, float* __restrict__ gb, int L, int M, int D, int R, int tm, int n_tiles,
         int vec) {
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
  if (tid == 0) {
    range[0] = gss::lower_bound(tile_slot, n_tiles, n);
    range[1] = gss::lower_bound(tile_slot, n_tiles, n + 1);
  }
  __syncthreads();
  const int p_lo = range[0] * tm, p_hi = range[1] * tm;
  const int nsteps = (p_hi - p_lo + 15) / 16;
  const size_t m_pad = (size_t)n_tiles * tm;

  auto issue = [&](int step, int st) {
    bf16* gs = sm + st * G::STAGE;
    {   // g, then x of each layer: 16 rows x 16 chunks, one chunk of each per thread
      const int row = tid >> 4, c = tid & 15, p = p_lo + 16 * step + row;
      const int ri = p < p_hi ? row_src[p] : -1;
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
      const bool ok = p < p_hi && row_src[p] >= 0;   // padding positions read as zeros
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

template <typename P, int NT>
int run_nt(const bf16* x, const bf16* g, const P* a, const P* b, const int* row_src, const int* tile_slot,
           bf16* z, bf16* gz, float* ga, float* gb, int L, int M, int D, int R, int tm, int n_tiles,
           int n_slots, cudaStream_t s) {
  using G = P1<P, NT>;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = D % 8 == 0 && aligned(x) && aligned(g) && aligned(a) && aligned(b);
  const int m_pad = n_tiles * tm;
  cudaError_t err = cudaFuncSetAttribute(project_tc<P, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((m_pad + G::MT * 16 - 1) / (G::MT * 16), L);
  project_tc<P, NT><<<grid1, THREADS, G::SMEM, s>>>(x, g, a, b, row_src, tile_slot, z, gz, L, M, D, R, tm,
                                                     m_pad, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  using G2 = P2<NT>;
  err = cudaFuncSetAttribute(outer_tc<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G2::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(n_slots, (L + G2::LG - 1) / G2::LG, (D + DC - 1) / DC);
  outer_tc<NT><<<grid2, THREADS, G2::SMEM, s>>>(x, g, z, gz, row_src, tile_slot, ga, gb, L, M, D, R, tm,
                                                 n_tiles, vec);
  return (int)cudaGetLastError();
}

// z, gz: (L, n_tiles * tm, RP) bf16 scratch, RP = 8 * NT with NT = ceil(R / 8)
// rounded up to a power of two.
template <typename P>
int backward(const bf16* x, const bf16* g, const P* a, const P* b, const int* row_src,
             const int* tile_slot, bf16* z, bf16* gz, float* ga, float* gb, int L, int M, int D, int R,
             int tm, int n_tiles, int n_slots, cudaStream_t s) {
  if (gss::bad_geometry(L, D, R, tm, n_tiles) || M < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  if (R <= 8) return run_nt<P, 1>(x, g, a, b, row_src, tile_slot, z, gz, ga, gb, L, M, D, R, tm, n_tiles, n_slots, s);
  if (R <= 16) return run_nt<P, 2>(x, g, a, b, row_src, tile_slot, z, gz, ga, gb, L, M, D, R, tm, n_tiles, n_slots, s);
  if (R <= 32) return run_nt<P, 4>(x, g, a, b, row_src, tile_slot, z, gz, ga, gb, L, M, D, R, tm, n_tiles, n_slots, s);
  return run_nt<P, 8>(x, g, a, b, row_src, tile_slot, z, gz, ga, gb, L, M, D, R, tm, n_tiles, n_slots, s);
}

}  // namespace gbw

extern "C" int grouped_skip_sum_bwd(
    const void* x,            // (L, M, D) fp32 or bf16, original row order
    const void* g,            // (M, D), type of x
    const void* a_pool,       // (N, L, D, R) fp32 or bf16
    const void* b_pool,       // (N, L, R, D), same type as a_pool
    const int* row_src,       // (n_tiles * tm,) original row or -1
    const int* tile_slot,     // (n_tiles,) slot of each row tile, non-decreasing
    void* z,                  // scratch: (L, n_tiles * tm, R) fp32 for fp32 x,
    void* gz,                 //   (L, n_tiles * tm, RP) bf16 for bf16 x (see gbw::backward)
    float* ga,                // (N, L, D, R)
    float* gb,                // (N, L, R, D)
    int L, int M, int D, int R, int tm, int n_tiles, int n_slots,
    int x_bf16, int pool_bf16, void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    const bf* xt = static_cast<const bf*>(x);
    const bf* gt = static_cast<const bf*>(g);
    bf* zt = static_cast<bf*>(z);
    bf* gzt = static_cast<bf*>(gz);
    if (pool_bf16)
      return gbw::backward<bf>(xt, gt, (const bf*)a_pool, (const bf*)b_pool, row_src, tile_slot, zt, gzt, ga,
                               gb, L, M, D, R, tm, n_tiles, n_slots, s);
    return gbw::backward<float>(xt, gt, (const float*)a_pool, (const float*)b_pool, row_src, tile_slot, zt,
                                gzt, ga, gb, L, M, D, R, tm, n_tiles, n_slots, s);
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
