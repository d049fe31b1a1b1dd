// Skip-LoRA sums with bf16 products on Hopper's tensor cores (sm_90a): the
// passes shared by K2 (skip_lora_bwd.cu, one adapter stack), the grouped
// forwards K5 (grouped_skip_sum_fwd.cu, float pool), K6
// (grouped_skip_sum_fwd_int8.cu, int8 pool), K7 (grouped_skip_sum_fwd_q4.cu,
// packed 4-bit pool) and K8 (grouped_skip_sum_fwd_actint8.cu, int8 rows), K1
// (skip_lora_fwd.cu, bf16 rows and one adapter stack: K5's one-slot form),
// K3 (skip_lora_fwd_int8.cu, int8 rows and one adapter stack: K8's one-slot
// form) and K9 (grouped_skip_sum_bwd.cu, per-slot gradients). Every product
// is an M x n x K matrix product in bf16 with fp32 sums, the rank (padded to
// whole 8-wide n-tiles) as n: exactly `mma.sync` m16n8k16 (mma.cuh), fed from
// tiles that 16-byte `cp.async` copies bring into a ring of shared-memory
// stages. Casts sit where the reference puts them
// (src/repro/kernels/skip_lora/kernel.py): rows and adapters are cast to
// bf16 before use, z = x A and gz = g B^T are rounded to bf16 between the
// two products, sums are fp32.
//
// What feeds the passes is a compile-time policy, so the eight kernels share
// one body:
//   rows (project_tc's A operand): `Bf16Rows`, fragments by `ldmatrix`; or
//     `Int8Rows` (K8, K3), int8 rows with an fp32 scale per (layer, row),
//     each fragment element built as bf16(float(q) s), the reference's
//     `(q.astype(f32) * s).astype(bf16)`: x crosses device memory once, as
//     int8.
//   pool (A slabs and B rows): `FloatPool<P>` (fp32 or bf16; K1's and K3's
//     one stack is a pool of one slot); `Int8Pool` (K6), the int8 payload and its fp32
//     scales copied as they are and each element dequantised as
//     bf16(float(q) scale) where it becomes a fragment; or `Q4Pool` (K7), the
//     packed 4-bit payload and its fp32 scales likewise, each element
//     bf16(code[nibble] scale), the 16-entry codebook staged in shared memory
//     once a block.
//
// What bounds these sums on this card: bytes. At the main path's shapes
// (L 24, M 1024, D 2048, R 8, bf16 rows) x is 100.7 MB and the adapters a
// few MB, against under 2 GFLOP: a few us on the bf16 tensor cores. So
// each pass reads x in whole row segments, shares every adapter slab across
// the block's rows, and sums in one fixed order (the same bits on every run,
// no atomics).
//
//   project_tc (z, and gz for K9 and K2), one block per (16 MT grouped
//     positions, one layer), 8 warps: D streams in DC-column chunks, the
//     positions' rows gathered through `row_src` (-1 gives a zero row; null:
//     position p is row p), and the slab of the positions' slot
//     (`tile_slot`, non-decreasing; null: slot 0). Warp w takes columns
//     16 w .. 16 w + 15 of each chunk; the warps' partial fragments are
//     summed through shared memory in warp order, rounded to bf16 and stored
//     at (l, p, r) -> l * z_ls + p * z_ps + r, so K9 and K2 keep an
//     (L, M_pad, RP) scratch and the grouped forwards an (M_pad, L RP) one,
//     k = l RP + r. A block takes its positions' slots one at a time. g
//     (4 MB at the main path's shapes) is read once a layer, from L2: a
//     separate pass forming gz for all layers from one read of g (tried for
//     K2) took longer than gz beside z does (PERF.md, findings).
//   expand_tc (the grouped forwards), one block per (16 MT grouped
//     positions, CW columns of D): out = bf16(sum_k z[p, k] bf16(B[slot, k, :])),
//     z as the A operand in k order, the slot's B stack (L R rows of D)
//     staged 32 rows of k a stage; the rows go straight back to their
//     original positions through `row_src`. Slots as in project_tc.
//   outer_tc (K9, K2), one block per (slot or M chunk, LG layers, DC
//     columns): gA = x^T gz and gB^T = g^T z over the block's positions in
//     order, 16 at a time; `ldmatrix.trans` gives x^T and g^T. K9 finds its
//     slot's run by binary search in `tile_slot`; K2 (null `tile_slot`)
//     takes rows [n chunk, (n + 1) chunk) and writes one fp32 partial per
//     chunk, which a last pass adds in chunk order.
//
// Two geometries for the grouped forwards, picked by the wrapper
// (kernel.py, grouped_fwd_geometry) from the number of rows and of grouped
// positions:
//   many rows: project_tc blocks of 32 consecutive positions (16 at R > 16),
//     expand_tc blocks of 64 positions x 128 columns, so each slab and B row
//     is shared by many rows. A block spanning several slots takes one round
//     a slot.
//   few rows (at least a quarter of the grouped positions padding, so few
//     row tiles a slot, as at a decode step: one row a slot, or up to about
//     48 rows a slot): each block takes 16 positions of one row
//     tile, so one slot and one round, and expand_tc 64 columns, so both
//     grids cover the card's 132 SMs where the many-row geometry ran 16 to 72
//     blocks of up to four rounds each.
// Each position's sums run in the same k order in both (over D in DC chunks,
// the warps' partials in warp order; then over k = l RP + r), and the other
// slots' rounds add exact zeros, so the two geometries give the same bits.
//
// D not a multiple of 8 (16 for int8 rows or an int8 pool, 32 for a 4-bit
// pool), or pointers not 16-byte aligned, take plain loads into the same
// shared-memory layouts.
// fp32 rows never come here: the tensor cores' fp32 input is TF32 (about
// three decimal digits), which would break the float32 cases' 1e-5 bar; they
// stay on CUDA cores (skip_sum.cuh, grouped_skip_sum.cuh).

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
constexpr int DC = 16 * WARPS;   // columns of D a project / outer stage takes, 16 per warp
constexpr int R_MAX = 64;        // highest rank (by_rank)

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

// The grouped positions [p0, p0 + n) of block b: `per` consecutive positions
// a block (many rows, bpt 0), or 16 positions of row tile b / bpt from
// 16 (b % bpt) on (few rows: bpt = ceil(tm / 16) blocks a tile).
struct Span {
  int p0, n;
};
__device__ __forceinline__ Span block_span(int b, int per, int bpt, int tm, int m_pad) {
  if (bpt) {
    const int t = b / bpt, h = b % bpt;
    return {t * tm + 16 * h, min(16, tm - 16 * h)};
  }
  return {b * per, min(per, m_pad - b * per)};
}

// ---------------------------------------------------------------------------
// Row loaders (project_tc's A operand): a chunk of DC columns of the block's
// rows into shared memory, CPR 16-byte copies a row, then this warp's A
// fragments (rows 16 mt .., columns 16 warp ..) from it.
// ---------------------------------------------------------------------------

// bf16 rows: [rows][DC] bf16 XOR-swizzled by `wide`, fragments by ldmatrix.
struct Bf16Rows {
  const bf16* x;   // (L, M, D)
  static constexpr int CPR = DC / 8;
  __host__ __device__ static constexpr int tile_bytes(int rows) { return rows * DC * 2; }
  bool vec_ok(int D) const { return D % 8 == 0 && aligned16(x); }
  __device__ __forceinline__ float scale(int, int, int) const { return 1.f; }
  // chunk c of tile row `row`: row ri of layer l (ri < 0: zeros) from column c0 + 8 c
  __device__ __forceinline__ void load(unsigned char* tile, int row, int c, int l, int ri, int c0, int M, int D,
                                       bool vec) const {
    load8(reinterpret_cast<bf16*>(tile) + wide(row, c), x + (size_t)l * M * D, x, ri, c0 + 8 * c, D, vec);
  }
  __device__ __forceinline__ void frag(uint32_t (&a)[4], const unsigned char* tile, const float*, int mt,
                                       int warp, int lane) const {
    const int mj = lane >> 3;
    const int row = mt * 16 + (mj & 1) * 8 + (lane & 7), c = 2 * warp + (mj >> 1);
    tc::ldmatrix_x4(a, reinterpret_cast<const bf16*>(tile) + wide(row, c));
  }
};

// int8 rows with an fp32 scale per (layer, row) (K8, K3): [rows][DC + 16] bytes,
// each row padded by 16 bytes so a warp's 2-byte fragment loads hit
// distinct banks; the block's row scales are staged once (`scale`), and each
// fragment element is bf16(float(q) s) (mma.cuh gives the fragment layout).
struct Int8Rows {
  const int8_t* q;   // (L, M, D)
  const float* s;    // (L, M)
  static constexpr int CPR = DC / 16;
  static constexpr int ROW = DC + 16;
  __host__ __device__ static constexpr int tile_bytes(int rows) { return rows * ROW; }
  bool vec_ok(int D) const { return D % 16 == 0 && aligned16(q); }
  __device__ __forceinline__ float scale(int l, int ri, int M) const {
    return ri >= 0 ? s[(size_t)l * M + ri] : 0.f;
  }
  __device__ __forceinline__ void load(unsigned char* tile, int row, int c, int l, int ri, int c0, int M, int D,
                                       bool vec) const {
    int8_t* dst = reinterpret_cast<int8_t*>(tile) + row * ROW + 16 * c;
    const int col = c0 + 16 * c;
    if (vec) {
      const bool ok = ri >= 0 && col < D;
      tc::cp_async16(dst, ok ? q + ((size_t)l * M + ri) * D + col : q, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        dst[i] = (ri >= 0 && col + i < D) ? q[((size_t)l * M + ri) * D + col + i] : int8_t(0);
    }
  }
  __device__ __forceinline__ void frag(uint32_t (&a)[4], const unsigned char* tile, const float* rsc, int mt,
                                       int warp, int lane) const {
    const int r0 = mt * 16 + (lane >> 2), col = 16 * warp + 2 * (lane & 3);
    const int8_t* t = reinterpret_cast<const int8_t*>(tile);
    auto two = [&](int r, int cc) {
      const char2 v = *reinterpret_cast<const char2*>(t + r * ROW + cc);
      return tc::pack_bf16((float)v.x * rsc[r], (float)v.y * rsc[r]);
    };
    a[0] = two(r0, col);
    a[1] = two(r0 + 8, col);
    a[2] = two(r0, col + 8);
    a[3] = two(r0 + 8, col + 8);
  }
};

// ---------------------------------------------------------------------------
// Pools: the A slab of project_tc (rows c0.. of A[slot, l], (D, R)), the B
// slab of its gz (R rows of DC columns, float pools only) and the B rows of
// expand_tc (KC rows of CW columns, each row padded by 16 bytes), and each
// element's value before its cast to bf16. `stage_code` puts the 4-bit
// codebook in shared memory (`cs`, the accessors' argument); the float and
// int8 pools have none.
// ---------------------------------------------------------------------------

template <typename P> struct FloatPool {
  const P* A;   // (N, L, D, R)
  const P* B;   // (N, L, R, D)
  static constexpr int E = (int)sizeof(P);
  template <int RP> __host__ __device__ static constexpr int slab_bytes() { return DC * RP * E; }
  __host__ __device__ static constexpr int b_row(int cw) { return cw * E + 16; }
  __host__ __device__ static constexpr int b_extra(int) { return 0; }
  bool vec_ok(int D) const { return D % 8 == 0 && aligned16(A) && aligned16(B); }
  __device__ __forceinline__ void stage_code(float*) const {}

  // slab[dd * R + r] = A[gl][c0 + dd][r] (zeros past `live` columns)
  template <int RP>
  __device__ __forceinline__ void issue_a(unsigned char* slab, size_t gl, int c0, int live, int D, int R, bool vec,
                                          int tid) const {
    const P* a_gl = A + gl * D * R;
    if (vec) {   // rows c0.. of (D, R) are contiguous, DC R elements
      const char* src = reinterpret_cast<const char*>(a_gl + (size_t)c0 * R);
      for (int e = tid; e < DC * R * E / 16; e += THREADS) {
        const bool ok = e * 16 < live * R * E;
        tc::cp_async16(slab + e * 16, ok ? src + e * 16 : src, ok ? 16 : 0);
      }
    } else {
      P* as = reinterpret_cast<P*>(slab);
      for (int e = tid; e < DC * R; e += THREADS) {
        const int dd = e / R, r = e % R;
        as[e] = dd < live ? a_gl[(size_t)(c0 + dd) * R + r] : P(0.f);
      }
    }
  }
  template <int RP>
  __device__ __forceinline__ float a_at(const unsigned char* slab, const float*, int dd, int r, int R) const {
    return to_f<P>(reinterpret_cast<const P*>(slab)[dd * R + r]);
  }

  // slab[r * DC + dd] = B[gl][r][c0 + dd]
  __device__ __forceinline__ void issue_bt(unsigned char* slab, size_t gl, int c0, int live, int D, int R, bool vec,
                                           int tid) const {
    const P* b_gl = B + gl * R * D;
    P* bs = reinterpret_cast<P*>(slab);
    if (vec) {
      constexpr int CPR = DC * E / 16;   // 16-byte chunks of a row, 16 / E elements each
      for (int e = tid; e < R * CPR; e += THREADS) {
        const int r = e / CPR, col = (e % CPR) * (16 / E);
        const bool ok = col < live;
        tc::cp_async16(bs + r * DC + col, ok ? b_gl + (size_t)r * D + c0 + col : b_gl, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < DC * R; e += THREADS) {
        const int dd = e / R, r = e % R;
        bs[r * DC + dd] = dd < live ? b_gl[(size_t)r * D + c0 + dd] : P(0.f);
      }
    }
  }
  __device__ __forceinline__ float bt_at(const unsigned char* slab, int dd, int r) const {
    return to_f<P>(reinterpret_cast<const P*>(slab)[r * DC + dd]);
  }

  // B row k0 + row of the slot's stack (k = l RP + r; zeros for r >= R and
  // k >= L RP), columns dc0 .. dc0 + CW, at st + row * b_row(CW)
  template <int CW, int KC, int RP>
  __device__ __forceinline__ void issue_b(unsigned char* st, int slot, int k0, int dc0, int L, int D, int R, bool vec,
                                          int tid) const {
    constexpr int CPR = CW * E / 16, BR = b_row(CW);
    for (int e = tid; e < KC * CPR; e += THREADS) {
      const int row = e / CPR, col = (e % CPR) * (16 / E);
      const int k = k0 + row, l = k / RP, r = k % RP;
      const bool ok = k < L * RP && r < R;
      const P* src = B + (((size_t)slot * L + l) * R + r) * D + dc0 + col;
      P* dst = reinterpret_cast<P*>(st + row * BR) + col;
      if (vec) {
        const bool okc = ok && dc0 + col < D;
        tc::cp_async16(dst, okc ? src : B, okc ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 16 / E; ++i) dst[i] = ok && dc0 + col + i < D ? src[i] : P(0.f);
      }
    }
  }
  template <int CW, int KC>
  __device__ __forceinline__ float b_at(const unsigned char* st, const float*, int row, int col) const {
    return to_f<P>(*reinterpret_cast<const P*>(st + row * b_row(CW) + col * E));
  }
};

// int8 pool (K6): QA (N, L, D, R) and QB (N, L, R, D) int8 with fp32 scales
// over the last axis, SA (N, L, D) and SB (N, L, R): Q4Pool's layout with
// whole bytes and no codebook. An A slab is DC rows of R bytes then their DC
// scales; a B stage KC rows of CW bytes, each padded by 16, then their KC
// scales. Each element is float(q) s, which the passes round to bf16: the
// reference's `(q.astype(f32) * s).astype(bf16)`. At R 8 two A rows share a
// 16-byte chunk; a warp's byte loads at one fragment position (dd = 16 w +
// 2 tig + .., r = 8 j + grp) span 64 contiguous bytes at R 8 and 128 at
// R 16, so lanes hit distinct banks or share a word; above R 16 up to four
// lanes meet in a bank, as in the float pool.
struct Int8Pool {
  const int8_t* QA;
  const float* SA;
  const int8_t* QB;
  const float* SB;
  template <int RP> __host__ __device__ static constexpr int slab_bytes() { return DC * RP + DC * 4; }
  __host__ __device__ static constexpr int b_row(int cw) { return cw + 16; }
  __host__ __device__ static constexpr int b_extra(int kc) { return kc * 4; }
  bool vec_ok(int D) const {
    return D % 16 == 0 && aligned16(QA) && aligned16(SA) && aligned16(QB) && aligned16(SB);
  }
  __device__ __forceinline__ void stage_code(float*) const {}

  template <int RP>
  __device__ __forceinline__ void issue_a(unsigned char* slab, size_t gl, int c0, int live, int D, int R, bool vec,
                                          int tid) const {
    const int8_t* src = QA + (gl * D + c0) * R;
    const float* ss = SA + gl * D + c0;
    float* sc = reinterpret_cast<float*>(slab + DC * RP);
    if (vec) {   // live is a multiple of 16, so live R bytes are whole 16-byte chunks
      for (int e = tid; e < (DC * R + 15) / 16; e += THREADS) {
        const bool ok = 16 * e < live * R;
        tc::cp_async16(slab + 16 * e, ok ? src + 16 * e : QA, ok ? 16 : 0);
      }
      for (int e = tid; e < DC / 4; e += THREADS) {
        const bool ok = 4 * e < live;
        tc::cp_async16(sc + 4 * e, ok ? ss + 4 * e : SA, ok ? 16 : 0);
      }
    } else {
      int8_t* as = reinterpret_cast<int8_t*>(slab);
      for (int e = tid; e < DC * R; e += THREADS) as[e] = e < live * R ? src[e] : int8_t(0);
      for (int e = tid; e < DC; e += THREADS) sc[e] = e < live ? ss[e] : 0.f;
    }
  }
  template <int RP>
  __device__ __forceinline__ float a_at(const unsigned char* slab, const float*, int dd, int r, int R) const {
    return (float)reinterpret_cast<const int8_t*>(slab)[dd * R + r] *
           reinterpret_cast<const float*>(slab + DC * RP)[dd];
  }

  template <int CW, int KC, int RP>
  __device__ __forceinline__ void issue_b(unsigned char* st, int slot, int k0, int dc0, int L, int D, int R, bool vec,
                                          int tid) const {
    constexpr int CPR = CW / 16, BR = b_row(CW);   // 16-byte chunks (16 columns) of a row
    for (int e = tid; e < KC * CPR; e += THREADS) {
      const int row = e / CPR, cb = (e % CPR) * 16, col = dc0 + cb;
      const int k = k0 + row, l = k / RP, r = k % RP;
      const bool ok = k < L * RP && r < R;
      const int8_t* src = QB + (((size_t)slot * L + l) * R + r) * D + col;
      int8_t* dst = reinterpret_cast<int8_t*>(st + row * BR + cb);
      if (vec) {
        const bool okc = ok && col < D;
        tc::cp_async16(dst, okc ? src : QB, okc ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) dst[i] = ok && col + i < D ? src[i] : int8_t(0);
      }
    }
    float* sc = reinterpret_cast<float*>(st + KC * BR);
    for (int e = tid; e < KC; e += THREADS) {
      const int k = k0 + e, l = k / RP, r = k % RP;
      const bool ok = k < L * RP && r < R;
      const float* src = SB + ((size_t)slot * L + l) * R + r;
      if (vec) {
        tc::cp_async4(sc + e, ok ? src : SB, ok ? 4 : 0);
      } else {
        sc[e] = ok ? *src : 0.f;
      }
    }
  }
  template <int CW, int KC>
  __device__ __forceinline__ float b_at(const unsigned char* st, const float*, int row, int col) const {
    return (float)reinterpret_cast<const int8_t*>(st)[row * b_row(CW) + col] *
           reinterpret_cast<const float*>(st + KC * b_row(CW))[row];
  }
};

// Packed 4-bit pool (K7): two codebook indices a byte along the last axis,
// the even position in the low nibble: QA (N, L, D, R/2), QB (N, L, R, D/2),
// fp32 scales SA (N, L, D) and SB (N, L, R) over the last axis. An A slab is
// DC (R/2)-byte rows then its DC scales; a B stage KC rows of CW/2 bytes then
// their KC scales. A slot whose scales are 0 dequantises to exact zeros.
struct Q4Pool {
  const uint8_t* QA;
  const float* SA;
  const uint8_t* QB;
  const float* SB;
  const float* code;   // (16,) in device memory, staged into shared memory once a block
  template <int RP> __host__ __device__ static constexpr int slab_bytes() { return DC * RP / 2 + DC * 4; }
  __host__ __device__ static constexpr int b_row(int cw) { return cw / 2 + 16; }
  __host__ __device__ static constexpr int b_extra(int kc) { return kc * 4; }
  bool vec_ok(int D) const {
    return D % 32 == 0 && aligned16(QA) && aligned16(SA) && aligned16(QB) && aligned16(SB);
  }
  __device__ __forceinline__ void stage_code(float* sm) const {
    if (threadIdx.x < 16) sm[threadIdx.x] = code[threadIdx.x];
  }
  __device__ __forceinline__ static float lookup(const float* cs, unsigned byte, int odd) {
    return cs[odd ? byte >> 4 : byte & 15u];
  }

  template <int RP>
  __device__ __forceinline__ void issue_a(unsigned char* slab, size_t gl, int c0, int live, int D, int R, bool vec,
                                          int tid) const {
    const int hb = R / 2;   // bytes of an A row
    const uint8_t* src = QA + (gl * D + c0) * hb;
    const float* ss = SA + gl * D + c0;
    float* sc = reinterpret_cast<float*>(slab + DC * RP / 2);
    if (vec) {
      const int nb = live * hb;
      for (int e = tid; e < (DC * hb + 15) / 16; e += THREADS) {
        const int rem = min(16, nb - 16 * e);
        tc::cp_async16(slab + 16 * e, rem > 0 ? src + 16 * e : QA, max(rem, 0));
      }
      for (int e = tid; e < DC / 4; e += THREADS) {
        const int rem = min(16, 4 * (live - 4 * e));
        tc::cp_async16(sc + 4 * e, rem > 0 ? ss + 4 * e : SA, max(rem, 0));
      }
    } else {
      for (int e = tid; e < DC * hb; e += THREADS) slab[e] = e < live * hb ? src[e] : uint8_t(0);
      for (int e = tid; e < DC; e += THREADS) sc[e] = e < live ? ss[e] : 0.f;
    }
  }
  template <int RP>
  __device__ __forceinline__ float a_at(const unsigned char* slab, const float* cs, int dd, int r, int R) const {
    return lookup(cs, slab[dd * (R >> 1) + (r >> 1)], r & 1) *
           reinterpret_cast<const float*>(slab + DC * RP / 2)[dd];
  }

  template <int CW, int KC, int RP>
  __device__ __forceinline__ void issue_b(unsigned char* st, int slot, int k0, int dc0, int L, int D, int R, bool vec,
                                          int tid) const {
    constexpr int CPR = CW / 32, BR = b_row(CW);   // 16-byte chunks (32 columns) of a row
    for (int e = tid; e < KC * CPR; e += THREADS) {
      const int row = e / CPR, cb = (e % CPR) * 16, col = dc0 + 2 * cb;
      const int k = k0 + row, l = k / RP, r = k % RP;
      const bool ok = k < L * RP && r < R;
      const uint8_t* src = QB + (((size_t)slot * L + l) * R + r) * (D / 2) + col / 2;
      unsigned char* dst = st + row * BR + cb;
      if (vec) {
        const bool okc = ok && col < D;
        tc::cp_async16(dst, okc ? src : QB, okc ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) dst[i] = ok && col + 2 * i < D ? src[i] : uint8_t(0);
      }
    }
    float* sc = reinterpret_cast<float*>(st + KC * BR);
    for (int e = tid; e < KC; e += THREADS) {
      const int k = k0 + e, l = k / RP, r = k % RP;
      const bool ok = k < L * RP && r < R;
      const float* src = SB + ((size_t)slot * L + l) * R + r;
      if (vec) {
        tc::cp_async4(sc + e, ok ? src : SB, ok ? 4 : 0);
      } else {
        sc[e] = ok ? *src : 0.f;
      }
    }
  }
  template <int CW, int KC>
  __device__ __forceinline__ float b_at(const unsigned char* st, const float* cs, int row, int col) const {
    return lookup(cs, st[row * b_row(CW) + (col >> 1)], col & 1) *
           reinterpret_cast<const float*>(st + KC * b_row(CW))[row];
  }
};

// ---------------------------------------------------------------------------
// project_tc
// ---------------------------------------------------------------------------

// A block takes 16 MT grouped positions and streams D in chunks of DC
// columns: each chunk's rows (and g's, WITH_G: bf16 rows only) and one
// slot's A slab (and B's) in one stage.
template <typename Rows, typename Pool, int NT, bool WITH_G, int MT_> struct P1 {
  static_assert(!WITH_G || std::is_same<Rows, Bf16Rows>::value, "gz takes bf16 rows");
  static constexpr int MT = MT_;
  static constexpr int RP = 8 * NT;
  static constexpr int NX = WITH_G ? 2 : 1;
  static constexpr int XB = Rows::tile_bytes(MT * 16);           // bytes of one row chunk
  static constexpr int SB = Pool::template slab_bytes<RP>();     // bytes of one slab, at most
  static constexpr int STAGE = NX * (XB + SB);
  static constexpr int STAGES = WITH_G ? (NT <= 2 ? 3 : 2) : (NT <= 2 ? 4 : 3);
  static constexpr size_t RING = (size_t)STAGES * STAGE;
  static constexpr size_t RED = (size_t)WARPS * MT * 16 * RP * sizeof(float);
  static constexpr size_t SMEM = RING > RED ? RING : RED;
  // blocks an SM for the launch bound: as many as the SM's 227 KB hold, at most 3
  static constexpr int MIN_BLOCKS = WITH_G ? 1 : (SMEM * 3 <= 232448 ? 3 : 2);
  static_assert(XB % 16 == 0 && SB % 16 == 0, "16-byte aligned stage parts");
};
// project_tc's rows a block at many rows: 32 positions at R <= 16, else 16
template <int NT> constexpr int many_mt() { return NT <= 2 ? 2 : 1; }

// z[l, p, :] = bf16(x[l, row(p)] bf16(A[slot(p), l])) and, WITH_G, gz likewise
// with g and bf16(B[slot(p), l])^T, for the block's grouped positions p
// (block_span). The slots of those positions are non-decreasing; the block
// takes them one at a time, each round streaming the rows of that slot (the
// others read as zeros) and its slabs.
template <typename Rows, typename Pool, int NT, bool WITH_G, int MT_>
__global__ void __launch_bounds__(THREADS, P1<Rows, Pool, NT, WITH_G, MT_>::MIN_BLOCKS)
project_tc(const Rows rows, const bf16* __restrict__ g, const Pool pool, const int* __restrict__ row_src,
           const int* __restrict__ tile_slot, bf16* __restrict__ z, bf16* __restrict__ gz, int L, int M, int D,
           int R, int tm, int m_pad, int bpt, size_t z_ls, size_t z_ps, int vec) {
  using G = P1<Rows, Pool, NT, WITH_G, MT_>;
  constexpr int MT = G::MT, RP = G::RP, STAGES = G::STAGES;
  // This thread copies chunk tid % CPR of rows tid / CPR + RPP i.
  constexpr int CPR = Rows::CPR, RPP = THREADS / CPR, NP = (MT * 16 + RPP - 1) / RPP;
  static_assert(THREADS % CPR == 0 && (!WITH_G || CPR == 16), "whole rows a pass");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float rsc[MT * 16];   // the rows' scales (int8 rows)
  __shared__ float code_s[16];     // the pool's codebook (4-bit pool)
  pool.stage_code(code_s);
  const Span span = block_span(blockIdx.x, MT * 16, bpt, tm, m_pad);
  const int p0 = span.p0, l = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int cc = tid % CPR;
  const bool vc = vec != 0;

  int ri[NP], sl[NP];
  bool any = false;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int row = tid / CPR + RPP * i, p = p0 + row;
    const bool live = row < span.n;
    ri[i] = live ? row_at(row_src, p, m_pad) : -1;
    sl[i] = live ? slot_at(tile_slot, p / tm) : -1;
    any |= ri[i] >= 0;
    if (cc == 0 && row < MT * 16) rsc[row] = rows.scale(l, ri[i], M);
  }
  if (!__syncthreads_or(any)) return;   // no live rows: nothing reads these positions
  const int s_lo = slot_at(tile_slot, p0 / tm);
  const int s_hi = slot_at(tile_slot, (p0 + span.n - 1) / tm);
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
    int rs[NP];   // this round's rows: the slot's, the others read as zeros
    bool mine = false;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      rs[i] = sl[i] == slot ? ri[i] : -1;
      mine |= rs[i] >= 0;
    }
    if (!__syncthreads_or(mine)) continue;
    const size_t gl = (size_t)slot * L + l;

    auto issue = [&](int kc, int st) {
      const int c0 = kc * DC, live = min(DC, D - c0);
      unsigned char* sp = stage_ptr(st);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int row = tid / CPR + RPP * i;
        if (row < MT * 16) {
          rows.load(sp, row, cc, l, rs[i], c0, M, D, vc);
          if constexpr (WITH_G) load8(reinterpret_cast<bf16*>(sp + G::XB) + wide(row, cc), g, g, rs[i], c0 + 8 * cc, D, vc);
        }
      }
      pool.template issue_a<RP>(sp + G::NX * G::XB, gl, c0, live, D, R, vc, tid);
      if constexpr (WITH_G) pool.issue_bt(sp + G::NX * G::XB + G::SB, gl, c0, live, D, R, vc, tid);
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
        const unsigned char* as = sp + G::NX * G::XB;
        uint32_t xa[MT][4], ga[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          rows.frag(xa[mt], sp, rsc, mt, warp, lane);
          if constexpr (WITH_G) Bf16Rows{g}.frag(ga[mt], sp + G::XB, rsc, mt, warp, lane);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int r = 8 * j + grp;
          float av[4] = {0.f, 0.f, 0.f, 0.f}, bv[4] = {0.f, 0.f, 0.f, 0.f};
          if (r < R) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int dd = 16 * warp + 2 * tig + (u & 1) + (u >> 1) * 8;
              av[u] = pool.template a_at<RP>(as, code_s, dd, r, R);
              if constexpr (WITH_G) bv[u] = pool.bt_at(as + G::SB, dd, r);
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
    for (int e = tid; e < span.n * RP; e += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(size_t)w * MT * 16 * RP + e];
      dst[(size_t)(e / RP) * z_ps + e % RP] = __float2bfloat16_rn(s);
    }
    __syncthreads();
  }
}

template <int NT, bool WITH_G, int MT, typename Rows, typename Pool>
cudaError_t launch_project(Rows rows, const bf16* g, Pool pool, const int* row_src, const int* tile_slot, bf16* z,
                           bf16* gz, int L, int M, int D, int R, int tm, int m_pad, int bpt, int n_blocks,
                           size_t z_ls, size_t z_ps, int vec, cudaStream_t s) {
  using G = P1<Rows, Pool, NT, WITH_G, MT>;
  auto* kern = project_tc<Rows, Pool, NT, WITH_G, MT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_blocks, L), THREADS, G::SMEM, s>>>(rows, g, pool, row_src, tile_slot, z, gz, L, M, D, R, tm, m_pad,
                                                   bpt, z_ls, z_ps, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// expand_tc (the grouped forwards)
// ---------------------------------------------------------------------------

// A block takes 16 MT grouped positions and CW = 64 NJ columns, warp w the
// NJ 8-wide column tiles from 8 NJ w, and walks k = l RP + r KC at a time:
// the positions' z ([16 MT][ZW] bf16) and the slot's B rows (pool layout,
// rows padded by 16 bytes so ldmatrix and the fragment loads hit distinct
// banks). The output tile goes back through shared memory ([16 MT][OW]
// bf16) so each row leaves in 16-byte stores.
template <typename Pool, int NT, int MT_, int NJ> struct PE {
  static constexpr int RP = 8 * NT;
  static constexpr int MT = MT_, TP = 16 * MT;
  static constexpr int KC = 32;
  static constexpr int ZW = KC + 8;
  static constexpr int CW = 8 * NJ * WARPS;
  static constexpr int ZB = TP * ZW * 2;                       // bytes
  static constexpr int BR = Pool::b_row(CW);
  static constexpr int STAGE = ZB + KC * BR + Pool::b_extra(KC);
  static constexpr int STAGES = 3;
  static constexpr int OW = CW + 8;
  static constexpr size_t RING = (size_t)STAGES * STAGE;
  static constexpr size_t OUT = (size_t)TP * OW * 2;
  static constexpr size_t SMEM = RING > OUT ? RING : OUT;
  static_assert(ZB % 16 == 0 && BR % 16 == 0 && STAGE % 16 == 0, "16-byte aligned stage parts");
};

// out[row(p), d] = bf16(sum_k z[p, k] bf16(B[slot(p), k, d])), z at p * L RP + k,
// the k in order, for the block's positions (block_span) and CW columns. B's
// row k is B[slot, l, r] for r < R and zeros otherwise.
template <typename Pool, int NT, int MT_, int NJ>
__global__ void __launch_bounds__(THREADS)
expand_tc(const bf16* __restrict__ z, const Pool pool, const int* __restrict__ row_src,
          const int* __restrict__ tile_slot, bf16* __restrict__ out, int L, int D, int R, int tm, int m_pad, int bpt,
          int vec) {
  using G = PE<Pool, NT, MT_, NJ>;
  constexpr int RP = G::RP, TP = G::TP, MT = G::MT, KC = G::KC, ZW = G::ZW, CW = G::CW;
  constexpr int STAGES = G::STAGES, OW = G::OW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float code_s[16];   // the pool's codebook (4-bit pool)
  pool.stage_code(code_s);
  const Span span = block_span(blockIdx.x, TP, bpt, tm, m_pad);
  const int p0 = span.p0, dc0 = blockIdx.y * CW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const bool vc = vec != 0;
  const int K = L * RP, nk = (K + KC - 1) / KC;

  // This thread copies chunk tid & 3 of position tid / 4's z row (tid < 4 TP).
  static_assert(TP * KC / 8 <= THREADS, "at most one 16-byte chunk of z a thread");
  const int zrow = tid >> 2, zc = tid & 3, zp = p0 + zrow;
  const bool zlive = zrow < span.n;
  const int ri = zlive ? row_at(row_src, zp, m_pad) : -1;
  const int sl = zlive ? slot_at(tile_slot, zp / tm) : -1;
  if (!__syncthreads_or(ri >= 0)) return;
  const int s_lo = slot_at(tile_slot, p0 / tm), s_hi = slot_at(tile_slot, (p0 + span.n - 1) / tm);
  const int wc0 = 8 * NJ * warp;   // this warp's first column in the block
  const bool live_cols = dc0 + wc0 < D;

  float acc[MT][NJ][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int slot = s_lo; slot <= s_hi; ++slot) {
    const bool mine = sl == slot && ri >= 0;   // this round's positions: the slot's, others read as zeros
    if (!__syncthreads_or(mine)) continue;

    auto issue = [&](int kc, int st) {
      unsigned char* sp = smem_raw + (size_t)st * G::STAGE;
      if (zrow < TP) {
        const int kz = kc * KC + 8 * zc;
        const bool okz = mine && kz < K;
        tc::cp_async16(reinterpret_cast<bf16*>(sp) + zrow * ZW + 8 * zc, okz ? z + (size_t)zp * K + kz : z,
                       okz ? 16 : 0);
      }
      pool.template issue_b<CW, KC, RP>(sp + G::ZB, slot, kc * KC, dc0, L, D, R, vc, tid);
    };

    // One issue site (the first STAGES - 1 turns only fill the ring): an
    // unrolled prologue of its own made the 4-bit pool's few-row build
    // spill.
    for (int i = 1 - STAGES; i < nk; ++i) {
      const int ki = i + STAGES - 1;
      if (ki < nk) issue(ki, ki % STAGES);
      tc::cp_async_commit();
      if (i < 0) continue;
      tc::cp_async_wait<STAGES - 1>();
      __syncthreads();
      if (live_cols) {
        const unsigned char* sp = smem_raw + (size_t)(i % STAGES) * G::STAGE;
        const bf16* zs = reinterpret_cast<const bf16*>(sp);
        const unsigned char* bs = sp + G::ZB;
        const int mj = lane >> 3;
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          uint32_t b0[NJ], b1[NJ];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float bv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              bv[u] = pool.template b_at<CW, KC>(bs, code_s, ks * 16 + 2 * tig + (u & 1) + (u >> 1) * 8,
                                                 wc0 + 8 * j + grp);
            b0[j] = tc::pack_bf16(bv[0], bv[1]);
            b1[j] = tc::pack_bf16(bv[2], bv[3]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t za[4];
            tc::ldmatrix_x4(za, zs + (mt * 16 + (mj & 1) * 8 + (lane & 7)) * ZW + ks * 16 + (mj >> 1) * 8);
#pragma unroll
            for (int j = 0; j < NJ; ++j) tc::mma_bf16(acc[mt][j], za, b0[j], b1[j]);
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
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(os + (mt * 16 + grp + 8 * h) * OW + wc0 + 8 * j + 2 * tig) =
            tc::pack_bf16(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
  __syncthreads();
  for (int e = tid; e < TP * CW / 8; e += THREADS) {
    const int row = e / (CW / 8), c = e % (CW / 8), col = dc0 + 8 * c;
    const int orow = row < span.n ? row_at(row_src, p0 + row, m_pad) : -1;
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

template <int NT, int MT, int NJ, typename Pool>
cudaError_t launch_expand(const bf16* z, Pool pool, const int* row_src, const int* tile_slot, bf16* out, int L, int D,
                          int R, int tm, int m_pad, int bpt, int n_blocks, int vec, cudaStream_t s) {
  using G = PE<Pool, NT, MT, NJ>;
  auto* kern = expand_tc<Pool, NT, MT, NJ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_blocks, (D + G::CW - 1) / G::CW), THREADS, G::SMEM, s>>>(z, pool, row_src, tile_slot, out, L, D, R,
                                                                        tm, m_pad, bpt, vec);
  return cudaGetLastError();
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
  constexpr int RP = 8 * NT, MT = many_mt<NT>();
  const int vec = D % 8 == 0 && aligned16(x) && aligned16(g) && aligned16(a) && aligned16(b);
  const int m_pad = n_tiles * tm;
  cudaError_t err = launch_project<NT, true, MT>(Bf16Rows{x}, g, FloatPool<P>{a, b}, row_src, tile_slot, z, gz, L,
                                                 M, D, R, tm, m_pad, 0, (m_pad + 16 * MT - 1) / (16 * MT),
                                                 (size_t)m_pad * RP, RP, vec, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_outer<NT>(x, g, z, gz, row_src, tile_slot, ga, gb, L, M, D, R, tm, n_tiles, n_blocks, chunk,
                               vec, s);
}

// The grouped forwards with bf16 products (K5, K6 and K7 with bf16 rows, K8),
// and K1 and K3 as one slot (null row_src and tile_slot, tm 1, n_tiles M): z
// (n_tiles * tm, L RP) bf16 scratch, out (M, D) bf16. `few` (kernel.py,
// grouped_fwd_geometry) picks the few-row geometry: 16 positions of one row
// tile a block in both passes, 64 columns an expand block.
template <int NT, typename Rows, typename Pool>
int grouped_forward(Rows rows, Pool pool, const int* row_src, const int* tile_slot, bf16* z, bf16* out, int L, int M,
                    int D, int R, int tm, int n_tiles, int few, cudaStream_t s) {
  constexpr int RP = 8 * NT;
  const int vec = rows.vec_ok(D) && pool.vec_ok(D) && D % 8 == 0 && aligned16(out);
  const int m_pad = n_tiles * tm;
  const size_t z_ps = (size_t)L * RP;
  cudaError_t err;
  if (few) {
    const int bpt = (tm + 15) / 16, blocks = n_tiles * bpt;
    err = launch_project<NT, false, 1>(rows, nullptr, pool, row_src, tile_slot, z, nullptr, L, M, D, R, tm, m_pad,
                                       bpt, blocks, RP, z_ps, vec, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_expand<NT, 1, 1>(z, pool, row_src, tile_slot, out, L, D, R, tm, m_pad, bpt, blocks, vec, s);
  }
  constexpr int MT = many_mt<NT>();
  err = launch_project<NT, false, MT>(rows, nullptr, pool, row_src, tile_slot, z, nullptr, L, M, D, R, tm, m_pad, 0,
                                      (m_pad + 16 * MT - 1) / (16 * MT), RP, z_ps, vec, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_expand<NT, 4, 2>(z, pool, row_src, tile_slot, out, L, D, R, tm, m_pad, 0, (m_pad + 63) / 64, vec,
                                      s);
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
