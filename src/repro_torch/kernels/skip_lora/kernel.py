"""Hopper CUDA kernels for the Skip-LoRA sum, bound with ``ctypes``.

Eight kernels, each a CUDA C++ source under ``csrc/`` with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` (``kernels/build.py``):

  - ``skip_lora_fwd`` (K1) replaces ``repro/kernels/skip_lora/kernel.py::skip_lora_fwd``;
  - ``skip_lora_bwd`` (K2) replaces ``...::skip_lora_bwd``;
  - ``skip_lora_fwd_int8`` (K3) replaces ``...::skip_lora_fwd_int8``;
  - ``grouped_skip_sum_fwd`` (K5, float pool) replaces ``...::skip_lora_grouped_fwd``;
  - ``grouped_skip_sum_fwd_int8`` (K6, int8 pool) replaces
    ``...::skip_lora_grouped_fwd_int8``;
  - ``grouped_skip_sum_fwd_q4`` (K7, packed 4-bit pool) replaces
    ``...::skip_lora_grouped_fwd_q4``;
  - ``grouped_skip_sum_fwd_actint8`` (K8, int8 activations) replaces
    ``...::skip_lora_grouped_fwd_actint8``;
  - ``grouped_skip_sum_bwd`` (K9, per-slot adapter gradients) replaces
    ``...::skip_lora_grouped_bwd``.

Nothing is built or loaded at import time: the module imports on a machine
with no CUDA toolkit. Each launch function checks devices, types, shapes and
contiguity, allocates its output and scratch, launches on the current
stream, raises on a nonzero CUDA error code, and counts its launches in
``LAUNCHES``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels.build import I, KernelLib, P, check, check_tensor

CSRC = Path(__file__).resolve().parent / "csrc"
#: kernel name -> its source file under csrc/
SOURCES = {
    "skip_lora_fwd": "skip_lora_fwd.cu",
    "skip_lora_bwd": "skip_lora_bwd.cu",
    "skip_lora_fwd_int8": "skip_lora_fwd_int8.cu",
    "grouped_skip_sum_fwd": "grouped_skip_sum_fwd.cu",
    "grouped_skip_sum_fwd_int8": "grouped_skip_sum_fwd_int8.cu",
    "grouped_skip_sum_fwd_q4": "grouped_skip_sum_fwd_q4.cu",
    "grouped_skip_sum_fwd_actint8": "grouped_skip_sum_fwd_actint8.cu",
    "grouped_skip_sum_bwd": "grouped_skip_sum_bwd.cu",
}
LIB = KernelLib(CSRC, SOURCES, {
    "skip_lora_fwd": [P] * 5 + [I] * 6 + [P],
    "skip_lora_bwd": [P] * 10 + [I] * 6 + [P],
    "skip_lora_fwd_int8": [P] * 6 + [I] * 5 + [P],
    "grouped_skip_sum_fwd": [P] * 7 + [I] * 8 + [P],
    "grouped_skip_sum_fwd_int8": [P] * 9 + [I] * 7 + [P],
    "grouped_skip_sum_fwd_q4": [P] * 10 + [I] * 7 + [P],
    "grouped_skip_sum_fwd_actint8": [P] * 8 + [I] * 7 + [P],
    "grouped_skip_sum_bwd": [P] * 10 + [I] * 9 + [P],
})

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = LIB.launches
reset_launches = LIB.reset_launches
build = LIB.build

#: most rows in one tile and highest rank the kernels take (*.cuh)
TM_MAX = 32
R_MAX = 64
#: rows of M per partial gradient in the backward (skip_sum.cuh, O_MC)
BWD_CHUNK = 256

_FLOAT = (torch.float32, torch.bfloat16)


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


# ---------------------------------------------------------------------------
# K1, K2, K3: one adapter stack over all rows
# ---------------------------------------------------------------------------


def _check_adapters(x, a, b, lnum, d):
    r = a.shape[-1]
    check(1 <= r <= R_MAX, f"rank {r} outside 1..{R_MAX}")
    check_tensor(a, "a", x.device, (lnum, d, r), _FLOAT)
    check_tensor(b, "b", x.device, (lnum, r, d), (a.dtype,))
    return r


def skip_lora_fwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: x (L, M, D) fp32/bf16, a (L, D, R), b (L, R, D) fp32/bf16 ->
    (M, D) in x.dtype."""
    check_tensor(x, "x", x.device, x.shape, _FLOAT)
    lnum, m, d = x.shape
    r = _check_adapters(x, a, b, lnum, d)
    z = torch.empty((lnum, m, r), dtype=torch.float32, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    LIB.launch("skip_lora_fwd", x, x.data_ptr(), a.data_ptr(), b.data_ptr(), z.data_ptr(),
               out.data_ptr(), lnum, m, d, r, _bf16(x), _bf16(a))
    return out


def skip_lora_bwd(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: adapter grads (gA (L, D, R), gB (L, R, D)) fp32 for the upstream
    gradient g (M, D) in x.dtype. Deterministic: the sum over M is split in
    ``BWD_CHUNK``-row partials added in a fixed order."""
    check_tensor(x, "x", x.device, x.shape, _FLOAT)
    lnum, m, d = x.shape
    r = _check_adapters(x, a, b, lnum, d)
    check_tensor(g, "g", x.device, (m, d), (x.dtype,))
    f32 = dict(dtype=torch.float32, device=x.device)
    z = torch.empty((lnum, m, r), **f32)
    gz = torch.empty((lnum, m, r), **f32)
    chunks = -(-m // BWD_CHUNK)
    ga = torch.empty((lnum, d, r), **f32)
    gb = torch.empty((lnum, r, d), **f32)
    if chunks > 1:
        pa = torch.empty((chunks, lnum, d, r), **f32)
        pb = torch.empty((chunks, lnum, r, d), **f32)
        pa_ptr, pb_ptr = pa.data_ptr(), pb.data_ptr()
    else:
        pa_ptr = pb_ptr = None
    LIB.launch("skip_lora_bwd", x, x.data_ptr(), a.data_ptr(), b.data_ptr(), g.data_ptr(),
               z.data_ptr(), gz.data_ptr(), pa_ptr, pb_ptr, ga.data_ptr(), gb.data_ptr(),
               lnum, m, d, r, _bf16(x), _bf16(a))
    return ga, gb


def skip_lora_fwd_int8(
    q: torch.Tensor, s: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """K3: q (L, M, D) int8 with per-row scales s (L, M) fp32, dequantised to
    bf16 in the kernel -> (M, D) bf16."""
    check_tensor(q, "q", q.device, q.shape, (torch.int8,))
    lnum, m, d = q.shape
    check_tensor(s, "s", q.device, (lnum, m), (torch.float32,))
    r = _check_adapters(q, a, b, lnum, d)
    z = torch.empty((lnum, m, r), dtype=torch.float32, device=q.device)
    out = torch.empty((m, d), dtype=torch.bfloat16, device=q.device)
    LIB.launch("skip_lora_fwd_int8", q, q.data_ptr(), s.data_ptr(), a.data_ptr(), b.data_ptr(),
               z.data_ptr(), out.data_ptr(), lnum, m, d, r, _bf16(a))
    return out


# ---------------------------------------------------------------------------
# K5, K6: grouped (multi-tenant) forwards over an adapter pool
# ---------------------------------------------------------------------------


def _check_plan(x, row_src, tile_slot, tm, dtypes=_FLOAT):
    lnum, m, d = x.shape
    check_tensor(x, "x", x.device, x.shape, dtypes)
    check(1 <= tm <= TM_MAX, f"row tile {tm} outside 1..{TM_MAX}")
    n_tiles = tile_slot.shape[0]
    for t, name in ((row_src, "row_src"), (tile_slot, "tile_slot")):
        check(t.dtype == torch.int32 and t.is_contiguous() and t.device == x.device,
              f"{name} must be contiguous int32 on {x.device}")
    check(row_src.shape == (n_tiles * tm,), f"row_src {tuple(row_src.shape)} != ({n_tiles * tm},)")
    check(n_tiles >= 1 and m >= 1, "empty batch")
    return lnum, m, d, n_tiles


def _check_float_pool(x, a_pool, b_pool, lnum, d):
    n, _, _, r = a_pool.shape
    check(1 <= r <= R_MAX, f"rank {r} outside 1..{R_MAX}")
    check_tensor(a_pool, "a_pool", x.device, (n, lnum, d, r), _FLOAT)
    check_tensor(b_pool, "b_pool", x.device, (n, lnum, r, d), (a_pool.dtype,))
    return n, r


def grouped_skip_sum_fwd(
    x: torch.Tensor,          # (L, M, D) fp32 / bf16, original row order
    a_pool: torch.Tensor,     # (N, L, D, R) fp32 / bf16
    b_pool: torch.Tensor,     # (N, L, R, D), same dtype as a_pool
    row_src: torch.Tensor,    # (n_tiles * tm,) int32 original row or -1
    tile_slot: torch.Tensor,  # (n_tiles,) int32
    tm: int,
) -> torch.Tensor:
    """K5: float-pool grouped skip-sum on the card -> (M, D) in x.dtype."""
    lnum, m, d, n_tiles = _check_plan(x, row_src, tile_slot, tm)
    _, r = _check_float_pool(x, a_pool, b_pool, lnum, d)
    z = torch.empty((lnum, n_tiles * tm, r), dtype=torch.float32, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    LIB.launch(
        "grouped_skip_sum_fwd", x,
        x.data_ptr(), a_pool.data_ptr(), b_pool.data_ptr(), row_src.data_ptr(),
        tile_slot.data_ptr(), z.data_ptr(), out.data_ptr(),
        lnum, m, d, r, tm, n_tiles, _bf16(x), _bf16(a_pool),
    )
    return out


def grouped_skip_sum_fwd_int8(
    x: torch.Tensor,          # (L, M, D) fp32 / bf16, original row order
    qa: torch.Tensor,         # (N, L, D, R) int8
    sa: torch.Tensor,         # (N, L, D) fp32
    qb: torch.Tensor,         # (N, L, R, D) int8
    sb: torch.Tensor,         # (N, L, R) fp32
    row_src: torch.Tensor,
    tile_slot: torch.Tensor,
    tm: int,
) -> torch.Tensor:
    """K6: int8-pool grouped skip-sum on the card -> (M, D) in x.dtype."""
    lnum, m, d, n_tiles = _check_plan(x, row_src, tile_slot, tm)
    n, _, _, r = qa.shape
    check(1 <= r <= R_MAX, f"rank {r} outside 1..{R_MAX}")
    i8, f32 = (torch.int8,), (torch.float32,)
    check_tensor(qa, "qa", x.device, (n, lnum, d, r), i8)
    check_tensor(sa, "sa", x.device, (n, lnum, d), f32)
    check_tensor(qb, "qb", x.device, (n, lnum, r, d), i8)
    check_tensor(sb, "sb", x.device, (n, lnum, r), f32)
    z = torch.empty((lnum, n_tiles * tm, r), dtype=torch.float32, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    LIB.launch(
        "grouped_skip_sum_fwd_int8", x,
        x.data_ptr(), qa.data_ptr(), sa.data_ptr(), qb.data_ptr(), sb.data_ptr(),
        row_src.data_ptr(), tile_slot.data_ptr(), z.data_ptr(), out.data_ptr(),
        lnum, m, d, r, tm, n_tiles, _bf16(x),
    )
    return out


# ---------------------------------------------------------------------------
# K7: packed 4-bit pool; K8: int8 activations; K9: grouped backward
# ---------------------------------------------------------------------------


def grouped_skip_sum_fwd_q4(
    x: torch.Tensor,          # (L, M, D) fp32 / bf16, original row order
    qa: torch.Tensor,         # (N, L, D, R // 2) uint8, two nibbles a byte along R
    sa: torch.Tensor,         # (N, L, D) fp32
    qb: torch.Tensor,         # (N, L, R, D // 2) uint8, two nibbles a byte along D
    sb: torch.Tensor,         # (N, L, R) fp32
    code: torch.Tensor,       # (16,) fp32 codebook
    row_src: torch.Tensor,
    tile_slot: torch.Tensor,
    tm: int,
) -> torch.Tensor:
    """K7: packed-4-bit-pool grouped skip-sum on the card -> (M, D) in x.dtype."""
    lnum, m, d, n_tiles = _check_plan(x, row_src, tile_slot, tm)
    n, _, _, rp = qa.shape
    r = 2 * rp
    check(1 <= r <= R_MAX, f"rank {r} outside 1..{R_MAX}")
    check(d % 2 == 0, f"d_model {d} must be even to unpack B")
    u8, f32 = (torch.uint8,), (torch.float32,)
    check_tensor(qa, "qa", x.device, (n, lnum, d, rp), u8)
    check_tensor(sa, "sa", x.device, (n, lnum, d), f32)
    check_tensor(qb, "qb", x.device, (n, lnum, r, d // 2), u8)
    check_tensor(sb, "sb", x.device, (n, lnum, r), f32)
    check_tensor(code, "code", x.device, (16,), f32)
    z = torch.empty((lnum, n_tiles * tm, r), dtype=torch.float32, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    LIB.launch(
        "grouped_skip_sum_fwd_q4", x,
        x.data_ptr(), qa.data_ptr(), sa.data_ptr(), qb.data_ptr(), sb.data_ptr(), code.data_ptr(),
        row_src.data_ptr(), tile_slot.data_ptr(), z.data_ptr(), out.data_ptr(),
        lnum, m, d, r, tm, n_tiles, _bf16(x),
    )
    return out


def grouped_skip_sum_fwd_actint8(
    q: torch.Tensor,          # (L, M, D) int8, original row order
    s: torch.Tensor,          # (L, M) fp32 per-row scales
    a_pool: torch.Tensor,     # (N, L, D, R) fp32 / bf16
    b_pool: torch.Tensor,     # (N, L, R, D), same dtype as a_pool
    row_src: torch.Tensor,
    tile_slot: torch.Tensor,
    tm: int,
) -> torch.Tensor:
    """K8: grouped skip-sum over int8 activations dequantised to bf16 in the
    kernel, float pool -> (M, D) bf16."""
    lnum, m, d, n_tiles = _check_plan(q, row_src, tile_slot, tm, (torch.int8,))
    check_tensor(s, "s", q.device, (lnum, m), (torch.float32,))
    _, r = _check_float_pool(q, a_pool, b_pool, lnum, d)
    z = torch.empty((lnum, n_tiles * tm, r), dtype=torch.float32, device=q.device)
    out = torch.empty((m, d), dtype=torch.bfloat16, device=q.device)
    LIB.launch(
        "grouped_skip_sum_fwd_actint8", q,
        q.data_ptr(), s.data_ptr(), a_pool.data_ptr(), b_pool.data_ptr(),
        row_src.data_ptr(), tile_slot.data_ptr(), z.data_ptr(), out.data_ptr(),
        lnum, m, d, r, tm, n_tiles, _bf16(a_pool),
    )
    return out


def grouped_skip_sum_bwd(
    x: torch.Tensor,          # (L, M, D) fp32 / bf16, original row order
    a_pool: torch.Tensor,     # (N, L, D, R) fp32 / bf16
    b_pool: torch.Tensor,     # (N, L, R, D), same dtype as a_pool
    g: torch.Tensor,          # (M, D) in x.dtype
    row_src: torch.Tensor,
    tile_slot: torch.Tensor,  # (n_tiles,) int32, non-decreasing
    tm: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K9: per-slot adapter grads (gA (N, L, D, R), gB (N, L, R, D)) fp32,
    zeros for slots with no rows. Deterministic: each (slot, layer) block is
    summed by one CUDA block over the slot's rows in grouped order."""
    lnum, m, d, n_tiles = _check_plan(x, row_src, tile_slot, tm)
    n, r = _check_float_pool(x, a_pool, b_pool, lnum, d)
    check_tensor(g, "g", x.device, (m, d), (x.dtype,))
    f32 = dict(dtype=torch.float32, device=x.device)
    z = torch.empty((lnum, n_tiles * tm, r), **f32)
    gz = torch.empty((lnum, n_tiles * tm, r), **f32)
    ga = torch.empty((n, lnum, d, r), **f32)
    gb = torch.empty((n, lnum, r, d), **f32)
    LIB.launch(
        "grouped_skip_sum_bwd", x,
        x.data_ptr(), g.data_ptr(), a_pool.data_ptr(), b_pool.data_ptr(),
        row_src.data_ptr(), tile_slot.data_ptr(), z.data_ptr(), gz.data_ptr(),
        ga.data_ptr(), gb.data_ptr(), lnum, m, d, r, tm, n_tiles, n, _bf16(x), _bf16(a_pool),
    )
    return ga, gb
