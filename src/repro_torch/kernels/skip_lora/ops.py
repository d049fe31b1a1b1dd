"""Public wrappers for the Skip-LoRA sum: single-stack (training) and
grouped (multi-tenant serving).

Counterpart of ``repro.kernels.skip_lora.ops``:
  - ``skip_lora_fused`` / ``skip_lora_fused_int8`` take acts (L, B, S, D)
    (or an int8 payload (L, B, S, D) with per-row scales (L, B, S)) and one
    adapter stack a (L, D, R), b (L, R, D), and return (B, S, D). Each is a
    ``torch.autograd.Function``: the forward is K1 / K3, the backward K2,
    which gives the adapters' gradients only -- the cached activations are
    frozen-backbone constants and get none. The int8 backward first
    dequantises the rows to bf16 with a plain torch op, as the reference's
    ``_dequant_rows`` does; the forward never does.
  - ``skip_lora_grouped`` (float pool) and ``skip_lora_grouped_int8`` (int8
    pool) take acts (L, B, S, D), pools (N, L, D, R) / (N, L, R, D) and idx
    (B,) slot per batch row, and return (B, S, D) (K5 / K6).

Dispatch follows the device of the activations: a CPU tensor goes to the
plain version in ``ref.py``; a CUDA tensor launches the hand-written kernel
in ``kernel.py`` (or raises); any other device raises. Grouped inputs are
detached, the counterpart of the reference's ``stop_gradient``: the pool
holds already fine-tuned tenants.

The grouped kernels want rows grouped so that every ``tm``-row tile belongs to one
slot. ``_grouping_plan`` is the reference's plan written in torch ops that
need no host synchronisation: rows sorted by slot, each group padded to a tile
boundary inside a buffer of static size. The kernels never build the grouped
copy of x: ``_grouped_scatter`` turns the plan into ``row_src``, the
original row of each grouped position (or -1 for padding), and the kernels
gather and scatter rows through it. ``tm`` is the GPU's own row tile (the
reference's ``grid_order`` is a TPU grid knob with no meaning here); it does
not change the result.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.skip_lora import kernel as K
from repro_torch.kernels.skip_lora import ref as R

#: default row tile of the CUDA kernels
TM = 16


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"skip-LoRA sum runs on cpu or cuda, not {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# One adapter stack over all rows: K1 / K3 forward, K2 backward
# ---------------------------------------------------------------------------


def _fwd(x, a, b):
    return R.skip_lora_fwd_ref(x, a, b) if _device_kind(x) == "cpu" else K.skip_lora_fwd(x, a, b)


def _adapter_grads(x, a, b, g):
    """K2 on x (L, M, D) and g (M, D) cast to x.dtype, grads cast to the
    adapters' dtypes."""
    g = g.to(x.dtype).contiguous()
    bwd = R.skip_lora_bwd_ref if _device_kind(x) == "cpu" else K.skip_lora_bwd
    ga, gb = bwd(x, a, b, g)
    return ga.to(a.dtype), gb.to(b.dtype)


def _dequant_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """One-off dequantisation of int8 cache rows for the adapter backward."""
    return (q.float() * s[..., None]).to(torch.bfloat16)


class _SkipLoraRows(torch.autograd.Function):
    """x (L, M, D) -> (M, D), differentiable in (a, b); x is data."""

    @staticmethod
    def forward(ctx, x, a, b):
        ctx.save_for_backward(x, a, b)
        return _fwd(x, a, b)

    @staticmethod
    def backward(ctx, g):
        x, a, b = ctx.saved_tensors
        ga, gb = _adapter_grads(x, a, b, g)
        return None, ga, gb


class _SkipLoraRowsInt8(torch.autograd.Function):
    """q (L, M, D) int8, s (L, M) fp32 -> (M, D) bf16, differentiable in
    (a, b); the cache is data."""

    @staticmethod
    def forward(ctx, q, s, a, b):
        ctx.save_for_backward(q, s, a, b)
        if _device_kind(q) == "cpu":
            return R.skip_lora_int8_fwd_ref(q, s, a, b)
        return K.skip_lora_fwd_int8(q, s, a, b)

    @staticmethod
    def backward(ctx, g):
        q, s, a, b = ctx.saved_tensors
        ga, gb = _adapter_grads(_dequant_rows(q, s), a, b, g)
        return None, None, ga, gb


def skip_lora_fused(acts: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_l acts[l] @ a[l] @ b[l]: acts (L, B, S, D); a (L, D, R);
    b (L, R, D) -> (B, S, D) in acts.dtype."""
    lnum, bsz, s, d = acts.shape
    x = acts.detach().reshape(lnum, bsz * s, d).contiguous()
    out = _SkipLoraRows.apply(x, a.contiguous(), b.contiguous())
    return out.reshape(bsz, s, d)


def skip_lora_fused_int8(
    q: torch.Tensor, scale: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """int8-cache variant (dequantisation in the kernel): q (L, B, S, D)
    int8, scale (L, B, S) fp32 -> (B, S, D) bf16."""
    lnum, bsz, s, d = q.shape
    qr = q.reshape(lnum, bsz * s, d).contiguous()
    sr = scale.detach().reshape(lnum, bsz * s).contiguous()
    out = _SkipLoraRowsInt8.apply(qr, sr, a.contiguous(), b.contiguous())
    return out.reshape(bsz, s, d)


# ---------------------------------------------------------------------------
# Grouped (multi-tenant) forwards: K5 / K6
# ---------------------------------------------------------------------------


def _grouping_plan(idx: torch.Tensor, n_adapters: int, m: int, tm: int = TM):
    """Row permutation + tile->slot map for grouped dispatch.

    Returns (dest_orig (M,) grouped-buffer position of each original row,
    tile_adapter (m_pad // tm,) int32, m_pad), equal to the reference's
    ``_grouping_plan``. Slack tiles past the last group alias slot N-1."""
    idx = idx.long()
    dev = idx.device
    m_pad = (m + tm - 1) // tm * tm + min(n_adapters, m) * tm
    # index_add_ instead of bincount: bincount reads the max on the host,
    # a device synchronisation on every call.
    counts = torch.zeros((n_adapters,), dtype=torch.long, device=dev).index_add_(
        0, idx, torch.ones_like(idx)
    )
    zero = torch.zeros((1,), dtype=counts.dtype, device=dev)
    counts_cum_ex = torch.cat([zero, torch.cumsum(counts, 0)[:-1]])
    padded = (counts + tm - 1) // tm * tm
    starts = torch.cat([zero, torch.cumsum(padded, 0)[:-1]])
    order = torch.argsort(idx, stable=True)
    g_sorted = idx[order]
    within = torch.arange(m, device=dev) - counts_cum_ex[g_sorted]
    dest_sorted = starts[g_sorted] + within
    dest_orig = torch.empty_like(dest_sorted)
    dest_orig[order] = dest_sorted
    tile_cum = torch.cumsum(padded // tm, 0)
    tile_adapter = torch.searchsorted(
        tile_cum, torch.arange(m_pad // tm, device=dev), right=True
    )
    tile_adapter = torch.clamp(tile_adapter, 0, n_adapters - 1).to(torch.int32)
    return dest_orig, tile_adapter, m_pad


def _grouped_scatter(arr: torch.Tensor, dest: torch.Tensor, m_pad: int, axis: int) -> torch.Tensor:
    """Scatter rows into the grouped padded layout along ``axis`` (padding
    rows stay zero)."""
    shape = list(arr.shape)
    shape[axis] = m_pad
    out = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
    if axis == 0:
        out[dest] = arr
    else:
        out[:, dest] = arr
    return out


def _row_sources(dest: torch.Tensor, m_pad: int) -> torch.Tensor:
    """(m_pad,) int32: the original row at each grouped position, -1 for padding."""
    rows = torch.arange(1, dest.shape[0] + 1, dtype=torch.int32, device=dest.device)
    return _grouped_scatter(rows, dest, m_pad, 0) - 1


def _plan(idx: torch.Tensor, n_adapters: int, m: int, tm: int):
    dest, tile_slot, m_pad = _grouping_plan(idx, n_adapters, m, tm)
    return _row_sources(dest, m_pad), tile_slot


def _rows(acts: torch.Tensor, idx: torch.Tensor):
    """(L, B, S, D) acts + (B,) slots -> (L, B*S, D) rows + (B*S,) row slots."""
    lnum, bsz, s, d = acts.shape
    return acts.detach().reshape(lnum, bsz * s, d).contiguous(), idx.repeat_interleave(s)


def skip_lora_grouped(
    acts: torch.Tensor, a_pool: torch.Tensor, b_pool: torch.Tensor, idx: torch.Tensor,
    *, tm: int = TM,
) -> torch.Tensor:
    """Multi-tenant skip-sum: row b gets its own adapter stack.

    acts: (L, B, S, D); a_pool: (N, L, D, R); b_pool: (N, L, R, D);
    idx: (B,) int slot per batch row -> (B, S, D) in acts.dtype."""
    _, bsz, s, d = acts.shape
    x, row_idx = _rows(acts, idx)
    a_pool, b_pool = a_pool.detach(), b_pool.detach()
    if _device_kind(x) == "cpu":
        out = R.skip_lora_grouped_ref(x, a_pool, b_pool, row_idx)
    else:
        row_src, tile_slot = _plan(row_idx, a_pool.shape[0], x.shape[1], tm)
        out = K.grouped_skip_sum_fwd(x, a_pool, b_pool, row_src, tile_slot, tm)
    return out.reshape(bsz, s, d)


def skip_lora_grouped_int8(
    acts: torch.Tensor,
    qa: torch.Tensor,
    sa: torch.Tensor,
    qb: torch.Tensor,
    sb: torch.Tensor,
    idx: torch.Tensor,
    *,
    tm: int = TM,
) -> torch.Tensor:
    """Multi-tenant skip-sum over an int8 pool: qa (N, L, D, R) int8 with
    sa (N, L, D) fp32, qb (N, L, R, D) int8 with sb (N, L, R) fp32. The
    kernel dequantises gathered elements in registers."""
    _, bsz, s, d = acts.shape
    x, row_idx = _rows(acts, idx)
    sa, sb = sa.detach(), sb.detach()
    if _device_kind(x) == "cpu":
        out = R.skip_lora_grouped_int8_ref(x, qa, sa, qb, sb, row_idx)
    else:
        row_src, tile_slot = _plan(row_idx, qa.shape[0], x.shape[1], tm)
        out = K.grouped_skip_sum_fwd_int8(x, qa, sa, qb, sb, row_src, tile_slot, tm)
    return out.reshape(bsz, s, d)
