"""Public wrappers for the grouped (multi-tenant) Skip-LoRA skip-sum.

Counterpart of the serve half of ``repro.kernels.skip_lora.ops``:
``skip_lora_grouped`` (float pool) and ``skip_lora_grouped_int8`` (int8
pool) take the framework layouts -- acts (L, B, S, D), pools (N, L, D, R) /
(N, L, R, D), idx (B,) slot per batch row -- and return (B, S, D).

Dispatch follows the device of the activations: a CPU tensor goes to the
plain version in ``ref.py``; a CUDA tensor launches the hand-written kernel
in ``kernel.py`` (or raises); any other device raises. Inputs are detached,
the counterpart of the reference's ``stop_gradient``: the pool holds
already fine-tuned tenants.

The kernels want rows grouped so that every ``tm``-row tile belongs to one
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


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped skip-sum runs on cpu or cuda, not {x.device}")
    return x.device.type


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
