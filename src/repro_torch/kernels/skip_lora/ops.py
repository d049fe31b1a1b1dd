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
  - ``skip_lora_grouped`` (float pool), ``skip_lora_grouped_int8`` (int8
    pool) and ``skip_lora_grouped_q4`` (packed 4-bit pool) take acts
    (L, B, S, D), pools (N, L, D, R) / (N, L, R, D) (or their quantised
    layouts) and idx (B,) slot per batch row, and return (B, S, D) (K5 / K6
    / K7). They serve already fine-tuned tenants.
  - ``skip_lora_grouped_train`` (float activations, K5 forward) and
    ``skip_lora_grouped_train_int8`` (an int8 activation cache, K8 forward)
    are the fleet trainer's grouped sums: ``torch.autograd.Function``s whose
    backward is K9, giving each slot's adapter gradients (exact zeros for
    slots with no rows and for ``freeze_mask`` slots).
    ``skip_lora_grouped_train_q4`` trains the scales of a 4-bit pool: K7
    forward, K9 on the dequantised pools, then the chain rule onto the
    scales.

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
from repro_torch.kernels.skip_lora.quant import unpack_nibbles

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


def skip_lora_grouped_q4(
    acts: torch.Tensor,
    qa: torch.Tensor,
    sa: torch.Tensor,
    qb: torch.Tensor,
    sb: torch.Tensor,
    code: torch.Tensor,
    idx: torch.Tensor,
    *,
    tm: int = TM,
) -> torch.Tensor:
    """Multi-tenant skip-sum over a packed 4-bit pool (int4 or nf4: the
    codebook decides): qa (N, L, D, R//2) uint8 with sa (N, L, D) fp32, qb
    (N, L, R, D//2) uint8 with sb (N, L, R) fp32, code (16,) fp32. The kernel
    unpacks and dequantises gathered elements in registers."""
    _, bsz, s, d = acts.shape
    x, row_idx = _rows(acts, idx)
    sa, sb = sa.detach(), sb.detach()
    if _device_kind(x) == "cpu":
        out = R.skip_lora_grouped_q4_ref(x, qa, sa, qb, sb, code, row_idx)
    else:
        row_src, tile_slot = _plan(row_idx, qa.shape[0], x.shape[1], tm)
        out = K.grouped_skip_sum_fwd_q4(x, qa, sa, qb, sb, code, row_src, tile_slot, tm)
    return out.reshape(bsz, s, d)


# ---------------------------------------------------------------------------
# Trainable grouped sums (fleet fine-tuning): K5 / K8 / K7 forward, K9 backward
# ---------------------------------------------------------------------------


def _live_slot_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(N,) bool: slots that own at least one row. ``index_add_``, not
    ``bincount``, which reads the max on the host."""
    idx = idx.long()
    counts = torch.zeros((n,), dtype=torch.long, device=idx.device)
    return counts.index_add_(0, idx, torch.ones_like(idx)) > 0


def _mask_slots(grad: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    return torch.where(live.reshape((-1,) + (1,) * (grad.ndim - 1)), grad, torch.zeros_like(grad))


def _train_plan(idx: torch.Tensor, n: int, m: int, tm: int, x: torch.Tensor):
    """The grouping plan (row_src, tile_slot) on the card, none on the CPU."""
    return () if _device_kind(x) == "cpu" else _plan(idx, n, m, tm)


def _grouped_pool_grads(x, a_pool, b_pool, idx, g, plan, tm):
    """Shared backward body of every trainable grouped sum: K9 (or its plain
    version) on rows x (L, M, D) and g (M, D) cast to x.dtype, slots with no
    rows masked to exact zero, grads cast to the pools' dtypes."""
    g = g.to(x.dtype).contiguous()
    if plan:
        ga, gb = K.grouped_skip_sum_bwd(x, a_pool, b_pool, g, *plan, tm)
    else:
        ga, gb = R.skip_lora_grouped_bwd_ref(x, a_pool, b_pool, g, idx)
    live = _live_slot_mask(idx, a_pool.shape[0])
    return _mask_slots(ga, live).to(a_pool.dtype), _mask_slots(gb, live).to(b_pool.dtype)


class _GroupedRowsTrain(torch.autograd.Function):
    """x (L, M, D), pools (N, L, D, R) / (N, L, R, D), idx (M,) -> (M, D) in
    x.dtype; differentiable in the pools, x and idx are data."""

    @staticmethod
    def forward(ctx, x, a_pool, b_pool, idx, tm):
        plan = _train_plan(idx, a_pool.shape[0], x.shape[1], tm, x)
        if plan:
            out = K.grouped_skip_sum_fwd(x, a_pool, b_pool, *plan, tm)
        else:
            out = R.skip_lora_grouped_ref(x, a_pool, b_pool, idx)
        ctx.save_for_backward(x, a_pool, b_pool, idx, *plan)
        ctx.tm = tm
        return out

    @staticmethod
    def backward(ctx, g):
        x, a_pool, b_pool, idx, *plan = ctx.saved_tensors
        ga, gb = _grouped_pool_grads(x, a_pool, b_pool, idx, g, plan, ctx.tm)
        return None, ga, gb, None, None


class _GroupedRowsTrainInt8(torch.autograd.Function):
    """q (L, M, D) int8, s (L, M) fp32, float pools, idx (M,) -> (M, D)
    bf16; differentiable in the pools. The backward dequantises the rows to
    bf16 once, as the reference's does; the forward never does."""

    @staticmethod
    def forward(ctx, q, s, a_pool, b_pool, idx, tm):
        plan = _train_plan(idx, a_pool.shape[0], q.shape[1], tm, q)
        if plan:
            out = K.grouped_skip_sum_fwd_actint8(q, s, a_pool, b_pool, *plan, tm)
        else:
            out = R.skip_lora_grouped_actint8_ref(q, s, a_pool, b_pool, idx)
        ctx.save_for_backward(q, s, a_pool, b_pool, idx, *plan)
        ctx.tm = tm
        return out

    @staticmethod
    def backward(ctx, g):
        q, s, a_pool, b_pool, idx, *plan = ctx.saved_tensors
        ga, gb = _grouped_pool_grads(_dequant_rows(q, s), a_pool, b_pool, idx, g, plan, ctx.tm)
        return None, None, ga, gb, None, None


class _GroupedRowsTrainQ4(torch.autograd.Function):
    """Packed-4-bit pools -> (M, D) in x.dtype, differentiable in the scales
    (sa, sb) only: the nibble payload and the codebook are data.
    pool = code[nib] * scale is linear in the scale with coefficient u =
    code[nib], so the backward runs K9 on the dequantised pools (cast to
    x.dtype) and contracts each gradient row with u."""

    @staticmethod
    def forward(ctx, x, qa, sa, qb, sb, code, idx, tm):
        plan = _train_plan(idx, qa.shape[0], x.shape[1], tm, x)
        if plan:
            out = K.grouped_skip_sum_fwd_q4(x, qa, sa, qb, sb, code, *plan, tm)
        else:
            out = R.skip_lora_grouped_q4_ref(x, qa, sa, qb, sb, code, idx)
        ctx.save_for_backward(x, qa, sa, qb, sb, code, idx, *plan)
        ctx.tm = tm
        return out

    @staticmethod
    def backward(ctx, g):
        x, qa, sa, qb, sb, code, idx, *plan = ctx.saved_tensors
        ua = code[unpack_nibbles(qa).long()]
        ub = code[unpack_nibbles(qb).long()]
        a_pool = (ua * sa[..., None]).to(x.dtype)
        b_pool = (ub * sb[..., None]).to(x.dtype)
        ga, gb = _grouped_pool_grads(x, a_pool, b_pool, idx, g, plan, ctx.tm)
        gsa = torch.sum(ga.float() * ua, dim=-1).to(sa.dtype)
        gsb = torch.sum(gb.float() * ub, dim=-1).to(sb.dtype)
        return None, None, gsa, None, gsb, None, None, None


def freeze_pool_slots(pool: torch.Tensor, freeze_mask: torch.Tensor) -> torch.Tensor:
    """Detach the slots where ``freeze_mask`` (N,) bool is True from autograd
    (forward value unchanged): they get exact-zero gradients through any
    later use. This keeps the pinned zero slot at zero when base-model rows
    ride a fleet batch."""
    mask = freeze_mask.reshape((-1,) + (1,) * (pool.ndim - 1))
    return torch.where(mask, pool.detach(), pool)


def _freeze(freeze_mask, *pools):
    if freeze_mask is None:
        return pools
    return tuple(freeze_pool_slots(p, freeze_mask) for p in pools)


def skip_lora_grouped_train(
    acts: torch.Tensor,
    a_pool: torch.Tensor,
    b_pool: torch.Tensor,
    idx: torch.Tensor,
    *,
    freeze_mask: torch.Tensor | None = None,
    tm: int = TM,
) -> torch.Tensor:
    """Trainable multi-tenant skip-sum: ``skip_lora_grouped`` differentiable
    in the pools, the fleet fine-tuning primitive.

    acts: (L, B, S, D) cached activations (data); a_pool: (N, L, D, R);
    b_pool: (N, L, R, D); idx: (B,) slot per batch row; freeze_mask:
    optional (N,) bool of slots whose grads must be exactly zero. Slots with
    no rows always get exact-zero grads. -> (B, S, D) in acts.dtype."""
    _, bsz, s, d = acts.shape
    a_pool, b_pool = _freeze(freeze_mask, a_pool, b_pool)
    x, row_idx = _rows(acts, idx)
    out = _GroupedRowsTrain.apply(x, a_pool.contiguous(), b_pool.contiguous(), row_idx, tm)
    return out.reshape(bsz, s, d)


def skip_lora_grouped_train_int8(
    acts_q: torch.Tensor,
    acts_scale: torch.Tensor,
    a_pool: torch.Tensor,
    b_pool: torch.Tensor,
    idx: torch.Tensor,
    *,
    freeze_mask: torch.Tensor | None = None,
    tm: int = TM,
) -> torch.Tensor:
    """Trainable grouped skip-sum over a raw int8 activation cache: acts_q
    (L, B, S, D) int8, acts_scale (L, B, S) fp32 (the ``mode="int8"`` cache
    layout), dequantised in the kernel (K8). Float pools. -> (B, S, D) bf16."""
    lnum, bsz, s, d = acts_q.shape
    a_pool, b_pool = _freeze(freeze_mask, a_pool, b_pool)
    q = acts_q.reshape(lnum, bsz * s, d).contiguous()
    sc = acts_scale.detach().reshape(lnum, bsz * s).contiguous()
    out = _GroupedRowsTrainInt8.apply(q, sc, a_pool.contiguous(), b_pool.contiguous(),
                                      idx.repeat_interleave(s), tm)
    return out.reshape(bsz, s, d)


def skip_lora_grouped_train_q4(
    acts: torch.Tensor,
    qa: torch.Tensor,
    sa: torch.Tensor,
    qb: torch.Tensor,
    sb: torch.Tensor,
    code: torch.Tensor,
    idx: torch.Tensor,
    *,
    freeze_mask: torch.Tensor | None = None,
    tm: int = TM,
) -> torch.Tensor:
    """Trainable grouped skip-sum over packed 4-bit pools, by scale
    refinement: the nibble payload is frozen and gradients reach (sa, sb)
    only. Slots with no rows and ``freeze_mask`` slots get exact-zero scale
    grads. -> (B, S, D) in acts.dtype."""
    _, bsz, s, d = acts.shape
    sa, sb = _freeze(freeze_mask, sa, sb)
    x, row_idx = _rows(acts, idx)
    out = _GroupedRowsTrainQ4.apply(x, qa, sa.contiguous(), qb, sb.contiguous(), code, row_idx, tm)
    return out.reshape(bsz, s, d)
