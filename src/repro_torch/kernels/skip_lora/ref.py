"""Plain PyTorch versions of the Skip-LoRA kernels.

Counterparts of ``repro.kernels.skip_lora.ref``. They are what the op
wrappers run on CPU tensors, and what the CUDA kernels are held against on
the card. Products accumulate in fp32, ``z`` is cast to ``x.dtype``
between them, and the adapters are cast to ``x.dtype`` before use.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.skip_lora.quant import dequantize_q4


def skip_lora_fwd_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_l x[l] @ a[l] @ b[l].

    x: (L, M, D); a: (L, D, R); b: (L, R, D) -> (M, D) in x.dtype."""
    z = torch.einsum("lmd,ldr->lmr", x.float(), a.to(x.dtype).float())
    out = torch.einsum("lmr,lrd->md", z.to(x.dtype).float(), b.to(x.dtype).float())
    return out.to(x.dtype)


def skip_lora_bwd_ref(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Adapter grads for all layers -> (gA (L, D, R), gB (L, R, D)) fp32.

    gB[l] = (x[l] a[l])^T g ;  gA[l] = x[l]^T (g b[l]^T). No gradient for x:
    cached activations are constants (the paper's frozen backbone)."""
    z = torch.einsum("lmd,ldr->lmr", x.float(), a.to(x.dtype).float()).to(x.dtype)
    gb = torch.einsum("lmr,md->lrd", z.float(), g.float())
    gz = torch.einsum("md,lrd->lmr", g.float(), b.to(g.dtype).float()).to(x.dtype)
    ga = torch.einsum("lmd,lmr->ldr", x.float(), gz.float())
    return ga, gb


def skip_lora_int8_fwd_ref(
    q: torch.Tensor, scale: torch.Tensor, a: torch.Tensor, b: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    """int8 variant: x[l] = q[l] * scale[l][:, None], dequantised to ``dtype``.

    q: (L, M, D) int8; scale: (L, M) fp32 -> (M, D) in ``dtype``."""
    x = (q.float() * scale[..., None]).to(dtype)
    return skip_lora_fwd_ref(x, a.to(dtype), b.to(dtype))


def skip_lora_grouped_ref(
    x: torch.Tensor, a_pool: torch.Tensor, b_pool: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Per-row multi-adapter sum: out[m] = sum_l x[l,m] @ A[idx[m],l] @ B[idx[m],l].

    x: (L, M, D); a_pool: (N, L, D, R); b_pool: (N, L, R, D); idx: (M,) int
    -> (M, D) in x.dtype. Materialises the per-row adapter gather."""
    idx = idx.long()
    a_r = a_pool[idx].to(x.dtype).float()   # (M, L, D, R)
    b_r = b_pool[idx].to(x.dtype).float()   # (M, L, R, D)
    z = torch.einsum("lmd,mldr->mlr", x.float(), a_r)
    out = torch.einsum("mlr,mlrd->md", z.to(x.dtype).float(), b_r)
    return out.to(x.dtype)


def skip_lora_grouped_int8_ref(
    x: torch.Tensor,
    qa: torch.Tensor,
    sa: torch.Tensor,
    qb: torch.Tensor,
    sb: torch.Tensor,
    idx: torch.Tensor,
) -> torch.Tensor:
    """int8-pool version: dequantise the whole pool in fp32, then the float
    version. qa: (N, L, D, R) int8 with sa (N, L, D); qb: (N, L, R, D) int8
    with sb (N, L, R) (rowwise over the last axis, as
    ``core.lm_skiplora.quantize_int8`` makes them)."""
    a_pool = qa.float() * sa[..., None]
    b_pool = qb.float() * sb[..., None]
    return skip_lora_grouped_ref(x, a_pool, b_pool, idx)


def skip_lora_grouped_q4_ref(
    x: torch.Tensor,
    qa: torch.Tensor,
    sa: torch.Tensor,
    qb: torch.Tensor,
    sb: torch.Tensor,
    code: torch.Tensor,
    idx: torch.Tensor,
) -> torch.Tensor:
    """Packed-4-bit-pool version: unpack and dequantise the whole pool in
    fp32 (``code[nibble] * scale``), then the float version. qa: (N, L, D,
    R//2) uint8 with sa (N, L, D); qb: (N, L, R, D//2) with sb (N, L, R);
    code: the 16-entry codebook. Differentiable in (sa, sb)."""
    a_pool = dequantize_q4(qa, sa, code)
    b_pool = dequantize_q4(qb, sb, code)
    return skip_lora_grouped_ref(x, a_pool, b_pool, idx)


def skip_lora_grouped_actint8_ref(
    q: torch.Tensor,
    scale: torch.Tensor,
    a_pool: torch.Tensor,
    b_pool: torch.Tensor,
    idx: torch.Tensor,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """int8-activation version: rows dequantised to ``dtype``
    (``q * scale``), the float pool cast to ``dtype``, then the float
    version; the output is in ``dtype``. q: (L, M, D) int8; scale: (L, M)
    fp32."""
    x = (q.float() * scale[..., None]).to(dtype)
    return skip_lora_grouped_ref(x, a_pool.to(dtype), b_pool.to(dtype), idx)


def skip_lora_grouped_bwd_ref(
    x: torch.Tensor,
    a_pool: torch.Tensor,
    b_pool: torch.Tensor,
    g: torch.Tensor,
    idx: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot adapter grads of the grouped skip-sum -> (gA (N, L, D, R),
    gB (N, L, R, D)) fp32; a slot with no rows gets exact zeros.

    gB[n, l] = sum_{m: idx[m] = n} cast_x(x[l, m] A[n, l])^T g[m];
    gA[n, l] = sum_{m: idx[m] = n} x[l, m]^T cast_x(g[m] B[n, l]^T).
    x: (L, M, D); g: (M, D) (cast to x.dtype); idx: (M,). The reference's
    version forms (M, L, D, R) per-row products; this one takes each slot's
    rows and runs ``skip_lora_bwd_ref``'s four einsums on them, the same
    function at a size the card holds at the fleet shape."""
    n = a_pool.shape[0]
    idx = idx.long()
    g = g.to(x.dtype)
    ga = torch.zeros((n,) + tuple(a_pool.shape[1:]), dtype=torch.float32, device=x.device)
    gb = torch.zeros((n,) + tuple(b_pool.shape[1:]), dtype=torch.float32, device=x.device)
    for s in range(n):
        rows = torch.nonzero(idx == s)[:, 0]
        if rows.numel():
            ga[s], gb[s] = skip_lora_bwd_ref(x[:, rows], a_pool[s], b_pool[s], g[rows])
    return ga, gb
