"""Plain PyTorch versions of the Skip-LoRA kernels.

Counterparts of ``repro.kernels.skip_lora.ref``. They are what the op
wrappers run on CPU tensors, and what the CUDA kernels are held against on
the card. Products accumulate in fp32, ``z`` is cast to ``x.dtype``
between them, and the adapters are cast to ``x.dtype`` before use.
"""

from __future__ import annotations

import torch


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
