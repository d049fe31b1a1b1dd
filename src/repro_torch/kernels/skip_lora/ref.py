"""Plain PyTorch versions of the grouped Skip-LoRA kernels.

Counterparts of ``repro.kernels.skip_lora.ref``. They are what the op
wrappers run on CPU tensors, and what the CUDA kernels are held against on
the card. Both products accumulate in fp32, ``z`` is cast to ``x.dtype``
between them, and the adapters are cast to ``x.dtype`` before use.
"""

from __future__ import annotations

import torch


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
