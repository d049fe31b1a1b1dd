"""Plain PyTorch version of flash attention (causal, sliding window, GQA,
softcap): the counterpart of ``repro.kernels.flash_attn.ref``. It is what
``ops.flash_attention`` runs on CPU tensors and what the CUDA kernel is held
against on the card. It materialises the (S, S) scores."""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def flash_attention_ref(
    q: torch.Tensor,    # (B, H, S, hd)
    k: torch.Tensor,    # (B, Hkv, S, hd)
    v: torch.Tensor,    # (B, Hkv, S, hd)
    *,
    window: int = 0,    # 0 -> full causal
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    group = h // hkv
    scale = scale if scale is not None else hd**-0.5
    qg = q.reshape(b, hkv, group, s, hd)
    logits = torch.einsum("bngsh,bnth->bngst", (qg * scale).float(), k.float())
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    mask = kj <= qi
    if window > 0:
        mask &= kj > qi - window
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,bnth->bngsh", probs.float(), v.float()).to(q.dtype)
    return out.reshape(b, h, s, hd)
