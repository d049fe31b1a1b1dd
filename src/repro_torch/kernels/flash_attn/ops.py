"""Public wrapper for flash attention: the counterpart of
``repro.kernels.flash_attn.ops``, in the framework layout q (B, H, S, hd),
k/v (B, Hkv, S, hd).

Forward only, as in the reference: the populate pass never runs a backward
through the backbone. Dispatch follows the device of q: a CPU tensor goes to
the plain version in ``ref.py``; a CUDA tensor launches the hand-written
kernel in ``kernel.py`` (or raises); any other device raises. The reference
folds GQA by repeating each KV head across its query group; the kernel
folds it by reading KV head ``h // group`` for query head ``h``, which gives
the same result without the copy. The reference kernel wants S to be a
multiple of its 128-row tile; the CUDA kernel masks a ragged tail and takes
any S.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import kernel as K
from repro_torch.kernels.flash_attn import ref as R


def flash_attention(
    q: torch.Tensor,   # (B, H, S, hd)
    k: torch.Tensor,   # (B, Hkv, S, hd)
    v: torch.Tensor,   # (B, Hkv, S, hd)
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, GQA-aware -> (B, H, S, hd)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return R.flash_attention_ref(q, k, v, window=window, softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    return K.flash_attn_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                            window=window, softcap=softcap, scale=scale)
