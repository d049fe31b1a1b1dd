"""Hopper CUDA kernel for causal flash attention (K4), bound with ``ctypes``.

``flash_attn_fwd`` (``csrc/flash_attn_fwd.cu``) replaces
``repro/kernels/flash_attn/kernel.py::flash_attention_fwd``. It is built by
``nvcc`` for ``sm_90a`` at first use (``kernels/build.py``); nothing is
built or loaded at import time. The launch function checks devices, types,
shapes and contiguity, allocates the output, launches on the current
stream, raises on a nonzero CUDA error code, and counts its launches in
``LAUNCHES``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels.build import F, I, KernelLib, P, check, check_tensor

CSRC = Path(__file__).resolve().parent / "csrc"
#: kernel name -> its source file under csrc/
SOURCES = {"flash_attn_fwd": "flash_attn_fwd.cu"}
LIB = KernelLib(CSRC, SOURCES, {"flash_attn_fwd": [P] * 4 + [I] * 6 + [F, F, I, P]})

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = LIB.launches
reset_launches = LIB.reset_launches
build = LIB.build

#: largest head_dim the kernel takes
HD_MAX = 256


def flash_attn_fwd(
    q: torch.Tensor,    # (B, H, S, hd) fp32 / bf16
    k: torch.Tensor,    # (B, Hkv, S, hd), same dtype
    v: torch.Tensor,    # (B, Hkv, S, hd), same dtype
    *,
    window: int,
    softcap: float,
    scale: float,
) -> torch.Tensor:
    """K4 on the card -> (B, H, S, hd) in q.dtype. Query head h reads KV head
    h // (H / Hkv) of its batch row: the GQA fold needs no repeated K/V."""
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    check(1 <= hd <= HD_MAX, f"head_dim {hd} outside 1..{HD_MAX}")
    check(hkv >= 1 and h % hkv == 0, f"{h} query heads do not divide into {hkv} KV heads")
    fdt = (torch.float32, torch.bfloat16)
    check_tensor(q, "q", q.device, (b, h, s, hd), fdt)
    check_tensor(k, "k", q.device, (b, hkv, s, hd), (q.dtype,))
    check_tensor(v, "v", q.device, (b, hkv, s, hd), (q.dtype,))
    out = torch.empty_like(q)
    LIB.launch("flash_attn_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               b * h, h, h // hkv, s, hd, int(window), float(softcap), float(scale),
               int(q.dtype == torch.bfloat16))
    return out
