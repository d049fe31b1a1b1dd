"""Packed 4-bit adapter quantisation (int4, nf4).

Counterpart of ``repro.kernels.skip_lora.quant``. Both formats share one
storage layout, so the grouped kernel K7, its plain version and the pool
need a single dequantisation path:

  - payload: two 4-bit codebook indices packed a byte along the LAST axis
    (even positions in the low nibble, odd in the high nibble): ``(..., K)``
    float rows become ``(..., K // 2)`` ``torch.uint8``;
  - scale: fp32 rowwise absmax over the last axis, ``(...,)``;
  - code: a 16-entry fp32 codebook of levels in ``[-8/7, 1]``.

Dequantisation is ``code[nibble] * scale[..., None]`` for either format;
the formats differ only in the codebook: ``int4`` has the uniform levels
``(i - 8) / 7`` (quantisation clips to [-7, 7], so index 0 is never made),
``nf4`` the QLoRA NormalFloat4 levels. A zero row quantises to the exact-zero
level (int4 index 8, nf4 index 7) with scale 0, so the pool's pinned zero
slot dequantises to exact zeros. Payload and scales are bitwise the
reference's on the same input.
"""

from __future__ import annotations

import torch

#: Uniform symmetric int4 levels: dequant (nib - 8) / 7 * absmax.
INT4_CODE = ((torch.arange(16, dtype=torch.int32) - 8) / 7.0).to(torch.float32)

#: QLoRA NormalFloat4 levels (Dettmers et al., 2023), exact zero at index 7.
NF4_CODE = torch.tensor(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=torch.float32,
)

Q4_KINDS = ("int4", "nf4")


def codebook(kind: str, device=None) -> torch.Tensor:
    """The 16-entry fp32 codebook of ``kind`` on ``device``."""
    if kind == "int4":
        return INT4_CODE.to(device)
    if kind == "nf4":
        return NF4_CODE.to(device)
    raise ValueError(f"unknown 4-bit kind {kind!r} (want one of {Q4_KINDS})")


def pack_nibbles(nib: torch.Tensor) -> torch.Tensor:
    """(..., K) values in [0, 15] -> (..., K // 2) uint8, even last-axis
    positions in the low nibble (``unpack_nibbles`` is the exact inverse).
    K must be even."""
    if nib.shape[-1] % 2:
        raise ValueError(f"last axis {nib.shape[-1]} must be even to pack")
    lo = nib[..., 0::2].to(torch.uint8)
    hi = nib[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(..., P) packed bytes -> (..., 2P) uint8 nibble indices in [0, 15]."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[:-1] + (2 * packed.shape[-1],))


def quantize_q4(x: torch.Tensor, kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Rowwise (last-axis) 4-bit quantisation into the shared layout.

    x: (..., K) float, K even -> (packed (..., K // 2) uint8, scale (...,)
    fp32 rowwise absmax). Dequantisation: ``code[nib] * scale``."""
    x = x.float()
    scale = torch.amax(torch.abs(x), dim=-1)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    if kind == "int4":
        # torch.round rounds half to even, like jnp.round
        q = torch.clamp(torch.round(x / safe * 7.0), -7, 7)
        nib = (q + 8).to(torch.uint8)
    elif kind == "nf4":
        xn = x / safe
        # argmin takes the first of equal distances, as jnp.argmin does
        nib = torch.argmin(torch.abs(xn[..., None] - NF4_CODE.to(x.device)), dim=-1).to(torch.uint8)
    else:
        raise ValueError(f"unknown 4-bit kind {kind!r} (want one of {Q4_KINDS})")
    return pack_nibbles(nib), scale


def dequantize_q4(packed: torch.Tensor, scale: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_q4``: (..., P) bytes + (...,) scales -> (..., 2P)
    fp32. ``code`` is the 16-entry codebook the indices address."""
    nib = unpack_nibbles(packed).long()
    return code.reshape(16)[nib] * scale[..., None]
