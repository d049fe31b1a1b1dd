"""Feed-forward blocks: plain MLP, SwiGLU/GeGLU gated variants.

Counterpart of ``repro.models.ffn``: weights ``w_gate``/``w_up`` (D, F) and
``w_down`` (F, D), products in the activation dtype. The down projection
goes through ``remat.product``: in the tail of a rematerialised region
(``remat.tail()``) the backward's replay leaves it out.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import remat as RM
from repro_torch.models.layers import activation

Params = Any


def _normal(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, device=generator.device) * scale
    return w.to(dtype)


def init_ffn(generator: torch.Generator, d: int, d_ff: int, *, gated: bool, dtype) -> Params:
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(d_ff)
    p = {}
    if gated:
        p["w_gate"] = _normal(generator, (d, d_ff), s_in, dtype)
    p["w_up"] = _normal(generator, (d, d_ff), s_in, dtype)
    p["w_down"] = _normal(generator, (d_ff, d), s_out, dtype)
    return p


def ffn(params: Params, x: torch.Tensor, *, act: str, gated: bool) -> torch.Tensor:
    dtype = x.dtype
    if gated:
        g = activation(act, x @ params["w_gate"].to(dtype))
        u = x @ params["w_up"].to(dtype)
        return RM.product(g * u, params["w_down"].to(dtype))
    h = activation(act, x @ params["w_up"].to(dtype))
    return RM.product(h, params["w_down"].to(dtype))
