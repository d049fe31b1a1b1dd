"""Blockwise-int8 optimizer state and gradient compression.

Counterpart of ``repro.optim.quantized``, over the port's
``optim.optimizers`` (``Optimizer``, ``OptState``, ``tree_map``):

  - ``int8_adamw``: AdamW whose moments are stored as int8 with one fp32
    scale per block of 128 elements, 3.6x smaller than fp32 moments; the
    second moment is kept in the sqrt domain, as the reference keeps it.
    Dequantise -> update -> requantise runs as plain tensor ops.
  - gradient compression for a data-parallel all-reduce: rowwise int8
    (``compress_grads`` / ``decompress_grads``) and top-k sparsification
    (``topk_sparsify``) with error feedback.

``torch.round`` rounds half to even, as ``jnp.round`` does, and every
division and root is correctly rounded (``_over_127``, ``_sqrt``), so the
int8 codes are the reference's bit for bit on the CPU, and the card's are
the CPU's.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.optimizers import Optimizer, OptState, tree_leaves, tree_map

Params = Any

BLOCK = 128


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), x.numel()


def _over_127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 correctly rounded on every device: CUDA divides by a host
    scalar as a product with its reciprocal, so the divisor is a tensor."""
    return x / torch.full((), 127.0, device=x.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """fp32 sqrt correctly rounded on every device: the card's fp32 sqrt is
    an ulp off for some inputs (a moment code then flips between the card
    and the CPU); the fp64 root rounded to fp32 is the correctly rounded
    fp32 root (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def quantize_blockwise(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """fp -> {q int8 (nblocks, BLOCK), scale fp32 (nblocks,)}."""
    blocks, _ = _pad_to_block(x.float())
    amax = torch.amax(torch.abs(blocks), dim=1)
    scale = _over_127(torch.clamp(amax, min=1e-12))
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_blockwise(qs: dict[str, torch.Tensor], shape, dtype=torch.float32) -> torch.Tensor:
    flat = (qs["q"].float() * qs["scale"][:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def int8_adamw(
    lr: float,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """AdamW with int8 blockwise moments (bitsandbytes-style)."""

    def init(params):
        zeros = lambda p: quantize_blockwise(torch.zeros(p.shape, device=p.device))  # noqa: E731
        leaves = tree_leaves(params)
        step = torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)
        return OptState(step=step, mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def update(grads, state, params=None):
        step = state.step + 1
        stepf = step.float()
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        def upd_one(g, mq, vq, p):
            m = dequantize_blockwise(mq, g.shape)
            # v in the sqrt domain: linear int8 on v itself destroys small
            # entries (the update m / sqrt(v) is 1/sqrt-sensitive).
            v = torch.square(dequantize_blockwise(vq, g.shape))
            gf = g.float()
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * torch.square(gf)
            u = -lr * (m / bc1) / (_sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr * weight_decay * p.float()
            return u, quantize_blockwise(m), quantize_blockwise(_sqrt(v))

        rest = params if params is not None else tree_map(lambda g: None, grads)
        outs = _map_moments(upd_one, grads, state.mu, state.nu, rest)
        pick = lambda i: _map_moments(lambda o: o[i], outs)  # noqa: E731
        return pick(0), OptState(step=step, mu=pick(1), nu=pick(2))

    return Optimizer(init, update)


def _map_moments(fn, tree, *rest):
    """``tree_map`` whose leaves are the grads' tensors: a moment's
    {"q", "scale"} dict and an ``upd_one`` result tuple count as leaves."""
    if isinstance(tree, dict):
        return {k: _map_moments(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_moments(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Gradient compression (for a bandwidth-bound data-parallel all-reduce)
# ---------------------------------------------------------------------------


class CompressedGrads(NamedTuple):
    q: Params      # int8 tree
    scale: Params  # fp32 rowwise scales


def compress_grads(grads: Params) -> CompressedGrads:
    """Rowwise int8: 4x (fp32) / 2x (bf16) smaller all-reduce payloads."""

    def q(g):
        gf = g.float()
        return torch.clamp(torch.round(gf / _row_scale(gf)), -127, 127).to(torch.int8)

    return CompressedGrads(tree_map(q, grads), tree_map(lambda g: _row_scale(g.float()), grads))


def _row_scale(gf: torch.Tensor) -> torch.Tensor:
    amax = torch.amax(torch.abs(gf), dim=-1, keepdim=True)
    return _over_127(torch.clamp(amax, min=1e-12))


def decompress_grads(c: CompressedGrads, like: Params) -> Params:
    return tree_map(lambda q, s, g: (q.float() * s).to(g.dtype), c.q, c.scale, like)


def topk_sparsify(g: torch.Tensor, k_fraction: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep the top-k |values| (flat); returns (values, indices). Use with
    error feedback: residual = g - scatter(values)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * k_fraction))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx


def error_feedback_residual(g: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    flat = g.reshape(-1)
    kept = torch.zeros_like(flat)
    kept[idx] = flat[idx]
    return (flat - kept).reshape(g.shape)
