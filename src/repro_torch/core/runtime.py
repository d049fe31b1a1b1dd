"""Generation entry points: ``generate`` and ``generate_grouped``.

Counterpart of the two generation functions of ``repro.core.runtime``: one
prefill, then ``decode_scan``'s loop of ``max_new`` decode steps. The
reference's ``SessionRuntime`` (pool + cache engine + fleet adapt) and its
compiled-function cache wait for a later slice; eager PyTorch needs no
trace cache.

Both run on ``device`` ("cuda" unless the caller asks for "cpu"); params and
pool must already live there. On a CUDA device the grouped skip-sum goes
through the hand-written kernels, on the CPU through their plain versions.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.lm import (
    decode_scan,
    init_serve_caches,
    sample_token,
    serve_prefill,
    serve_prefill_grouped,
)

Params = Any


def _on_device(params: Params, tokens, device) -> tuple[torch.Tensor, torch.device]:
    device = torch.device(device)
    table = params["embed"]["table"]
    if table.device.type != device.type:
        raise ValueError(f"params live on {table.device}, generation asked for {device}")
    return torch.as_tensor(tokens, device=table.device), table.device


@torch.no_grad()
def generate(
    params: Params,
    cfg,
    tokens,
    *,
    max_new: int,
    adapters_stack: Optional[list[Params]] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """Batched generation with optional single-stack adapters (per-layer
    list, see ``lm_skiplora.adapters_to_stack``). Returns (B, max_new)."""
    tokens, dev = _on_device(params, tokens, device)
    b, s = tokens.shape
    caches = init_serve_caches(cfg, b, s + max_new, device=dev)
    logits, caches = serve_prefill(params, cfg, tokens, caches, adapters=adapters_stack)
    tok0 = sample_token(logits, temperature, generator)
    toks, _ = decode_scan(
        params, cfg, tok0, s, caches, max_new=max_new, temperature=temperature,
        generator=generator, adapters=adapters_stack,
    )
    return toks


@torch.no_grad()
def generate_grouped(
    params: Params,
    cfg,
    tokens,
    pools: dict[str, torch.Tensor],
    idx: torch.Tensor,
    *,
    max_new: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """Multi-tenant generation: batch row b decodes under adapter slot
    ``idx[b]`` of the stacked pool (float or int8 layout, see
    ``AdapterPool.pools()``). One grouped skip-sum launch for the prefill and
    one per decode step: ``1 + max_new`` per call. Returns (B, max_new)."""
    tokens, dev = _on_device(params, tokens, device)
    b, s = tokens.shape
    caches = init_serve_caches(cfg, b, s + max_new, device=dev)
    logits, caches = serve_prefill_grouped(params, cfg, tokens, caches, pools, idx)
    tok0 = sample_token(logits, temperature, generator)
    toks, _ = decode_scan(
        params, cfg, tok0, s, caches, max_new=max_new, temperature=temperature,
        generator=generator, pools=pools, idx=idx,
    )
    return toks
