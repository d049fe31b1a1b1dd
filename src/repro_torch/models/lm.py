"""TransformerLM: embedding -> layer stack -> final norm -> readout.

Counterpart of ``repro.models.lm``:
  - ``init_lm`` / ``lm_forward``: parameter init and the train / prefill /
    decode forward, with optional single-stack Skip-LoRA adapters and
    activation collection (for Skip-Cache population).
  - ``lm_loss_rows`` / ``lm_loss`` / ``train_loss_fn``: next-token cross
    entropy with a chunked fp32 readout that never holds (B, S, vocab)
    logits.
  - ``init_serve_caches``: per-layer bf16 KV caches.
  - ``serve_prefill`` / ``serve_decode`` and the multi-tenant ``_grouped``
    variants, whose skip term goes through the grouped skip-LoRA kernels.
  - ``sample_token``, ``decode_step`` and ``decode_scan``: the reference
    scans over decode steps; here ``decode_scan`` is a Python loop of
    exactly ``max_new`` steps, so tokens and final caches compare one to one.

Params are plain dicts of tensors: {"embed": {"table"}, "stack": [per-layer
dicts], "final_norm", and "head" when embeddings are untied}.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, embed, init_embedding, make_norm, softcap, unembed

Params = Any


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params from ``generator``; tensors live on ``generator.device``.
    Same shapes and dtypes as the reference's ``init_lm`` (not the same
    numbers: torch and JAX draw differently from one seed)."""
    B.check_supported(cfg)
    dtype = model_dtype(cfg)
    params = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype),
        "stack": B.init_stack(generator, cfg, dtype),
        "final_norm": make_norm(cfg.norm_type, cfg.d_model, device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype)
    return params


def lm_forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                    # (B, S) int
    *,
    mode: str = "train",                     # "train" | "prefill" | "decode"
    caches: Optional[list[Params]] = None,
    pos: Optional[int] = None,
    adapters: Optional[list[Params]] = None,
    collect_acts: bool = False,
    prefix_embeds: Optional[torch.Tensor] = None,
) -> dict[str, Any]:
    """Returns {"h": final hidden (pre-norm, incl. skip term), "caches",
    "acts", "y_base": final hidden *without* the skip term}. Modality
    prefixes (``prefix_embeds``) need a frontend, which is not ported."""
    B.check_supported(cfg)
    if prefix_embeds is not None:
        raise NotImplementedError("prefix_embeds need a modality frontend, which is not ported")
    dtype = model_dtype(cfg)
    h = embed(params["embed"], tokens, scale_by_sqrt_dim=cfg.scale_embed_by_sqrt_dim, dtype=dtype)
    out = B.stack_forward(
        params["stack"], h, cfg, mode=mode, caches=caches, pos=pos,
        adapters=adapters, collect_acts=collect_acts,
    )
    y_base = out["h"]
    y = y_base + out["skip"].to(y_base.dtype) if adapters is not None else y_base
    return {"h": y, "y_base": y_base, "caches": out["caches"], "acts": out["acts"]}


def readout(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + unembed (+ gemma2 final softcap). h: (..., D) -> logits."""
    hn = apply_norm(
        cfg.norm_type, params["final_norm"], h, eps=cfg.norm_eps,
        unit_offset=cfg.rmsnorm_unit_offset,
    )
    table = params["head"] if not cfg.tie_embeddings else params["embed"]
    logits = unembed(table, hn)
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits


class _ChunkLogLik(torch.autograd.Function):
    """Log-likelihood sums of one readout chunk: hn (B, c, D) normed hidden,
    table (V, D) frozen fp32 readout, labels (B, c) with -1 masked -> (ll (B,),
    count (B,)) fp32.

    The (B, c, V) fp32 logits live only inside the forward, which also
    computes the gradient for hn when one is wanted: d ll / d logits =
    mask (onehot - softmax), through the softcap, times the table. The
    backward scales it by the upstream gradient of ``ll``. The reference
    gets the same by rematerialising each chunk in its backward
    (``jax.checkpoint``), which computes the vocab-wide product three times
    per chunk; here it is computed twice."""

    @staticmethod
    def forward(ctx, hn, table, labels, cap):
        logits = hn.float() @ table.T
        if cap:
            logits = softcap(logits, cap)
        logp = torch.log_softmax(logits, dim=-1)
        mask = (labels >= 0).float()
        tgt = torch.clamp(labels, min=0)[..., None].long()
        ll = torch.gather(logp, -1, tgt)[..., 0]
        total, count = torch.sum(ll * mask, dim=-1), torch.sum(mask, dim=-1)
        ctx.hn_dtype = hn.dtype
        if ctx.needs_input_grad[0]:
            dlogits = logp.exp_().neg_()          # -softmax, in place of logp
            dlogits.scatter_add_(-1, tgt, torch.ones_like(tgt, dtype=dlogits.dtype))
            dlogits.mul_(mask[..., None])
            if cap:
                dlogits.mul_(1 - torch.square(logits / cap))
            del logits
            ctx.save_for_backward(dlogits @ table)
        return total, count

    @staticmethod
    def backward(ctx, g_total, g_count):
        (g_hn,) = ctx.saved_tensors
        return (g_hn * g_total[:, None, None]).to(ctx.hn_dtype), None, None, None


def lm_loss_rows(
    params: Params,
    cfg: ModelConfig,
    h: torch.Tensor,                    # (B, S, D) final hidden (pre-norm)
    labels: torch.Tensor,               # (B, S) int; -1 = masked
    *,
    chunk: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row next-token log-likelihood sums with chunked readout ->
    (ll (B,) fp32 summed log-likelihood per row, count (B,) fp32 unmasked
    tokens per row). A ragged tail chunk is padded with label -1. The
    readout table is frozen: it gets no gradient."""
    b, s, d = h.shape
    hn = apply_norm(
        cfg.norm_type, params["final_norm"], h, eps=cfg.norm_eps,
        unit_offset=cfg.rmsnorm_unit_offset,
    )
    table = (params["head"] if not cfg.tie_embeddings else params["embed"])["table"]
    if table.requires_grad:
        raise NotImplementedError("the chunked readout loss takes a frozen readout table")
    table = table.float()   # once for all chunks
    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    padded = n_chunks * chunk
    if padded > s:
        hn = torch.nn.functional.pad(hn, (0, 0, 0, padded - s))
        labels = torch.nn.functional.pad(labels, (0, padded - s), value=-1)
    total = torch.zeros((b,), dtype=torch.float32, device=h.device)
    count = torch.zeros((b,), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        ll, m = _ChunkLogLik.apply(hn[:, sl], table, labels[:, sl], cfg.final_softcap)
        total, count = total + ll, count + m
    return total, count


def lm_loss(
    params: Params,
    cfg: ModelConfig,
    h: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk: int = 512,
) -> torch.Tensor:
    """Mean next-token cross entropy with chunked readout."""
    total, count = lm_loss_rows(params, cfg, h, labels, chunk=chunk)
    return -torch.sum(total) / torch.clamp(torch.sum(count), min=1.0)


def train_loss_fn(
    params: Params,
    cfg: ModelConfig,
    batch: dict[str, torch.Tensor],
    *,
    adapters: Optional[list[Params]] = None,
) -> torch.Tensor:
    """Loss of one batch {"tokens", "labels"} through the train forward,
    with optional per-layer adapters (``lm_skiplora.adapters_to_stack``)."""
    out = lm_forward(
        params, cfg, batch["tokens"], mode="train", adapters=adapters,
        prefix_embeds=batch.get("prefix_embeds"),
    )
    return lm_loss(params, cfg, out["h"], batch["labels"])


def init_serve_caches(cfg: ModelConfig, batch: int, max_seq: int, *, device) -> list[Params]:
    """bf16 KV caches whatever the model dtype, as the reference makes them."""
    return B.init_stack_caches(batch, max_seq, cfg, torch.bfloat16, device=device)


def serve_prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    caches: list[Params],
    *,
    adapters: Optional[list[Params]] = None,
) -> tuple[torch.Tensor, list[Params]]:
    """Prefill: process the prompt, return (last-position logits, caches)."""
    out = lm_forward(params, cfg, tokens, mode="prefill", caches=caches, adapters=adapters)
    return readout(params, cfg, out["h"][:, -1:]), out["caches"]


def serve_decode(
    params: Params,
    cfg: ModelConfig,
    token: torch.Tensor,     # (B, 1)
    pos: int,
    caches: list[Params],
    *,
    adapters: Optional[list[Params]] = None,
) -> tuple[torch.Tensor, list[Params]]:
    """One decode step: returns (logits (B,1,V), caches)."""
    out = lm_forward(params, cfg, token, mode="decode", caches=caches, pos=pos, adapters=adapters)
    return readout(params, cfg, out["h"]), out["caches"]


# ---------------------------------------------------------------------------
# Multi-tenant (grouped) serving: per-row adapter slots from a stacked pool
# ---------------------------------------------------------------------------


def serve_prefill_grouped(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    caches: list[Params],
    pools: dict[str, torch.Tensor],   # AdapterPool.pools() layout (float or int8)
    idx: torch.Tensor,                # (B,) int32 slot per batch row
) -> tuple[torch.Tensor, list[Params]]:
    """Prefill with per-row adapters. The backbone runs adapter-free,
    activations are collected, and one grouped skip-sum over the *last*
    position yields the per-tenant logits."""
    from repro_torch.core.adapter_pool import grouped_skip_sum

    out = lm_forward(params, cfg, tokens, mode="prefill", caches=caches, collect_acts=True)
    y_last = out["y_base"][:, -1:]
    skip = grouped_skip_sum(out["acts"][:, :, -1:], pools, idx)
    logits = readout(params, cfg, y_last + skip.to(y_last.dtype))
    return logits, out["caches"]


def serve_decode_grouped(
    params: Params,
    cfg: ModelConfig,
    token: torch.Tensor,              # (B, 1)
    pos: int,
    caches: list[Params],
    pools: dict[str, torch.Tensor],
    idx: torch.Tensor,                # (B,) int32
) -> tuple[torch.Tensor, list[Params]]:
    """One grouped decode step: per-row adapters via one grouped skip-sum
    over the (L, B, 1, D) collected block inputs."""
    from repro_torch.core.adapter_pool import grouped_skip_sum

    out = lm_forward(params, cfg, token, mode="decode", caches=caches, pos=pos, collect_acts=True)
    skip = grouped_skip_sum(out["acts"], pools, idx)
    y = out["y_base"] + skip.to(out["y_base"].dtype)
    return readout(params, cfg, y), out["caches"]


# ---------------------------------------------------------------------------
# Decode loop
# ---------------------------------------------------------------------------


def sample_token(
    logits: torch.Tensor,                       # (B, 1, V)
    temperature: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Greedy (``temperature <= 0``) or temperature sampling -> (B, 1) int64.

    Greedy picks the first maximum, as ``jnp.argmax`` does, so temperature-0
    tokens equal the reference's. Temperature > 0 draws from ``generator``
    (a ``torch.Generator`` on the logits' device) and cannot reproduce JAX's
    PRNG stream."""
    if temperature > 0:
        probs = torch.softmax((logits[:, 0] / temperature).float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(logits, dim=-1)


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tok: torch.Tensor,             # (B, 1)
    pos: int,
    caches: list[Params],
    *,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    adapters: Optional[list[Params]] = None,
    pools: Optional[dict[str, torch.Tensor]] = None,
    idx: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, list[Params]]:
    """One decode step at position ``pos``: returns (next token (B, 1),
    caches). ``pools``/``idx`` select the grouped path, ``adapters`` the
    single-stack path."""
    if pools is not None:
        logits, caches = serve_decode_grouped(params, cfg, tok, pos, caches, pools, idx)
    else:
        logits, caches = serve_decode(params, cfg, tok, pos, caches, adapters=adapters)
    return sample_token(logits, temperature, generator), caches


def decode_scan(
    params: Params,
    cfg: ModelConfig,
    tok0: torch.Tensor,            # (B, 1) first generated token
    start_pos: int,                # position of tok0
    caches: list[Params],
    *,
    max_new: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    adapters: Optional[list[Params]] = None,
    pools: Optional[dict[str, torch.Tensor]] = None,
    idx: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, list[Params]]:
    """Generate ``max_new`` tokens: exactly ``max_new`` decode steps, as the
    reference's scan runs (the last step's token is dropped, its K/V kept).
    Returns (tokens (B, max_new) with tok0 first, final caches)."""
    toks = []
    tok = tok0
    for i in range(max_new):
        toks.append(tok)
        tok, caches = decode_step(
            params, cfg, tok, start_pos + i, caches, temperature=temperature,
            generator=generator, adapters=adapters, pools=pools, idx=idx,
        )
    return torch.cat(toks, dim=1), caches
