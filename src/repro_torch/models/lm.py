"""TransformerLM: embedding -> layer stack -> final norm -> readout.

Counterpart of ``repro.models.lm``:
  - ``init_lm`` / ``lm_forward``: parameter init and the train / prefill /
    decode forward, with optional single-stack Skip-LoRA adapters and
    activation collection (for Skip-Cache population).
  - ``lm_loss_rows`` / ``lm_loss`` / ``train_loss_fn``: next-token cross
    entropy with a chunked fp32 readout that never holds (B, S, vocab)
    logits.
  - ``init_serve_caches``: per-layer serve caches (bf16 KV caches, and the
    recurrent blocks' states with bf16 conv windows).
  - ``serve_prefill`` / ``serve_decode`` and the multi-tenant ``_grouped``
    variants, whose skip term goes through the grouped skip-LoRA kernels.
  - ``ingest_prefill``: the session runtime's ingest forward, which fills
    the Skip-Cache and returns each row's adapted last-position logits.
  - ``sample_token``, ``decode_step``, ``decode_step_`` and ``decode_scan``:
    the reference scans over decode steps in one dispatch; here
    ``decode_scan`` replays a CUDA graph of ``unroll`` in-place steps
    (``decode_step_``, captured by ``core.decode_graph``) on the card and
    runs the same steps eagerly on the CPU, exactly ``max_new`` of them, so
    tokens and final caches compare one to one with ``decode_loop``, the
    eager per-step loop. ``decode_step`` also takes per-row positions and
    ``sample_token`` per-row temperatures, for the request scheduler.
  - ``init_stacked_caches``, ``sched_prefill`` and ``sched_prefill_reuse``:
    the request scheduler's admission prefills (dense, and over the unseen
    tail of a prompt whose prefix K/V came from the paged pool);
    ``pipeline_stage_params`` / ``pipeline_sched_prefill``: the dense one
    as GPipe microbatches over a model group's devices.
  - ``param_shapes``: the params on the ``meta`` device.

Params are plain dicts of tensors: {"embed": {"table"}, "stack": [per-layer
dicts], "final_norm", and "head" when embeddings are untied}, or the same
tree split over a model group (``tp.GroupParams``), which every function
here runs as Megatron does (``models.tp``). The forward
returns the MoE FFNs' aux loss beside the hidden states, and
``train_loss_fn`` adds it to the loss. Modality prefixes
(``prefix_embeds``, ``models.frontend``) go ahead of the embedded tokens.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import blocks as B
from repro_torch.models import tp as TP
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontend import splice_prefix
from repro_torch.models.layers import apply_norm, embed, init_embedding, make_norm, softcap, unembed

Params = Any


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def init_parts(generator: torch.Generator, cfg: ModelConfig):
    """``init_lm``'s draws in order, one part at a time: (key, tree) for
    "embed", ``("stack", i)`` for layer i, "final_norm" and, untied,
    "head". ``put_part`` places each into a tree."""
    dtype = model_dtype(cfg)
    yield "embed", init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype)
    for i, kind in enumerate(cfg.layer_kinds()):
        yield ("stack", i), B.init_block(generator, kind, i, cfg, dtype)
    yield "final_norm", make_norm(cfg.norm_type, cfg.d_model, device=generator.device)
    if not cfg.tie_embeddings:
        yield "head", init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype)


def put_part(params: Params, key, tree: Params) -> None:
    """Place one of ``init_parts``' parts into ``params``."""
    if isinstance(key, tuple):
        params.setdefault("stack", []).append(tree)
    else:
        params[key] = tree


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params from ``generator``; tensors live on ``generator.device``.
    Same shapes and dtypes as the reference's ``init_lm`` (not the same
    numbers: torch and JAX draw differently from one seed)."""
    params: Params = {}
    for key, tree in init_parts(generator, cfg):
        put_part(params, key, tree)
    return params


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``: ``init_lm`` then
    makes every tensor on the meta device, shapes and dtypes only."""

    @property
    def device(self):
        return torch.device("meta")


def param_shapes(cfg: ModelConfig) -> Params:
    """``init_lm``'s tree on the ``meta`` device (no memory): the shapes
    ``runtime.sharding``'s spec trees and byte counts read."""
    return init_lm(_MetaGenerator(), cfg)


def lm_forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                    # (B, S) int
    *,
    mode: str = "train",                     # "train" | "prefill" | "decode"
    caches: Optional[list[Params]] = None,
    pos=None,                                # int, or (B,) tensor: see blocks.block_forward
    adapters: Optional[list[Params]] = None,
    collect_acts: bool = False,
    prefix_embeds: Optional[torch.Tensor] = None,
) -> dict[str, Any]:
    """Returns {"h": final hidden (pre-norm, incl. skip term), "caches",
    "acts", "aux": the MoE aux loss, "y_base": final hidden *without* the
    skip term}. ``prefix_embeds`` (B, P, D), a frontend's precomputed
    embeddings, go ahead of the embedded tokens, so every output covers
    P + S positions."""
    h = _embed(params, cfg, tokens)
    h = splice_prefix(h, prefix_embeds)
    out = B.stack_forward(
        params["stack"], h, cfg, mode=mode, caches=caches, pos=pos,
        adapters=adapters, collect_acts=collect_acts,
    )
    y_base = out["h"]
    y = y_base + out["skip"].to(y_base.dtype) if adapters is not None else y_base
    return {"h": y, "y_base": y_base, "caches": out["caches"], "acts": out["acts"], "aux": out["aux"]}


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    fn = TP.embed if TP.is_group(params) else embed
    return fn(params["embed"], tokens, scale_by_sqrt_dim=cfg.scale_embed_by_sqrt_dim, dtype=model_dtype(cfg))


def _final_norm(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return apply_norm(
        cfg.norm_type, TP.local(params["final_norm"]), h, eps=cfg.norm_eps,
        unit_offset=cfg.rmsnorm_unit_offset,
    )


def readout(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + unembed (+ gemma2 final softcap). h: (..., D) -> logits."""
    hn = _final_norm(params, cfg, h)
    table = params["head"] if not cfg.tie_embeddings else params["embed"]
    logits = TP.unembed(table, hn) if TP.is_group(params) else unembed(table, hn)
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits


class _ChunkLogLik(torch.autograd.Function):
    """Log-likelihood sums of one readout chunk: hn (B, c, D) normed hidden,
    table (V, D) fp32 readout, labels (B, c) with -1 masked -> (ll (B,),
    count (B,)) fp32.

    The (B, c, V) fp32 logits live only inside the forward, which also
    computes the gradient for hn when one is wanted and the table is frozen:
    d ll / d logits = mask (onehot - softmax), through the softcap, times
    the table. The backward scales it by the upstream gradient of ``ll``.
    The reference gets the same by rematerialising each chunk in its
    backward (``jax.checkpoint``), which computes the vocab-wide product
    three times per chunk; here it is computed twice. When the table
    trains too (the full-backprop step, ``launch.train``), the forward keeps
    d ll / d logits (B, c, V) and the backward contracts it, scaled by the
    upstream gradient, with the table (for hn) and with hn (for the
    table). A table split by vocabulary over a model group
    (``tp.VocabShards``, frozen) gives the members' logit slices
    concatenated, and the hn gradient as the ordered sum of the members'
    products with their slices."""

    @staticmethod
    def forward(ctx, hn, table, labels, cap):
        split = isinstance(table, TP.VocabShards)
        logits = table.logits(hn.float(), _per_row_matmul) if split else _per_row_matmul(hn.float(), table.T)
        if cap:
            logits = softcap(logits, cap)
        logp = torch.log_softmax(logits, dim=-1)
        mask = (labels >= 0).float()
        tgt = torch.clamp(labels, min=0)[..., None].long()
        ll = torch.gather(logp, -1, tgt)[..., 0]
        total, count = torch.sum(ll * mask, dim=-1), torch.sum(mask, dim=-1)
        ctx.hn_dtype = hn.dtype
        ctx.trains_table = ctx.needs_input_grad[1]
        if ctx.needs_input_grad[0] or ctx.trains_table:
            dlogits = logp.exp_().neg_()          # -softmax, in place of logp
            dlogits.scatter_add_(-1, tgt, torch.ones_like(tgt, dtype=dlogits.dtype))
            dlogits.mul_(mask[..., None])
            if cap:
                dlogits.mul_(1 - torch.square(logits / cap))
            del logits
            if ctx.trains_table:
                ctx.save_for_backward(dlogits, hn, table)
            else:
                ctx.save_for_backward(table.dh(dlogits, _per_row_matmul) if split
                                      else _per_row_matmul(dlogits, table))
        return total, count

    @staticmethod
    def backward(ctx, g_total, g_count):
        if not ctx.trains_table:
            (g_hn,) = ctx.saved_tensors
            return (g_hn * g_total[:, None, None]).to(ctx.hn_dtype), None, None, None
        dlogits, hn, table = ctx.saved_tensors
        g = dlogits * g_total[:, None, None]
        g_hn = (g @ table).to(ctx.hn_dtype) if ctx.needs_input_grad[0] else None
        g_table = g.reshape(-1, g.shape[-1]).T @ hn.float().reshape(-1, hn.shape[-1])
        return g_hn, g_table, None, None


def _per_row_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, K) @ w (K, N) as B products of S rows each, so a row's
    result does not depend on how many rows the batch holds: cuBLAS picks
    its split of K by the product's shape (the vocab-wide K of the readout
    gradient splits differently at 1024 rows than at 512), and a session's
    adapt groups hold as many rows as their shard's tenants."""
    out = torch.empty((*x.shape[:-1], w.shape[-1]), dtype=torch.result_type(x, w), device=x.device)
    for i in range(x.shape[0]):
        torch.matmul(x[i], w, out=out[i])
    return out


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
    tokens per row). A ragged tail chunk is padded with label -1. A
    readout table that requires grad gets its gradient (``_ChunkLogLik``).
    Each row's readout products run on their own (``_per_row_matmul``), so
    its loss and gradient are the same bits in a batch of any size."""
    b, s, d = h.shape
    hn = _final_norm(params, cfg, h)
    table = params["head"] if not cfg.tie_embeddings else params["embed"]
    # fp32 once for all chunks
    table = TP.readout_table(table) if TP.is_group(params) else table["table"].float()
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
    """Loss of one batch {"tokens", "labels"[, "prefix_embeds"]} through the
    train forward, with optional per-layer adapters
    (``lm_skiplora.adapters_to_stack``), plus the MoE aux loss. Prefix
    positions carry no next-token loss (label -1)."""
    out = lm_forward(
        params, cfg, batch["tokens"], mode="train", adapters=adapters,
        prefix_embeds=batch.get("prefix_embeds"),
    )
    return lm_loss(params, cfg, out["h"], pad_prefix_labels(batch["labels"], batch.get("prefix_embeds"))) + out["aux"]


def pad_prefix_labels(labels: torch.Tensor, prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Labels (B, S) -> (B, P + S) with -1 over a frontend prefix of P
    positions (unchanged without one)."""
    if prefix_embeds is None:
        return labels
    pad = torch.full((labels.shape[0], prefix_embeds.shape[1]), -1, dtype=labels.dtype, device=labels.device)
    return torch.cat([pad, labels], dim=1)


def init_serve_caches(cfg: ModelConfig, batch: int, max_seq: int, *, device, params: Params = None) -> list[Params]:
    """Per-layer serve caches with the cache dtype bf16 whatever the model
    dtype, as the reference makes them: bf16 KV caches, recurrent states
    with fp32 memories and bf16 conv windows (sLSTM's ``h`` bf16 too).
    For ``params`` split over a model group, each member's part on its
    device, split by KV heads or by sequence (``tp.init_caches``)."""
    if TP.is_group(params):
        return TP.init_caches(params, cfg, batch, max_seq)
    return B.init_stack_caches(batch, max_seq, cfg, torch.bfloat16, device=device)


def init_stacked_caches(cfg: ModelConfig, batch: int, max_seq: int, *, device,
                        params: Params = None) -> dict[str, torch.Tensor]:
    """The serve caches of every layer as two zeroed bf16 tensors
    {"k", "v"}: (L, batch, max_seq, n_kv, hd), so that one op moves a row
    (or a block) of every layer at once. ``layer_caches`` gives the
    per-layer views the forward takes. Attention-only configs, whose layers
    all share one KV shape. ``params`` as in ``init_serve_caches``."""
    B.require_attention(cfg, "the stacked KV layout")
    if TP.is_group(params):
        return TP.init_caches(params, cfg, batch, max_seq, stacked=True)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {n: torch.zeros(shape, dtype=torch.bfloat16, device=device) for n in ("k", "v")}


def layer_caches(stacked: dict[str, torch.Tensor]) -> list[Params]:
    """Per-layer {"k", "v"} views of ``init_stacked_caches``' tensors:
    writes through them land in the stacked tensors."""
    return [{"k": k, "v": v} for k, v in zip(stacked["k"], stacked["v"])]


def serve_prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    caches: list[Params],
    *,
    adapters: Optional[list[Params]] = None,
    prefix_embeds: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, list[Params]]:
    """Prefill: process the prompt (behind ``prefix_embeds`` (B, P, D), a
    frontend's embeddings, if given: the caches then hold P + S positions
    and decode resumes at P + S), return (last-position logits, caches)."""
    out = lm_forward(params, cfg, tokens, mode="prefill", caches=caches, adapters=adapters,
                     prefix_embeds=prefix_embeds)
    return readout(params, cfg, out["h"][:, -1:]), out["caches"]


def serve_decode(
    params: Params,
    cfg: ModelConfig,
    token: torch.Tensor,     # (B, 1)
    pos,                     # int, or (B,) tensor
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
    *,
    use_kernel: bool = True,
    plan=None,
) -> tuple[torch.Tensor, list[Params]]:
    """Prefill with per-row adapters. The backbone runs adapter-free,
    activations are collected, and one grouped skip-sum over the *last*
    position yields the per-tenant logits (``use_kernel=False``: through
    the plain versions on any device). ``plan``: the skip-sum's grouping
    plan (``adapter_pool.grouped_plan``), as a CUDA graph's static buffers
    hold it."""
    from repro_torch.core.adapter_pool import grouped_skip_sum

    out = lm_forward(params, cfg, tokens, mode="prefill", caches=caches, collect_acts=True)
    y_last = out["y_base"][:, -1:]
    skip = grouped_skip_sum(out["acts"][:, :, -1:], pools, idx, use_kernel=use_kernel, plan=plan)
    logits = readout(params, cfg, y_last + skip.to(y_last.dtype))
    return logits, out["caches"]


def serve_decode_grouped(
    params: Params,
    cfg: ModelConfig,
    token: torch.Tensor,              # (B, 1)
    pos,                              # int, or (B,) tensor
    caches: list[Params],
    pools: dict[str, torch.Tensor],
    idx: torch.Tensor,                # (B,) int32
    *,
    use_kernel: bool = True,
    fuse_skip: bool = False,
    plan=None,
) -> tuple[torch.Tensor, list[Params]]:
    """One grouped decode step: per-row adapters via one grouped skip-sum
    over the (L, B, 1, D) collected block inputs. ``fuse_skip=True``
    computes the skip term as dense per-row math inside the step instead of
    a grouped kernel launch (``grouped_skip_sum(fused=True)``); the
    temperature-0 tokens are the same either way. ``plan`` is the call's
    grouping plan (``adapter_pool.grouped_plan``)."""
    from repro_torch.core.adapter_pool import grouped_skip_sum

    out = lm_forward(params, cfg, token, mode="decode", caches=caches, pos=pos, collect_acts=True)
    skip = grouped_skip_sum(out["acts"], pools, idx, use_kernel=use_kernel, fused=fuse_skip, plan=plan)
    y = out["y_base"] + skip.to(out["y_base"].dtype)
    return readout(params, cfg, y), out["caches"]


@torch.no_grad()
def ingest_prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                          # (B, S) int
    pools: Optional[dict[str, torch.Tensor]] = None,
    idx: Optional[torch.Tensor] = None,            # (B,) int32 slot per row
    *,
    use_kernel: bool = True,
    plan=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Populate-phase forward that doubles as serving: one train-mode
    backbone pass with activation collection gives the Skip-Cache payload
    (``acts``, ``y_base``: what the offline populate epoch writes, the
    backbone being frozen) and, through one grouped skip-sum over the last
    position, each row's adapted logits. ``pools``/``idx`` pick each row's
    adapter slot (``None`` pools: the base model); ``use_kernel=False`` sums
    through the plain versions; ``plan`` as in ``serve_prefill_grouped``. Returns (last-position logits (B, 1, V),
    acts (L, B, S, D), y_base (B, S, D))."""
    from repro_torch.core.adapter_pool import grouped_skip_sum

    out = lm_forward(params, cfg, tokens, mode="train", collect_acts=True)
    acts, y_base = out["acts"], out["y_base"]
    y_last = y_base[:, -1:]
    if pools is not None:
        skip = grouped_skip_sum(acts[:, :, -1:], pools, idx, use_kernel=use_kernel, plan=plan)
        y_last = y_last + skip.to(y_last.dtype)
    return readout(params, cfg, y_last), acts, y_base


# ---------------------------------------------------------------------------
# Decode loop
# ---------------------------------------------------------------------------


def sample_token(
    logits: torch.Tensor,                       # (B, 1, V)
    temperature,                                # float, or (B,) tensor of per-row temperatures
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Greedy (``temperature <= 0``) or temperature sampling -> (B, 1) int64.

    Greedy picks the first maximum, as ``jnp.argmax`` does, so temperature-0
    tokens equal the reference's. Temperature > 0 draws from ``generator``
    (a ``torch.Generator`` on the logits' device) and cannot reproduce JAX's
    PRNG stream. A (B,) tensor gives each row its own temperature, as the
    request scheduler's rows have: every row draws (the logits divided in
    their own dtype by the row's temperature, or by 1 for a greedy row) and
    greedy rows keep their ``argmax``, so greedy tokens do not depend on the
    other rows."""
    if isinstance(temperature, torch.Tensor):
        t = temperature.to(device=logits.device, dtype=torch.float32).expand(logits.shape[0])
        safe = torch.where(t > 0, t, torch.ones_like(t)).to(logits.dtype)
        probs = torch.softmax((logits[:, 0] / safe[:, None]).float(), dim=-1)
        drawn = torch.multinomial(probs, 1, generator=generator)
        return torch.where((t > 0)[:, None], drawn, torch.argmax(logits, dim=-1))
    if temperature > 0:
        probs = torch.softmax((logits[:, 0] / temperature).float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(logits, dim=-1)


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tok: torch.Tensor,             # (B, 1)
    pos,                           # int, 0-d tensor, or (B,) tensor: each row's position
    caches: list[Params],
    *,
    temperature=0.0,               # float, or (B,) tensor: see sample_token
    generator: Optional[torch.Generator] = None,
    adapters: Optional[list[Params]] = None,
    pools: Optional[dict[str, torch.Tensor]] = None,
    idx: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
    fuse_skip: bool = False,
    plan=None,
) -> tuple[torch.Tensor, list[Params]]:
    """One decode step at position ``pos``: returns (next token (B, 1),
    caches). ``pools``/``idx`` select the grouped path (``use_kernel``,
    ``fuse_skip`` and ``plan`` as in ``serve_decode_grouped``), ``adapters``
    the single-stack path. A (B,) ``pos`` decodes every row at its own
    position (continuous batching; see ``attention.attn_decode``)."""
    if pools is not None:
        logits, caches = serve_decode_grouped(params, cfg, tok, pos, caches, pools, idx,
                                              use_kernel=use_kernel, fuse_skip=fuse_skip, plan=plan)
    else:
        logits, caches = serve_decode(params, cfg, tok, pos, caches, adapters=adapters)
    return sample_token(logits, temperature, generator), caches


def decode_step_(
    params: Params,
    cfg: ModelConfig,
    state: dict[str, Any],
    *,
    active: Optional[torch.Tensor] = None,
    max_seq: int = 0,
    **step,
) -> None:
    """The step a CUDA graph captures (``core.decode_graph``), and the one
    the CPU runs eagerly: one ``decode_step`` over the buffers of ``state``
    ({"tok": (B, 1), "pos": 0-d or (B,) int64 tensor, "caches": per-layer
    list}), updated in place, as the reference's decode carry (tok, pos,
    caches) is. The sampled token lands in ``state["tok"]`` and the position
    moves on by one. With ``active`` (B,) bool (the request scheduler's
    live batch) retired rows keep their token and position and live
    positions stop at ``max_seq - 1``, so a chunk that overshoots a
    finishing row never writes past the cache. ``step`` holds
    ``decode_step``'s keywords."""
    tok, pos = state["tok"], state["pos"]
    ntok, _ = decode_step(params, cfg, tok, pos, state["caches"], **step)
    if active is None:
        tok.copy_(ntok)
        pos.add_(1)
        return
    tok.copy_(torch.where(active[:, None], ntok, tok))
    pos.copy_(torch.where(active, torch.clamp(pos + 1, max=max_seq - 1), pos))


def decode_scan(
    params: Params,
    cfg: ModelConfig,
    tok0: torch.Tensor,            # (B, 1) first generated token
    start_pos: int,                # position of tok0
    caches: list[Params],
    *,
    max_new: int,
    temperature=0.0,
    generator: Optional[torch.Generator] = None,
    adapters: Optional[list[Params]] = None,
    pools: Optional[dict[str, torch.Tensor]] = None,
    idx: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
    fuse_skip: bool = False,
    unroll: int = 1,
) -> tuple[torch.Tensor, list[Params]]:
    """Generate ``max_new`` tokens: exactly ``max_new`` decode steps, as the
    reference's scan runs (the last step's token is dropped, its K/V kept).
    On CUDA tensors the steps are CUDA-graph replays, ``unroll`` steps a
    replay (``core.decode_graph``: the card's form of the reference's one
    ``lax.scan`` dispatch; ``max_new`` need not be a multiple), for a
    backbone split over a model group too, whether its members share one
    card or span several (``cuda_graph.capturable``); on CPU tensors the
    same step function (``decode_step_``) runs eagerly. The caches are
    updated in place.
    Returns (tokens (B, max_new) with tok0 first, final caches)."""
    from repro_torch.core.cuda_graph import capturable

    if unroll < 1:
        raise ValueError(f"unroll {unroll} < 1")
    kw = dict(temperature=temperature, adapters=adapters, pools=pools, idx=idx,
              use_kernel=use_kernel, fuse_skip=fuse_skip)
    if capturable(TP.run_devices(params, tok0)):
        from repro_torch.core import decode_graph

        return decode_graph.decode(params, cfg, tok0, start_pos, caches, max_new=max_new,
                                   generator=generator, unroll=unroll, **kw)
    state = {"tok": tok0.clone(), "pos": torch.tensor(start_pos, device=tok0.device), "caches": caches}
    toks = torch.empty((tok0.shape[0], max_new), dtype=tok0.dtype, device=tok0.device)
    for i in range(max_new):
        toks[:, i] = state["tok"][:, 0]
        decode_step_(params, cfg, state, generator=generator, **kw)
    return toks, caches


def decode_loop(
    params: Params,
    cfg: ModelConfig,
    tok0: torch.Tensor,
    start_pos: int,
    caches: list[Params],
    *,
    max_new: int,
    temperature=0.0,
    generator: Optional[torch.Generator] = None,
    adapters: Optional[list[Params]] = None,
    pools: Optional[dict[str, torch.Tensor]] = None,
    idx: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
    fuse_skip: bool = False,
) -> tuple[torch.Tensor, list[Params]]:
    """``decode_scan``'s steps as an eager Python loop on any device, one
    ``decode_step`` at an int position each (the reference's
    ``generate_loop`` body): the path a CUDA-graph replay is held against.
    Same arguments and results as ``decode_scan``."""
    from repro_torch.core.adapter_pool import grouped_plan

    step = dict(temperature=temperature, generator=generator, adapters=adapters, pools=pools, idx=idx,
                use_kernel=use_kernel, fuse_skip=fuse_skip,
                plan=grouped_plan(pools, idx, use_kernel=use_kernel, fused=fuse_skip))
    toks, tok = [], tok0
    for i in range(max_new):
        toks.append(tok)
        tok, caches = decode_step(params, cfg, tok, start_pos + i, caches, **step)
    return torch.cat(toks, dim=1), caches


# ---------------------------------------------------------------------------
# Admission prefills of the request scheduler
# ---------------------------------------------------------------------------


def _last_logits(params, cfg, out, last, pools, idx, use_kernel, plan=None) -> torch.Tensor:
    """Logits at each row's position ``last`` (A,): the adapter-free hidden
    there plus, with ``pools``, one grouped skip-sum over the block inputs
    at that position (``plan`` its grouping plan, or None) -> (A, 1, V)."""
    rows = torch.arange(last.shape[0], device=last.device)
    y_last = out["y_base"][rows, last][:, None]                  # (A, 1, D)
    if pools is not None:
        from repro_torch.core.adapter_pool import grouped_skip_sum

        acts_last = out["acts"][:, rows, last][:, :, None]       # (L, A, 1, D)
        y_last = y_last + grouped_skip_sum(acts_last, pools, idx, use_kernel=use_kernel,
                                           plan=plan).to(y_last.dtype)
    return readout(params, cfg, y_last)


def sched_prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                   # (A, P) int, right-padded per row
    lens: torch.Tensor,                     # (A,) int true prompt length per row
    pools: Optional[dict[str, torch.Tensor]] = None,
    idx: Optional[torch.Tensor] = None,     # (A,) int32 slot per row
    *,
    caches: Optional[list[Params]] = None,
    use_kernel: bool = True,
    plan=None,
) -> tuple[torch.Tensor, list[Params]]:
    """Admission prefill of the request scheduler: ragged prompts in one
    padded (A, P) batch, the logits read at each row's own last *real*
    position (``lens[a] - 1``) rather than column -1 (``use_kernel=False``: the
    skip-sum through the plain versions on any device). Pad positions write
    garbage K/V at indices >= len, which decode overwrites (it resumes at
    ``pos = len``) before the causal mask ever exposes them. ``caches``
    (per-layer, at (A, P)) defaults to fresh zeroed ones; the scheduler
    passes views of its stacked admission caches. ``plan`` as in
    ``serve_prefill_grouped``. Returns (logits (A, 1, V), caches)."""
    a, p = tokens.shape
    if caches is None:
        caches = init_serve_caches(cfg, a, p, device=tokens.device, params=params)
    out = lm_forward(params, cfg, tokens, mode="prefill", caches=caches, collect_acts=True)
    last = (lens.clamp(min=1) - 1).long()
    return _last_logits(params, cfg, out, last, pools, idx, use_kernel, plan), out["caches"]


def sched_prefill_reuse(
    params: Params,
    cfg: ModelConfig,
    tail_tokens: torch.Tensor,              # (A, PT) int, right-padded tail per row
    tail_lens: torch.Tensor,                # (A,) int true tail length (>= 1)
    prefix_lens: torch.Tensor,              # (A,) int reused-prefix length per row
    caches: list[Params],                   # (A, P) caches, prefix K/V pre-written
    pools: Optional[dict[str, torch.Tensor]] = None,
    idx: Optional[torch.Tensor] = None,     # (A,) int32 slot per row
    *,
    use_kernel: bool = True,
    plan=None,
) -> tuple[torch.Tensor, list[Params]]:
    """Admission prefill over only the unseen tail of each prompt: the
    prefix's K/V were gathered from the paged pool into
    ``caches[:, 0:prefix_lens)``, so the backbone runs at (A, PT) instead of
    (A, P). The tail attends the cache (``attention.attn_prefill_ext``). The
    skip-LoRA readout needs only the last real position's block inputs,
    which lie in the tail (the radix match always leaves >= 1 tail token).
    ``plan`` as in ``serve_prefill_grouped``. Returns (logits (A, 1, V),
    caches at (A, P))."""
    out = lm_forward(
        params, cfg, tail_tokens, mode="prefill", caches=caches, pos=prefix_lens,
        collect_acts=True,
    )
    last = (tail_lens.clamp(min=1) - 1).long()
    return _last_logits(params, cfg, out, last, pools, idx, use_kernel, plan), out["caches"]


# ---------------------------------------------------------------------------
# Pipelined admission prefill (SessionRuntime(pipeline_stages=N))
# ---------------------------------------------------------------------------


def pipeline_stage_params(params: Params, cfg: ModelConfig, n_stages: int):
    """The backbone's layers as ``n_stages`` GPipe stages for
    ``pipeline_sched_prefill``: ``runtime.pipeline_par.split_stages`` of the
    (unsplit) layer list, (stages, valid). Uniform attention stacks only,
    as the reference refuses the others."""
    from repro_torch.runtime.pipeline_par import split_stages

    kinds = set(cfg.layer_kinds())
    if len(kinds) != 1 or not kinds <= set(B.ATTN_KINDS):
        raise NotImplementedError(f"pipeline serve needs a uniform attention-only stack; config has {sorted(kinds)}")
    return split_stages(params["stack"], n_stages)


def pipeline_sched_prefill(
    params: Params,
    cfg: ModelConfig,
    stages: list,                           # pipeline_stage_params' stages, stage s on devices[s]
    valid: torch.Tensor,                    # (n_stages, per) bool
    tokens: torch.Tensor,                   # (A, P) int, right-padded per row
    lens: torch.Tensor,                     # (A,) int
    pools: dict[str, torch.Tensor],         # float AdapterPool layout {"A", "B"}
    idx: torch.Tensor,                      # (A,) int32 slot per row
    *,
    devices,
    n_micro: int,
    caches: Optional[list[Params]] = None,
) -> tuple[torch.Tensor, list[Params]]:
    """``sched_prefill`` over GPipe stages: the group's devices run the
    backbone as ``len(stages)`` stages over ``n_micro`` microbatches, each
    stage adding its layers' skip-LoRA terms from their block inputs
    (``runtime.pipeline_par.pipeline_prefill``). The embedding and readout
    run on ``devices[0]`` with ``params`` (one device's, or the group's
    split backbone). Temperature-0 tokens match ``sched_prefill`` (the same
    ``max(len, 1) - 1`` rule); ``caches`` (per layer, at (A, P), on
    ``devices[0]``; fresh ones by default) take microbatch m's K/V in rows
    ``[m * mb, (m + 1) * mb)``, so the scheduler's admission scatter does not
    care which path filled them. Returns (logits (A, 1, V), caches)."""
    from repro_torch.runtime.pipeline_par import pipeline_prefill

    a, p_len = tokens.shape
    if a % n_micro:
        raise ValueError(f"admission width {a} not divisible into {n_micro} microbatches")
    if "A" not in pools:
        raise NotImplementedError("pipeline serve needs a float adapter pool")
    devices = [torch.device(d) for d in devices]
    mb, n_stages, per = a // n_micro, len(stages), len(stages[0])
    n_layers = cfg.n_layers
    h = _embed(params, cfg, tokens)
    if caches is None:
        caches = init_serve_caches(cfg, a, p_len, device=h.device)
    # each stage's adapter rows of its (valid) layers, on its device
    stage_a = [pools["A"][:, s * per:min((s + 1) * per, n_layers)].to(devices[s]) for s in range(n_stages)]
    stage_b = [pools["B"][:, s * per:min((s + 1) * per, n_layers)].to(devices[s]) for s in range(n_stages)]
    kind = cfg.layer_kinds()[0]
    far: list = []         # (home view, far buffer) of the stages on other devices

    def block_fn(l, m, p_l, hh):
        # a stage on another device prefills a zeroed buffer there (the
        # classic prefill reads no cached position), copied home once after
        # the schedule (``pipeline_prefill``: a copy between cards mid-way
        # would hold the first card back)
        view = {n: caches[l][n][m * mb:(m + 1) * mb] for n in ("k", "v")}
        mine = view if view["k"].device == hh.device else {n: torch.zeros_like(t, device=hh.device)
                                                           for n, t in view.items()}
        h2, _, _ = B.block_forward(kind, p_l, hh, cfg, mode="prefill", cache=mine)
        if mine is not view:
            far.append((view, mine))
        return h2

    y, skip = pipeline_prefill(
        stages, stage_a, stage_b, valid, h.reshape(n_micro, mb, p_len, -1), lens.reshape(n_micro, mb),
        idx.reshape(n_micro, mb), block_fn, devices=devices,
    )
    for view, mine in far:
        for n in ("k", "v"):
            view[n].copy_(mine[n])
    y, skip = y.reshape(a, p_len, -1), skip.reshape(a, -1)
    last = (lens.clamp(min=1) - 1).long()
    y_last = y[torch.arange(a, device=y.device), last][:, None]                 # (A, 1, D)
    return readout(params, cfg, y_last + skip[:, None, :].to(y_last.dtype)), caches
