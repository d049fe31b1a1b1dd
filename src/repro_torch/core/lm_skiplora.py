"""Skip2-LoRA at LM scale: adapters, the activation cache, train steps.

Counterpart of ``repro.core.lm_skiplora``. For every layer k an adapter
(A_k: D->R, B_k: R->D) taps the residual-stream input of block k, and its
output is added to the final hidden state:

    h_final <- y_base + sum_k x^k A_k B_k

The backbone (readout included) is frozen, so x^k and y_base are constant
across a fine-tuning run: a populate epoch caches them, and every later
(cached) epoch runs the skip sum, the readout loss, the adapter backward
and AdamW, with no backbone compute.

Cache modes (``SkipLoRAConfig.mode``):
  - ``full``     : x^k as-is;
  - ``int8``     : x^k rowwise-quantised to int8 with per-token scales;
  - ``freeze_a`` : A_k frozen and z^k = x^k A_k cached (R wide); only B_k
                   trains.

``use_fused_kernel`` sends the cached step's skip sum through
``kernels.skip_lora.ops``: K1 (``full``) or K3 (``int8``) forward and K2
backward on the card, their plain versions on the CPU. Without it the sum
is the reference's own einsum route.

Adapters live in the flat layout {"A": (L, D, R), "B": (L, R, D)} -- one
``AdapterPool`` slot. ``adapters_to_stack`` / ``stack_to_adapters`` convert
to and from the per-layer list the port's layer stack takes (the
reference's periodic layout has no counterpart here).

The reference's epochs are ``lax.scan`` loops compiled into one dispatch
with donated carries (trainable, opt_state and, populating, the cache). On
CUDA tensors an epoch here is CUDA-graph replays with no Python op dispatch
a step (``cuda_graph.EpochGraph``, cached in ``GRAPHS``): a graph of one
step, replayed once a row of the index matrix, which it reads through a
step counter on the device (an entry's first call runs its first step
eagerly, then captures and replays the rest). The adapters, moments and step count go into
the entry's buffers and come out as new tensors; params, tokens and labels
are read in place and never written; the cache is written in place (it is
donated) and keys the entry by its storage with the params, tokens and
labels. ``loop=True``, CPU tensors and params split over a model group
(``models.tp``) run the eager loop over the rows instead, the yardstick the
replays are held to bitwise. Either way the cache is written in place and
each step's loss stays on the device until the epoch returns them stacked.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core.cuda_graph import EpochGraph, GraphCache, shapes, storage_sig
from repro_torch.core.skip_cache import SkipCache, cache_read, cache_write
from repro_torch.models import tp as TP
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import lm_forward, lm_loss, model_dtype, pad_prefix_labels
from repro_torch.optim.optimizers import OptState, apply_updates

Params = Any

#: the CUDA graphs of the LM epochs run on the card (single-tenant and
#: fleet); a session keeps its own per shard
GRAPHS = GraphCache(capacity=4)


@dataclasses.dataclass(frozen=True)
class SkipLoRAConfig:
    rank: int = 16
    mode: str = "full"             # full | int8 | freeze_a
    cache_dtype: str = "bfloat16"  # dtype for unquantised slots
    use_fused_kernel: bool = False  # K1/K3 + K2 (kernels.skip_lora.ops)

    def __post_init__(self):
        if self.mode not in ("full", "int8", "freeze_a"):
            raise ValueError(self.mode)


def init_adapters(generator: torch.Generator, cfg: ModelConfig, sl: SkipLoRAConfig) -> Params:
    """Flat adapters on ``generator.device``: A ~ N(0, 1/D) (fp32 master),
    B = 0 (identity at init)."""
    l, d, r = cfg.n_layers, cfg.d_model, sl.rank
    dev = generator.device
    return {
        "A": torch.randn((l, d, r), generator=generator, device=dev) / math.sqrt(d),
        "B": torch.zeros((l, r, d), dtype=torch.float32, device=dev),
    }


def adapters_to_stack(adapters: Params) -> list[Params]:
    """Flat {"A": (L, D, R), "B": (L, R, D)} -> per-layer [{"A", "B"}]."""
    return [{"A": a, "B": b} for a, b in zip(adapters["A"], adapters["B"])]


def stack_to_adapters(stack: list[Params]) -> Params:
    """Per-layer [{"A", "B"}] -> flat {"A": (L, D, R), "B": (L, R, D)}."""
    return {
        "A": torch.stack([p["A"] for p in stack]),
        "B": torch.stack([p["B"] for p in stack]),
    }


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rowwise over the last axis. Returns (q int8, scale fp32 without last
    axis). ``torch.round`` rounds half to even like ``jnp.round``, so the
    payload is bitwise the reference's."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def split_trainable(adapters: Params, sl: SkipLoRAConfig) -> tuple[Params, Params]:
    """(trainable, static). freeze_a trains only B (A folded into the cache)."""
    if sl.mode == "freeze_a":
        return {"B": adapters["B"]}, {"A": adapters["A"]}
    return adapters, {}


def merge_adapters(trainable: Params, static: Params) -> Params:
    return {**static, **trainable}


# ---------------------------------------------------------------------------
# Skip aggregation
# ---------------------------------------------------------------------------


def skip_sum_ref(acts: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k x^k A_k B_k. acts: (L,B,S,D); a: (L,D,R); b: (L,R,D) -> (B,S,D)."""
    z = torch.einsum("lbsd,ldr->lbsr", acts, a.to(acts.dtype))
    return torch.einsum("lbsr,lrd->bsd", z, b.to(acts.dtype))


def skip_sum(acts, a, b, *, use_kernel: bool = False) -> torch.Tensor:
    if use_kernel:
        from repro_torch.kernels.skip_lora.ops import skip_lora_fused

        return skip_lora_fused(acts, a, b)
    return skip_sum_ref(acts, a, b)


def skip_sum_compressed(z: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """freeze_a: z = x A cached. z: (L,B,S,R); b: (L,R,D) -> (B,S,D)."""
    return torch.einsum("lbsr,lrd->bsd", z, b.to(z.dtype))


# ---------------------------------------------------------------------------
# LM Skip-Cache layout
# ---------------------------------------------------------------------------

_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def lm_cache_layout(cfg: ModelConfig, sl: SkipLoRAConfig, seq: int) -> dict[str, tuple[tuple, Any]]:
    """slot name -> (per-sample shape, dtype)."""
    l, d, r = cfg.n_layers, cfg.d_model, sl.rank
    cdt = _CACHE_DTYPES[sl.cache_dtype]
    if sl.mode == "freeze_a":
        slots = {"z": ((l, seq, r), cdt)}
    elif sl.mode == "int8":
        slots = {"acts_q": ((l, seq, d), torch.int8), "acts_scale": ((l, seq), torch.float32)}
    else:
        slots = {"acts": ((l, seq, d), cdt)}
    slots["y_base"] = ((seq, d), cdt)
    slots["labels"] = ((seq,), torch.int32)
    return slots


def init_lm_cache(
    num_samples: int, cfg: ModelConfig, sl: SkipLoRAConfig, seq: int, *, device=None
) -> SkipCache:
    slots = {
        name: torch.zeros((num_samples,) + shape, dtype=dtype, device=device)
        for name, (shape, dtype) in lm_cache_layout(cfg, sl, seq).items()
    }
    return SkipCache(slots=slots, valid=torch.zeros((num_samples,), dtype=torch.bool, device=device))


def cache_nbytes_per_sample(cfg: ModelConfig, sl: SkipLoRAConfig, seq: int) -> int:
    return sum(
        math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        for shape, dtype in lm_cache_layout(cfg, sl, seq).values()
    )


def _encode_acts(acts: torch.Tensor, adapters: Params, sl: SkipLoRAConfig) -> dict[str, torch.Tensor]:
    """acts (L,B,S,D) -> cache slot values keyed per sample (B leading)."""
    acts_b = acts.transpose(0, 1)  # (B, L, S, D)
    if sl.mode == "freeze_a":
        return {"z": torch.einsum("blsd,ldr->blsr", acts_b, adapters["A"].to(acts_b.dtype))}
    if sl.mode == "int8":
        q, scale = quantize_int8(acts_b)
        return {"acts_q": q, "acts_scale": scale}
    return {"acts": acts_b}


def _swap01(t: torch.Tensor, dtype) -> torch.Tensor:
    """(B, L, ...) -> contiguous (L, B, ...) in ``dtype``, one copy."""
    out = torch.empty((t.shape[1], t.shape[0]) + t.shape[2:], dtype=dtype, device=t.device)
    return out.copy_(t.transpose(0, 1))


def _decode_acts(vals: dict[str, torch.Tensor], sl: SkipLoRAConfig, dtype) -> torch.Tensor:
    """cache slots -> acts (L,B,S,D) (or z (L,B,S,R) in freeze_a mode)."""
    if sl.mode == "freeze_a":
        return _swap01(vals["z"], dtype)
    if sl.mode == "int8":
        return _swap01(dequantize_int8(vals["acts_q"], vals["acts_scale"], dtype), dtype)
    return _swap01(vals["acts"], dtype)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def value_and_grad(loss_fn, trainable: Params):
    """(loss, aux), grads of ``loss_fn(t)`` for the leaves of ``trainable``.
    Only the adapters require grad, so autograd records nothing of the
    frozen backbone."""
    t = {k: v.detach().requires_grad_(True) for k, v in trainable.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(t)
        grads = torch.autograd.grad(loss, list(t.values()))
    return loss.detach(), aux, dict(zip(t, grads))


def populate_loss_fn(params: Params, cfg: ModelConfig, adapters: Params, batch: dict[str, torch.Tensor]):
    """Full forward with activation collection. Returns (loss, (acts, y_base,
    labels)). With ``batch["prefix_embeds"]`` (B, P, D) the acts, y_base and
    labels cover P + S positions, the labels -1 over the prefix. The loss
    leaves out the MoE aux loss, as the reference's does."""
    out = lm_forward(
        params, cfg, batch["tokens"], mode="train",
        adapters=adapters_to_stack(adapters), collect_acts=True,
        prefix_embeds=batch.get("prefix_embeds"),
    )
    labels = pad_prefix_labels(batch["labels"], batch.get("prefix_embeds"))
    loss = lm_loss(params, cfg, out["h"], labels)
    return loss, (out["acts"].detach(), out["y_base"].detach(), labels)


def make_populate_step(cfg: ModelConfig, sl: SkipLoRAConfig, optimizer):
    """Backbone forward + cache write + adapter optimizer step."""

    def step(params, trainable, static, opt_state, cache, batch, idx):
        loss, (acts, y_base, labels), grads = value_and_grad(
            lambda t: populate_loss_fn(params, cfg, merge_adapters(t, static), batch), trainable
        )
        values = _encode_acts(acts, merge_adapters(trainable, static), sl)
        values["y_base"] = y_base
        values["labels"] = labels
        cache = cache_write(cache, idx, values)
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        return apply_updates(trainable, updates), opt_state, cache, loss

    return step


def cached_loss_fn(
    params: Params,
    cfg: ModelConfig,
    sl: SkipLoRAConfig,
    adapters: Params,
    vals: dict[str, torch.Tensor],
    dtype,
) -> torch.Tensor:
    """Loss from cached activations only: no backbone compute."""
    if sl.mode == "int8" and sl.use_fused_kernel:
        # The int8 payload goes straight into K3, which dequantises in registers.
        from repro_torch.kernels.skip_lora.ops import skip_lora_fused_int8

        q = _swap01(vals["acts_q"], torch.int8)                   # (L, B, S, D)
        scale = _swap01(vals["acts_scale"], torch.float32)        # (L, B, S)
        skip = skip_lora_fused_int8(q, scale, adapters["A"], adapters["B"])
    else:
        acts = _decode_acts(vals, sl, dtype)
        if sl.mode == "freeze_a":
            skip = skip_sum_compressed(acts, adapters["B"])
        else:
            skip = skip_sum(acts, adapters["A"], adapters["B"], use_kernel=sl.use_fused_kernel)
    h = vals["y_base"].to(dtype) + skip.to(dtype)
    return lm_loss(params, cfg, h, vals["labels"])


def make_cached_step_from_vals(cfg: ModelConfig, sl: SkipLoRAConfig, optimizer):
    """Adapter step from already-gathered cache values."""
    dtype = model_dtype(cfg)

    def step(params, trainable, static, opt_state, vals):
        loss, _, grads = value_and_grad(
            lambda t: (cached_loss_fn(params, cfg, sl, merge_adapters(t, static), vals, dtype), None),
            trainable,
        )
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        return apply_updates(trainable, updates), opt_state, loss

    return step


def make_cached_step(cfg: ModelConfig, sl: SkipLoRAConfig, optimizer):
    """Cache gather + adapter step: the paper's fast path."""
    from_vals = make_cached_step_from_vals(cfg, sl, optimizer)

    def step(params, trainable, static, opt_state, cache, idx):
        return from_vals(params, trainable, static, opt_state, cache_read(cache, idx))

    return step


# ---------------------------------------------------------------------------
# Epochs: graph replays on the card, the eager loop over the rows elsewhere
# ---------------------------------------------------------------------------


def carry_leaves(trainable: Params, opt_state: OptState) -> tuple[list[torch.Tensor], tuple]:
    """The donated small state of an adapter epoch as a flat list (the
    trainable leaves, the step count, then the moments' leaves) and the
    structure ``from_carry`` rebuilds it with."""
    keys = tuple(trainable)
    leaves = [trainable[k] for k in keys] + [opt_state.step]
    for m in (opt_state.mu, opt_state.nu):
        if m is not None:
            leaves += [m[k] for k in keys]
    return leaves, (keys, opt_state.mu is not None, opt_state.nu is not None)


def from_carry(leaves: list[torch.Tensor], struct: tuple) -> tuple[Params, OptState]:
    keys, has_mu, has_nu = struct
    it = iter(leaves)
    trainable = {k: next(it) for k in keys}
    step = next(it)
    mu = {k: next(it) for k in keys} if has_mu else None
    nu = {k: next(it) for k in keys} if has_nu else None
    return trainable, OptState(step=step, mu=mu, nu=nu)


def graphed(x: torch.Tensor, params: Params, loop: bool) -> bool:
    """Whether an epoch over ``x``'s device runs as graph replays: on a CUDA
    device, unless ``loop`` asks for the eager steps or the params are split
    over a model group (whose members' dispatches stay eager)."""
    return not loop and x.is_cuda and not TP.is_group(params)


def cache_sig(cache: SkipCache) -> tuple:
    return storage_sig(cache.slots) + storage_sig(cache.valid)


def run_epoch_graph(graphs: Optional[GraphCache], key: tuple, step, live, carry, consts, idx_mat, *, what: str,
                    before=None, after=None):
    """One epoch as replays of the entry ``key`` of ``graphs`` (default
    ``GRAPHS``): ``cuda_graph.EpochGraph.run``. ``key`` must name what fixes
    the step and hold ``storage_sig`` of ``live``."""
    graphs = GRAPHS if graphs is None else graphs
    key = key + (tuple(idx_mat.shape), idx_mat.dtype, shapes(carry), shapes(consts), idx_mat.device)
    e = graphs.entry(key, lambda: EpochGraph(graphs.stats, step, device=idx_mat.device, what=what, before=before,
                                             after=after))
    return e.run(live, carry, consts, idx_mat)


def make_populate_epoch(cfg: ModelConfig, sl: SkipLoRAConfig, optimizer, *, loop: bool = False,
                        graphs: Optional[GraphCache] = None):
    """Whole populate epoch over ``idx_mat`` (steps, batch): tokens/labels
    (num_samples, seq) on the device. Returns (trainable, opt_state, cache,
    losses (steps,)); the cache is written in place, the other arguments
    are left alone. On CUDA tensors (``loop=False``) the steps are replays
    of a step graph (``GRAPHS`` or ``graphs``)."""
    step = make_populate_step(cfg, sl, optimizer)

    def loop_epoch(params, trainable, static, opt_state, cache, tokens, labels, idx_mat):
        losses = []
        for idx in idx_mat:
            batch = {"tokens": tokens[idx], "labels": labels[idx]}
            trainable, opt_state, cache, loss = step(params, trainable, static, opt_state, cache, batch, idx)
            losses.append(loss)
        return trainable, opt_state, cache, torch.stack(losses)

    def epoch(params, trainable, static, opt_state, cache, tokens, labels, idx_mat):
        if not graphed(tokens, params, loop):
            return loop_epoch(params, trainable, static, opt_state, cache, tokens, labels, idx_mat)
        carry, struct = carry_leaves(trainable, opt_state)
        names = tuple(static)

        def graph_step(live, carry, consts, idx):
            p, c, tok, lab = live
            t, o = from_carry(carry, struct)
            t, o, _, loss = step(p, t, dict(zip(names, consts)), o, c, {"tokens": tok[idx], "labels": lab[idx]}, idx)
            return carry_leaves(t, o)[0], loss

        key = ("populate", cfg, sl, optimizer, struct, names, storage_sig(params), cache_sig(cache),
               storage_sig(tokens), storage_sig(labels))
        new, losses, _ = run_epoch_graph(
            graphs, key, graph_step, (params, cache, tokens, labels), carry, [static[k] for k in names],
            idx_mat.to(tokens.device), what=f"the populate step ({cfg.name}, mode {sl.mode}, batch {idx_mat.shape[1]})")
        trainable, opt_state = from_carry(new, struct)
        return trainable, opt_state, cache, losses

    return epoch


def make_cached_epoch(cfg: ModelConfig, sl: SkipLoRAConfig, optimizer, *, loop: bool = False,
                      graphs: Optional[GraphCache] = None):
    """Whole cached epoch: cache gathers + adapter steps only. Returns
    (trainable, opt_state, losses (steps,)), the arguments left alone. On
    CUDA tensors (``loop=False``) the steps are graph replays."""
    step = make_cached_step(cfg, sl, optimizer)

    def loop_epoch(params, trainable, static, opt_state, cache, idx_mat):
        losses = []
        for idx in idx_mat:
            trainable, opt_state, loss = step(params, trainable, static, opt_state, cache, idx)
            losses.append(loss)
        return trainable, opt_state, torch.stack(losses)

    def epoch(params, trainable, static, opt_state, cache, idx_mat):
        if not graphed(cache.valid, params, loop):
            return loop_epoch(params, trainable, static, opt_state, cache, idx_mat)
        carry, struct = carry_leaves(trainable, opt_state)
        names = tuple(static)

        def graph_step(live, carry, consts, idx):
            p, c = live
            t, o = from_carry(carry, struct)
            t, o, loss = step(p, t, dict(zip(names, consts)), o, c, idx)
            return carry_leaves(t, o)[0], loss

        key = ("cached", cfg, sl, optimizer, struct, names, storage_sig(params), cache_sig(cache))
        new, losses, _ = run_epoch_graph(
            graphs, key, graph_step, (params, cache), carry, [static[k] for k in names],
            idx_mat.to(cache.valid.device), what=f"the cached step ({cfg.name}, mode {sl.mode}, batch {idx_mat.shape[1]})")
        trainable, opt_state = from_carry(new, struct)
        return trainable, opt_state, losses

    return epoch
