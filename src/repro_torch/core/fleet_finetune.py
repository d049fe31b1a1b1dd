"""Fleet fine-tuning: N tenants' Skip2-LoRA adapters trained in one loop.

Counterpart of ``repro.core.fleet_finetune``. Instead of N single-tenant
``finetune`` runs, one loop advances every tenant at each step:

  - **Fleet batch**: each step concatenates one batch per tenant
    (``batch_per_tenant`` rows each, tenant-contiguous), so the row -> slot
    map is ``repeat(arange(N), bpt)``.
  - **Grouped autograd**: the skip sum over the whole fleet batch is one
    ``skip_lora_grouped_train`` call (K5 forward on the card, or K8 over an
    int8 cache) whose backward (K9) writes each tenant's dA[t] / dB[t] into
    the stacked gradient.
  - **Per-tenant losses**: ``lm_loss_rows`` gives per-row log-likelihood
    sums, and its backward scales each row's gradient by the row's upstream
    gradient, so reducing per tenant makes tenant t's loss and gradient
    those of training t alone; ``n_tenants=1`` reproduces the single-tenant
    trajectory of ``core.lm_skiplora``.
  - **Stacked optimizer state**: AdamW over the stacked (N, ...) dict is N
    independent optimizers (elementwise, one shared step counter).
  - **Cache partitions**: tenant t owns sample ids [t*n_per, (t+1)*n_per) of
    one ``SkipCache``, so a populate step runs one backbone forward for the
    whole fleet batch and a cached step reads every tenant's rows at once.
  - **Write-back**: trained stacks go into a serving ``AdapterPool`` with one
    batched registration (``write_back_to_pool``).

The reference's epochs are ``lax.scan`` loops compiled into one dispatch;
here, on CUDA tensors, an epoch is replays of a captured step
(``cuda_graph.EpochGraph`` through ``lm_skiplora.run_epoch_graph``, as the
single-tenant epochs: the stacked adapters, moments, step count and the
row -> tenant map in the entry's buffers, params, tokens, labels and cache
in place), with a held-out eval before or after folded in as graphs of
their own, for a model group too, on one card or spread over several
(``cuda_graph.capturable``); ``loop=True`` and CPU tensors run the eager
loop over the rows. Either way
the cache is written in place, and each step's per-tenant losses stay on
the device until the epoch returns them stacked. With a ``TieredCacheEngine`` (``engine=``),
cached epochs stream their batches out of the engine
(``fleet_cached_epoch_via_engine``), the next batch's host rows prefetched
while a step runs: the path of a fleet whose cache exceeds its device
budget, and of the session runtime's ``adapt`` over a spilling engine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import batch_plan
from repro_torch.core import lm_skiplora as SL
from repro_torch.core.cuda_graph import GraphCache, storage_sig
from repro_torch.core.skip_cache import SkipCache, cache_read, cache_write
from repro_torch.kernels.skip_lora.ops import (
    freeze_pool_slots,
    skip_lora_grouped_train,
    skip_lora_grouped_train_int8,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import lm_forward, lm_loss_rows, model_dtype
from repro_torch.optim.optimizers import adamw, apply_updates

Params = Any


# ---------------------------------------------------------------------------
# Stacked adapters and fleet batches
# ---------------------------------------------------------------------------


def init_fleet_adapters(
    generator: torch.Generator, cfg: ModelConfig, sl: SL.SkipLoRAConfig, n_tenants: int
) -> Params:
    """Stacked per-tenant adapters {"A": (N, L, D, R), "B": (N, L, R, D)} on
    ``generator.device``: tenant t is the t-th ``init_adapters`` draw from
    ``generator``."""
    return stack_tenant_adapters([SL.init_adapters(generator, cfg, sl) for _ in range(n_tenants)])


def tenant_adapters(stacked: Params, t: int) -> Params:
    """Tenant t's flat {"A": (L, D, R), "B": (L, R, D)} stack."""
    return {k: v[t] for k, v in stacked.items()}


def stack_tenant_adapters(adapters: list[Params]) -> Params:
    """Inverse of ``tenant_adapters`` over a whole fleet."""
    return {k: torch.stack([a[k] for a in adapters]) for k in adapters[0]}


def fleet_row_tenant(n_tenants: int, batch_per_tenant: int, device=None) -> torch.Tensor:
    """(N * bpt,) int32 row -> tenant map of a tenant-contiguous fleet batch."""
    return torch.arange(n_tenants, dtype=torch.int32, device=device).repeat_interleave(batch_per_tenant)


def fleet_index_matrix(
    epoch: int, n_tenants: int, samples_per_tenant: int, batch_per_tenant: int, *, seed: int = 0
) -> np.ndarray:
    """(steps, N * bpt) global sample ids: column block t is tenant t's
    epoch order (its own RNG stream), offset into its cache partition. Every
    row is visited (``tail="wrap"``), so the populate epoch fills the whole
    cache."""
    return batch_plan.fleet_index_matrix(
        epoch, n_tenants, samples_per_tenant, batch_per_tenant, seed=seed
    )


def per_tenant_loss(
    params: Params, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor, n_tenants: int
) -> torch.Tensor:
    """(N,) masked-mean cross entropy per tenant over a tenant-contiguous
    batch: entry t equals ``lm_loss`` on tenant t's rows alone."""
    ll, cnt = lm_loss_rows(params, cfg, h, labels)
    ll = torch.sum(ll.reshape(n_tenants, -1), dim=1)
    cnt = torch.sum(cnt.reshape(n_tenants, -1), dim=1)
    return -ll / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# Losses and steps
# ---------------------------------------------------------------------------


def blocked_skip_sum(
    acts: torch.Tensor, a_pool: torch.Tensor, b_pool: torch.Tensor, n_tenants: int
) -> torch.Tensor:
    """The grouped skip-sum of a fleet batch written as a batched einsum:
    rows are tenant-contiguous with a uniform count per tenant, so the
    per-row pool gather collapses into one product per tenant. The
    ``use_kernel=False`` route, differentiable in the pools by autograd;
    activations are data.

    acts: (L, B, S, D), B = n_tenants * bpt tenant-major; a_pool: (N, L, D, R);
    b_pool: (N, L, R, D) -> (B, S, D) in acts.dtype."""
    acts = acts.detach()
    lnum, b, s, d = acts.shape
    at = acts.reshape(lnum, n_tenants, (b // n_tenants) * s, d)
    z = torch.einsum("ltmd,tldr->tlmr", at, a_pool.to(acts.dtype))
    out = torch.einsum("tlmr,tlrd->tmd", z, b_pool.to(acts.dtype))
    return out.to(acts.dtype).reshape(b, s, d)


def _check_fleet_mode(sl: SL.SkipLoRAConfig) -> None:
    if sl.mode not in ("full", "int8"):
        raise ValueError(f"fleet training supports modes 'full' and 'int8', not {sl.mode!r}")


def _fleet_skip_sum(
    stacked: Params,
    row_tenant: torch.Tensor,
    n_tenants: int,
    dtype,
    *,
    acts: Optional[torch.Tensor] = None,          # (L, B, S, D) float
    acts_q: Optional[torch.Tensor] = None,        # (L, B, S, D) int8
    acts_scale: Optional[torch.Tensor] = None,    # (L, B, S) fp32
    use_kernel: bool = True,
    freeze_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One grouped skip-sum for a fleet batch. ``use_kernel=True``: the
    trainable grouped sums (K5, or K8 on the raw int8 payload, forward; K9
    backward on the card); ``use_kernel=False``: ``blocked_skip_sum`` (an
    int8 payload is dequantised first)."""
    if use_kernel:
        if acts_q is not None:
            return skip_lora_grouped_train_int8(
                acts_q, acts_scale, stacked["A"], stacked["B"], row_tenant, freeze_mask=freeze_mask
            )
        return skip_lora_grouped_train(acts, stacked["A"], stacked["B"], row_tenant, freeze_mask=freeze_mask)
    a_pool, b_pool = stacked["A"], stacked["B"]
    if freeze_mask is not None:
        a_pool = freeze_pool_slots(a_pool, freeze_mask)
        b_pool = freeze_pool_slots(b_pool, freeze_mask)
    if acts_q is not None:
        acts = (acts_q.float() * acts_scale[..., None]).to(dtype)
    return blocked_skip_sum(acts, a_pool, b_pool, n_tenants)


def fleet_cached_loss(
    params: Params,
    cfg: ModelConfig,
    sl: SL.SkipLoRAConfig,
    stacked: Params,
    vals: dict[str, torch.Tensor],
    row_tenant: torch.Tensor,
    n_tenants: int,
    dtype,
    *,
    use_kernel: bool = True,
    freeze_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fleet loss from cached values: one grouped skip-sum for the whole
    batch, reduced per tenant. Returns (sum of per-tenant losses, (N,)
    per-tenant losses)."""
    _check_fleet_mode(sl)
    if sl.mode == "int8":
        skip = _fleet_skip_sum(
            stacked, row_tenant, n_tenants, dtype,
            acts_q=SL._swap01(vals["acts_q"], torch.int8),
            acts_scale=SL._swap01(vals["acts_scale"], torch.float32),
            use_kernel=use_kernel, freeze_mask=freeze_mask,
        )
    else:
        skip = _fleet_skip_sum(
            stacked, row_tenant, n_tenants, dtype, acts=SL._swap01(vals["acts"], dtype),
            use_kernel=use_kernel, freeze_mask=freeze_mask,
        )
    h = vals["y_base"].to(dtype) + skip.to(dtype)
    per = per_tenant_loss(params, cfg, h, vals["labels"], n_tenants)
    return torch.sum(per), per


def _adapter_step(optimizer, stacked, opt_state, loss_fn):
    """value_and_grad of ``loss_fn(stacked) -> (loss, per)`` and one
    optimizer update -> (stacked, opt_state, per detached)."""
    _, per, grads = SL.value_and_grad(loss_fn, stacked)
    updates, opt_state = optimizer.update(grads, opt_state, stacked)
    return apply_updates(stacked, updates), opt_state, per.detach()


def make_fleet_cached_step_from_vals(
    cfg: ModelConfig,
    sl: SL.SkipLoRAConfig,
    optimizer,
    n_tenants: int,
    *,
    use_kernel: bool = True,
    freeze_mask: Optional[torch.Tensor] = None,
):
    """One fleet adapter step from already-gathered cache values:
    step(params, stacked, opt_state, vals, row_tenant) -> (stacked,
    opt_state, per-tenant losses (N,))."""
    dtype = model_dtype(cfg)

    def step(params, stacked, opt_state, vals, row_tenant):
        return _adapter_step(optimizer, stacked, opt_state, lambda t: fleet_cached_loss(
            params, cfg, sl, t, vals, row_tenant, n_tenants, dtype,
            use_kernel=use_kernel, freeze_mask=freeze_mask,
        ))

    return step


def make_fleet_cached_epoch(
    cfg: ModelConfig,
    sl: SL.SkipLoRAConfig,
    optimizer,
    n_tenants: int,
    *,
    use_kernel: bool = True,
    freeze_mask: Optional[torch.Tensor] = None,
    loop: bool = False,
    graphs: Optional[GraphCache] = None,
):
    """A fleet cached epoch: cache gathers and grouped adapter steps, no
    backbone compute, every tenant advanced each step. On CUDA tensors
    (``loop=False``) the steps are graph replays (``lm_skiplora.GRAPHS`` or
    ``graphs``); the arguments are left alone.

    epoch(params, stacked, opt_state, cache, idx_mat, row_tenant)
        -> (stacked, opt_state, losses (steps, N))"""
    run = _cached_epoch_run(cfg, sl, optimizer, n_tenants, use_kernel=use_kernel, freeze_mask=freeze_mask,
                            loop=loop, graphs=graphs)

    def epoch(params, stacked, opt_state, cache, idx_mat, row_tenant):
        stacked, opt_state, losses, _, _ = run(params, stacked, opt_state, cache, idx_mat, row_tenant)
        return stacked, opt_state, losses

    return epoch


def _cached_epoch_run(cfg, sl, optimizer, n_tenants, *, use_kernel, freeze_mask, loop, graphs,
                      eval_pre: bool = False, eval_post: bool = False):
    """The fleet cached epoch with the held-out loss before and/or after:
    run(params, stacked, opt_state, cache, idx_mat, row_tenant, eval_idx=None,
    eval_row_tenant=None) -> (stacked, opt_state, losses, pre | None, post | None)."""
    step = make_fleet_cached_step_from_vals(
        cfg, sl, optimizer, n_tenants, use_kernel=use_kernel, freeze_mask=freeze_mask
    )
    ev = make_fleet_eval_loss(cfg, sl, n_tenants, use_kernel=use_kernel)

    def loop_run(params, stacked, opt_state, cache, idx_mat, row_tenant, eval_idx, eval_row_tenant):
        def held_out(t):
            return ev(params, t, cache_read(cache, eval_idx), eval_row_tenant)

        pre = held_out(stacked) if eval_pre else None
        losses = []
        for idx in idx_mat:
            stacked, opt_state, per = step(params, stacked, opt_state, cache_read(cache, idx), row_tenant)
            losses.append(per)
        post = held_out(stacked) if eval_post else None
        return stacked, opt_state, torch.stack(losses), pre, post

    def run(params, stacked, opt_state, cache, idx_mat, row_tenant, eval_idx=None, eval_row_tenant=None):
        if not SL.graphed(cache.valid, params, loop):
            return loop_run(params, stacked, opt_state, cache, idx_mat, row_tenant, eval_idx, eval_row_tenant)
        carry, struct = SL.carry_leaves(stacked, opt_state)
        consts = [row_tenant] + ([eval_idx, eval_row_tenant] if eval_pre or eval_post else [])

        def graph_step(live, carry, consts, idx):
            p, c = live
            t, o = SL.from_carry(carry, struct)
            t, o, per = step(p, t, o, cache_read(c, idx), consts[0])
            return SL.carry_leaves(t, o)[0], per

        def held_out(live, carry, consts):
            p, c = live
            return ev(p, SL.from_carry(carry, struct)[0], cache_read(c, consts[1]), consts[2])

        key = ("fleet_cached", cfg, sl, optimizer, n_tenants, use_kernel, storage_sig(freeze_mask), eval_pre,
               eval_post, struct, storage_sig(params), SL.cache_sig(cache))
        new, losses, extra = SL.run_epoch_graph(
            graphs, key, graph_step, (params, cache), carry, consts, idx_mat.to(cache.valid.device),
            before=held_out if eval_pre else None, after=held_out if eval_post else None,
            what=f"the fleet cached step ({cfg.name}, mode {sl.mode}, {n_tenants} tenants)")
        stacked, opt_state = SL.from_carry(new, struct)
        return stacked, opt_state, losses, extra.get("before"), extra.get("after")

    return run


def make_fleet_eval_loss(cfg: ModelConfig, sl: SL.SkipLoRAConfig, n_tenants: int, *, use_kernel: bool = True):
    """Per-tenant held-out loss from cached values (the shadow-eval body):
    the backbone term is in the cache already, so eval is the cached step's
    grouped skip-sum and loss without the gradient.

    eval_loss(params, stacked, vals, row_tenant) -> (N,) per-tenant loss."""
    dtype = model_dtype(cfg)

    @torch.no_grad()
    def eval_loss(params, stacked, vals, row_tenant):
        _, per = fleet_cached_loss(
            params, cfg, sl, stacked, vals, row_tenant, n_tenants, dtype, use_kernel=use_kernel
        )
        return per

    return eval_loss


def make_fleet_cached_epoch_eval(
    cfg: ModelConfig,
    sl: SL.SkipLoRAConfig,
    optimizer,
    n_tenants: int,
    *,
    use_kernel: bool = True,
    eval_pre: bool = True,
    eval_post: bool = True,
    loop: bool = False,
    graphs: Optional[GraphCache] = None,
):
    """``make_fleet_cached_epoch`` with the held-out per-tenant loss taken
    from the cached rows just before (``eval_pre``) and/or just after
    (``eval_post``) the epoch's steps: no backbone forward. On CUDA tensors
    each eval is a graph of its own, replayed before the first step's
    replay or after the last.

    epoch(params, stacked, opt_state, cache, idx_mat, row_tenant, eval_idx,
          eval_row_tenant)
        -> (stacked, opt_state, losses (steps, N), pre (N,) | None, post (N,) | None)"""
    return _cached_epoch_run(cfg, sl, optimizer, n_tenants, use_kernel=use_kernel, freeze_mask=None, loop=loop,
                             graphs=graphs, eval_pre=eval_pre, eval_post=eval_post)


def make_fleet_populate_epoch(
    cfg: ModelConfig,
    sl: SL.SkipLoRAConfig,
    optimizer,
    n_tenants: int,
    *,
    use_kernel: bool = True,
    freeze_mask: Optional[torch.Tensor] = None,
    loop: bool = False,
    graphs: Optional[GraphCache] = None,
):
    """Fleet populate epoch: one adapter-free backbone forward per fleet
    batch serves every tenant's rows (the backbone is tenant-independent),
    the activations go into each tenant's cache partition, and the adapter
    step runs on the just-collected full-precision activations through the
    grouped sum (mode ``int8`` quantises only what the cache keeps, like the
    single-tenant populate step). On CUDA tensors (``loop=False``) the
    steps are graph replays; the cache is written in place, the other
    arguments are left alone.

    epoch(params, stacked, opt_state, cache, tokens, labels, idx_mat, row_tenant)
        -> (stacked, opt_state, cache, losses (steps, N))"""
    dtype = model_dtype(cfg)
    _check_fleet_mode(sl)

    def step(params, stacked, opt_state, cache, tokens, labels, idx, row_tenant):
        out = lm_forward(params, cfg, tokens[idx], mode="train", collect_acts=True)
        acts, y_base, lab = out["acts"].detach(), out["y_base"].detach(), labels[idx]
        values = SL._encode_acts(acts, None, sl)
        values["y_base"] = y_base
        values["labels"] = lab
        cache_write(cache, idx, values)

        def loss_fn(t):
            skip = _fleet_skip_sum(t, row_tenant, n_tenants, dtype, acts=acts.to(dtype),
                                   use_kernel=use_kernel, freeze_mask=freeze_mask)
            h = y_base.to(dtype) + skip.to(dtype)
            per = per_tenant_loss(params, cfg, h, lab, n_tenants)
            return torch.sum(per), per

        return _adapter_step(optimizer, stacked, opt_state, loss_fn)

    def epoch(params, stacked, opt_state, cache, tokens, labels, idx_mat, row_tenant):
        if not SL.graphed(tokens, params, loop):
            losses = []
            for idx in idx_mat:
                stacked, opt_state, per = step(params, stacked, opt_state, cache, tokens, labels, idx, row_tenant)
                losses.append(per)
            return stacked, opt_state, cache, torch.stack(losses)
        carry, struct = SL.carry_leaves(stacked, opt_state)

        def graph_step(live, carry, consts, idx):
            p, c, tok, lab = live
            t, o = SL.from_carry(carry, struct)
            t, o, per = step(p, t, o, c, tok, lab, idx, consts[0])
            return SL.carry_leaves(t, o)[0], per

        key = ("fleet_populate", cfg, sl, optimizer, n_tenants, use_kernel, storage_sig(freeze_mask), struct,
               storage_sig(params), SL.cache_sig(cache), storage_sig(tokens), storage_sig(labels))
        new, losses, _ = SL.run_epoch_graph(
            graphs, key, graph_step, (params, cache, tokens, labels), carry, [row_tenant],
            idx_mat.to(tokens.device), what=f"the fleet populate step ({cfg.name}, mode {sl.mode}, {n_tenants} tenants)")
        stacked, opt_state = SL.from_carry(new, struct)
        return stacked, opt_state, cache, losses

    return epoch


def fleet_cached_epoch_via_engine(step, params, stacked, opt_state, engine, idx_mat, row_tenant):
    """A fleet cached epoch streamed through a ``TieredCacheEngine``: one
    engine read a step, the next fleet batch prefetched on the engine's
    background thread while the step runs. ``step`` is a
    ``make_fleet_cached_step_from_vals`` product. Returns (stacked,
    opt_state, losses (steps, N))."""
    pers = []
    for _, vals in engine.stream_batches(idx_mat):
        stacked, opt_state, per = step(params, stacked, opt_state, vals, row_tenant)
        pers.append(per)
    return stacked, opt_state, torch.stack(pers)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetResult:
    adapters: Params                  # stacked {"A": (N, L, D, R), "B": ...}
    opt_state: Any
    losses: np.ndarray                # (epochs, steps, n_tenants)
    epoch_times_s: list[float]
    cache: SkipCache | None = None
    engine: Any = None


def fleet_finetune(
    generator: torch.Generator,
    cfg: ModelConfig,
    sl: SL.SkipLoRAConfig,
    params: Params,
    tokens: torch.Tensor,             # (n_tenants, n_per, seq) int
    labels: torch.Tensor,             # (n_tenants, n_per, seq) int
    *,
    epochs: int,
    batch_per_tenant: int,
    lr: float = 1e-3,
    optimizer=None,
    use_kernel: bool = True,
    freeze_mask: Optional[torch.Tensor] = None,
    seed: int = 0,
    adapters: Optional[Params] = None,
    engine=None,
    on_epoch=None,
    loop: bool = False,
    graphs: Optional[GraphCache] = None,
) -> FleetResult:
    """Algorithm 1 for a whole fleet, on the device the params live on:
    epoch 0 populates every tenant's cache partition (one shared backbone
    forward per fleet batch); epochs >= 1 run cached grouped steps with no
    backbone compute. ``adapters`` gives the initial stacked adapters
    (default: ``init_fleet_adapters(generator, ...)``). Each epoch's time
    is taken once its losses are on the host; ``on_epoch(epoch, losses
    (steps, N), seconds)`` is called after each epoch.

    With ``engine`` (a ``TieredCacheEngine`` laid out for ``n_tenants *
    n_per`` samples) the populated rows go into the engine after epoch 0,
    outside its time, and the cached epochs stream out of it
    (``fleet_cached_epoch_via_engine``). The populate epoch still holds the
    whole fleet cache once: the engine's budget governs the cached epochs.
    On the card the epochs are graph replays (``graphs``, default
    ``lm_skiplora.GRAPHS``); ``loop=True`` runs their eager loops."""
    _check_fleet_mode(sl)
    n_tenants, n_per, seq = tokens.shape
    batch_per_tenant = min(batch_per_tenant, n_per)   # fleet_index_matrix clamps the same way
    dev = params["embed"]["table"].device
    stacked = adapters if adapters is not None else init_fleet_adapters(generator, cfg, sl, n_tenants)
    opt = optimizer if optimizer is not None else adamw(lr)
    opt_state = opt.init(stacked)
    row_tenant = fleet_row_tenant(n_tenants, batch_per_tenant, device=dev)
    tokens_flat = torch.as_tensor(tokens, device=dev).reshape(n_tenants * n_per, seq)
    labels_flat = torch.as_tensor(labels, device=dev).reshape(n_tenants * n_per, seq)
    cache = SL.init_lm_cache(n_tenants * n_per, cfg, sl, seq, device=dev)
    kw = dict(use_kernel=use_kernel, freeze_mask=freeze_mask)
    populate_epoch = make_fleet_populate_epoch(cfg, sl, opt, n_tenants, loop=loop, graphs=graphs, **kw)
    cached_epoch = make_fleet_cached_epoch(cfg, sl, opt, n_tenants, loop=loop, graphs=graphs, **kw)
    engine_step = make_fleet_cached_step_from_vals(cfg, sl, opt, n_tenants, **kw)

    losses, times = [], []
    for e in range(epochs):
        idx_mat = torch.as_tensor(
            fleet_index_matrix(e, n_tenants, n_per, batch_per_tenant, seed=seed), device=dev
        )
        t0 = time.perf_counter()
        if e == 0:
            stacked, opt_state, cache, ls = populate_epoch(
                params, stacked, opt_state, cache, tokens_flat, labels_flat, idx_mat, row_tenant
            )
        elif engine is None:
            stacked, opt_state, ls = cached_epoch(params, stacked, opt_state, cache, idx_mat, row_tenant)
        else:
            stacked, opt_state, ls = fleet_cached_epoch_via_engine(
                engine_step, params, stacked, opt_state, engine, idx_mat, row_tenant
            )
        ls = ls.cpu().numpy()   # waits for the device
        times.append(time.perf_counter() - t0)
        losses.append(ls)
        if e == 0 and engine is not None:
            # Hand the populated partitions to the engine (a one-off staging
            # cost outside the epochs); rows past its budget spill to host.
            for row in idx_mat:
                engine.write(row, cache_read(cache, row))
            cache = None
        if on_epoch is not None:
            on_epoch(e, ls, times[-1])
    return FleetResult(
        adapters=stacked, opt_state=opt_state, losses=np.stack(losses), epoch_times_s=times, cache=cache,
        engine=engine,
    )


def write_back_to_pool(pool, tenants, stacked: Params) -> list[int]:
    """Install a fleet's trained stacks into a serving ``AdapterPool`` with
    one batched registration; tenant ``tenants[i]`` gets stack row i.
    Returns the assigned slots."""
    return pool.register_many(tenants, stacked)
