"""Step factories and the input / spec trees of every dry-run cell: the
counterpart of ``repro.launch.steps``.

``build_cell(arch, shape, mesh, step_kind)`` returns ``(fn, example_args,
in_specs, out_specs)``:

  step kinds:
    train            : full-backprop AdamW train step (baseline)
    finetune_populate: Skip2-LoRA populate step (backbone forward, adapter
                       gradient, the cache values as outputs)
    finetune_cached  : Skip2-LoRA cached step (the paper's fast path, on a
                       batch of cached activations)
    prefill          : serve_prefill over the full prompt
    decode           : one-token serve_decode against a seq-long cache
    decode_adapted   : decode with Skip-LoRA adapters applied

The example args are tensors on the ``meta`` device (shapes and dtypes, no
memory): ``lm.param_shapes``, serve caches made with ``device="meta"``,
optimizer state from the optimizer's own ``init`` on meta tensors. The
specs are the port's spec tuples (``runtime.sharding``) where the reference
has ``NamedSharding``s; ``named``, ``replicated`` and ``sharding_scope``
have no counterpart (a spec tree places nothing here). ``fn`` runs on any
tensors: meta ones (the dry-run, ``launch.dryrun``), or real ones on one
device or over a model group (``params`` a ``tp.GroupParams``), as one data
shard's program. ``arch`` may also be a ``ModelConfig`` and ``shape`` a
``ShapeCell``, so that tests and the card build small cells.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import lm_skiplora as SL
from repro_torch.launch.shapes import SHAPES, ShapeCell
from repro_torch.models import lm as LM
from repro_torch.models import tp as TP
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import OptState, adamw, apply_updates, clip_by_global_norm, tree_leaves, tree_map
from repro_torch.runtime import sharding as SH

Params = Any

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Spec helpers
# ---------------------------------------------------------------------------


def _guarded_spec(shape: tuple, logical: tuple, mesh, rules: SH.AxisRules) -> tuple:
    parts = []
    for dim, a in zip(shape, logical):
        r = rules.resolve(mesh.axis_names, a)
        if r is not None and dim % SH._axis_size(mesh, r) != 0:
            r = None  # argument specs must divide evenly
        parts.append(r)
    parts += [None] * (len(shape) - len(logical))
    return tuple(parts)


def _cache_leaf_spec(name: str, shape: tuple, mesh, rules: SH.AxisRules) -> tuple:
    if name in ("k", "v"):             # (B, S, nk, hd)
        # head-split KV where the KV heads divide the model axis, else the
        # sequence over it (context parallelism), composing with 'data'
        # when the long-decode rules already put the sequence there
        nk = shape[2]
        heads_ok = nk % SH._axis_size(mesh, "model") == 0
        seq_axes = []
        if rules.resolve(mesh.axis_names, "seq") is not None:
            seq_axes.append("data")
        if not heads_ok:
            seq_axes.append("model")
        seq_part = tuple(seq_axes) if seq_axes else None
        if seq_part is not None and shape[1] % SH._axis_size(mesh, seq_part) != 0:
            seq_part = None
        return _guarded_spec(shape, ("batch", seq_part, "heads" if heads_ok else None, None), mesh, rules)
    if name == "ssm":                  # (B, Di, N)
        return _guarded_spec(shape, ("batch", "d_inner", None), mesh, rules)
    if name == "conv":                 # (B, K-1, Di)
        return _guarded_spec(shape, ("batch", None, "d_inner"), mesh, rules)
    if name == "c":                    # (B, H, hd, hd) mLSTM; sLSTM's (B, D) takes "heads" too
        return _guarded_spec(shape, ("batch", "heads", None, None), mesh, rules)
    return _guarded_spec(shape, ("batch",) + (None,) * (len(shape) - 1), mesh, rules)


def cache_specs(caches: list[Params], mesh, rules: SH.AxisRules) -> list[Params]:
    """Specs of serve caches (KV and recurrent states), one dict a layer."""
    return [{name: _cache_leaf_spec(name, tuple(t.shape), mesh, rules) for name, t in layer.items()}
            for layer in caches]


def batch_specs(batch: Params, mesh, rules: SH.AxisRules) -> Params:
    return tree_map(lambda x: _guarded_spec(tuple(x.shape), ("batch",), mesh, rules), batch)


def opt_state_specs(opt_state: OptState, p_specs: Params, mesh) -> OptState:
    """OptState specs: the step replicated; the moments ZeRO-1-upgraded
    (mu / nu share the params' tree)."""
    mu = SH.zero1_specs(opt_state.mu, p_specs, mesh) if opt_state.mu is not None else None
    nu = SH.zero1_specs(opt_state.nu, p_specs, mesh) if opt_state.nu is not None else None
    return OptState(step=(), mu=mu, nu=nu)


# ---------------------------------------------------------------------------
# Cell builder
# ---------------------------------------------------------------------------


STEP_KINDS = (
    "train", "finetune_populate", "finetune_cached", "prefill", "decode",
    "decode_adapted",
)


def _grid_batch_rules(kw: dict, shape: ShapeCell, mesh, vocab_size: int, batch_cands) -> SH.AxisRules:
    for cand in batch_cands:
        axes = tuple(a for a in cand if a in mesh.axis_names)
        if axes and shape.batch % SH._axis_size(mesh, axes) == 0:
            kw["batch"] = axes
            break
    # the loss: the vocab over the whole grid where it divides (the logits'
    # batch replicated), else batch on 'data' x vocab on 'model'
    grid = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    if vocab_size % SH._axis_size(mesh, grid) == 0:
        kw["vocab"] = grid
        kw["logits_batch"] = None
    else:
        kw["vocab"] = "model"
        kw["logits_batch"] = ("data",)
    return SH.AxisRules(**kw)


def rules_for(shape: ShapeCell, mesh, strategy: str = "tp", vocab_size: int = 0) -> SH.AxisRules:
    if strategy == "ep":
        return _grid_batch_rules(dict(SH.EP_RULES_KW), shape, mesh, vocab_size,
                                 (("data", "model"), ("pod", "data"), ("data",)))
    if strategy == "fsdp":
        return _grid_batch_rules(dict(SH.FSDP_RULES_KW), shape, mesh, vocab_size,
                                 (("pod", "data", "model"), ("data", "model"), ("pod", "data"), ("data",)))
    if shape.kind == "decode" and shape.batch < SH._axis_size(mesh, "data"):
        # long-context decode (batch 1): sequence parallelism over the cache
        return SH.AxisRules(seq="data")
    return SH.AxisRules()


def default_skiplora(cfg: ModelConfig) -> SL.SkipLoRAConfig:
    return SL.SkipLoRAConfig(rank=16, mode="full", cache_dtype="bfloat16")


def _resolve(arch, shape) -> tuple[ModelConfig, ShapeCell]:
    cfg = get_config(arch) if isinstance(arch, str) else arch
    return cfg, SHAPES[shape] if isinstance(shape, str) else shape


def param_specs_for(params: Params, mesh, strategy: str, cfg: ModelConfig) -> Params:
    """The backbone's specs under a strategy: 'tp' Megatron on 'model' with
    the FSDP upgrade where the weights do not fit (jamba-398B), 'fsdp'
    every weight split, 'ep' experts on 'model' and the rest as 'fsdp'."""
    if strategy == "fsdp":
        return SH.fsdp_param_specs(params, mesh, cfg=cfg)
    if strategy == "ep":
        return SH.ep_param_specs(params, mesh, cfg=cfg)
    specs, _ = SH.maybe_fsdp_specs(params, SH.param_specs(params, mesh), mesh)
    return specs


def _batch_shapes(cfg: ModelConfig, b: int, s: int) -> dict[str, torch.Tensor]:
    bs = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META),
          "labels": torch.empty((b, s), dtype=torch.int32, device=META)}
    if cfg.frontend:
        bs["prefix_embeds"] = torch.empty((b, cfg.frontend_seq, cfg.d_model), dtype=LM.model_dtype(cfg), device=META)
    return bs


def _adapter_specs() -> dict[str, tuple]:
    # A (L, D, R): tiny, replicated; B (L, R, D): the output dim on 'model'
    return {"A": (None, None, None), "B": (None, None, "model")}


def _long(t: torch.Tensor) -> torch.Tensor:
    """int32 ids as the int64 the port's lookups take."""
    return t.long()


def _batch(batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: _long(v) if k in ("tokens", "labels") else v for k, v in batch.items()}


def trainable_tree(params: Params):
    """(tree of the tensors a full-backprop step trains, rebuild): a group's
    member trees, or the params themselves."""
    if TP.is_group(params):
        return params.members, lambda members: TP.GroupParams(members, params.specs, params.devices)
    return params, lambda tree: tree


def _replicated_grads(params: Params, grads: Params) -> Params:
    """A group's replicated leaves are used through member 0's copy alone
    (``tp.GroupParams.local``): every member's copy takes member 0's
    gradient, as each Megatron rank computes the same one."""
    if not TP.is_group(params):
        return grads
    flat0, specs = SH._leaves(grads[0]), SH._leaves(params.specs)
    out = [grads[0]]
    for g in grads[1:]:
        leaves = [g0 if all(p is None for p in spec) else gi
                  for g0, gi, spec in zip(flat0, SH._leaves(g), specs)]
        out.append(_unflatten(g, iter(leaves)))
    return out


def _group_update(opt, params, members: list, grads: list, opt_state: OptState):
    """``clip_by_global_norm(grads, 1.0)`` and the optimizer step of a
    group's member trees, each member's on its device (``tp.as_member``):
    the global norm sums each member's partial sum of squares (its split
    leaves; member 0's also the replicated ones, counted once) through
    ``tp.reduce``, then every member scales and updates its own leaves.
    ``opt_state``'s moments are lists of member trees (``opt.init`` of the
    members)."""
    specs = SH._leaves(params.specs)
    partial = []
    for i, g in enumerate(grads):
        with TP.as_member(i):
            leaves = [x for x, spec in zip(SH._leaves(g), specs) if i == 0 or any(p is not None for p in spec)]
            partial.append(sum(torch.sum(torch.square(x.float())) for x in leaves))
    norm = torch.sqrt(TP.reduce(partial, params.home))
    scale = torch.clamp(1.0 / torch.clamp(norm, min=1e-9), max=1.0)
    new, mu, nu, step = [], [], [], opt_state.step
    for i, (m, g) in enumerate(zip(members, grads)):
        with TP.as_member(i):
            dev = params.devices[i]
            sc = scale.to(dev)
            g = tree_map(lambda x: x.to(dev) * sc.to(x.dtype), g)
            u, st = opt.update(g, OptState(step=opt_state.step, mu=opt_state.mu[i], nu=opt_state.nu[i]), m)
            new.append(apply_updates(m, u))
            mu.append(st.mu)
            nu.append(st.nu)
            step = st.step
    return new, OptState(step=step, mu=mu, nu=nu)


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflatten(v, it) for v in tree]
    return next(it)


def _value_and_grad(loss_fn, tree: Params):
    """loss, grads of ``loss_fn(tree)`` over every leaf of ``tree`` (zeros
    for a leaf the loss does not reach)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(tree)]
    t = _unflatten(tree, iter(leaves))
    with torch.enable_grad():
        loss = loss_fn(t)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(tree, iter(grads))


def build_cell(
    arch: Union[str, ModelConfig],
    shape: Union[str, ShapeCell],
    mesh,
    step_kind: str,
    *,
    skiplora: Optional[SL.SkipLoRAConfig] = None,
    strategy: str = "tp",
):
    """Returns (fn, example_args (meta tensors), in_specs, out_specs).

    strategy:
      tp   -- Megatron on 'model' + data parallelism on ('pod', 'data');
              upgrades to mixed FSDP when the weights do not fit.
      fsdp -- the batch over the whole (data x model) grid, weights fully
              split, gathered a layer at a time.
      ep   -- 'fsdp' for the dense path, the experts on 'model'.
    """
    cfg, shape = _resolve(arch, shape)
    rules = rules_for(shape, mesh, strategy, cfg.vocab_size)
    dt = LM.model_dtype(cfg)

    params_shape = LM.param_shapes(cfg)
    p_specs = param_specs_for(params_shape, mesh, strategy, cfg)

    if step_kind == "train":
        opt = adamw(3e-4, weight_decay=0.1)
        opt_shape = opt.init(params_shape)
        o_specs = opt_state_specs(opt_shape, p_specs, mesh)
        batch_shape = _batch_shapes(cfg, shape.batch, shape.seq)
        b_specs = batch_specs(batch_shape, mesh, rules)

        def train_step(params, opt_state, batch):
            tree, rebuild = trainable_tree(params)
            loss, grads = _value_and_grad(lambda t: LM.train_loss_fn(rebuild(t), cfg, _batch(batch)), tree)
            if TP.is_group(params):
                new, opt_state = _group_update(opt, params, tree, _replicated_grads(params, grads), opt_state)
                return rebuild(new), opt_state, loss
            grads = clip_by_global_norm(grads, 1.0)
            updates, opt_state = opt.update(grads, opt_state, tree)
            return rebuild(apply_updates(tree, updates)), opt_state, loss

        train_step.opt = opt
        args = (params_shape, opt_shape, batch_shape)
        return train_step, args, (p_specs, o_specs, b_specs), (p_specs, o_specs, ())

    if step_kind in ("finetune_populate", "finetune_cached"):
        sl = skiplora or default_skiplora(cfg)
        opt = adamw(1e-3)
        ad_shape = SL.init_adapters(LM._MetaGenerator(), cfg, sl)
        trainable_shape, static_shape = SL.split_trainable(ad_shape, sl)
        opt_shape = opt.init(trainable_shape)
        t_specs, s_specs = SL.split_trainable(_adapter_specs(), sl)
        o_specs = OptState(step=(), mu=tree_map(lambda _: (), opt_shape.mu), nu=tree_map(lambda _: (), opt_shape.nu))

        if step_kind == "finetune_populate":
            batch_shape = _batch_shapes(cfg, shape.batch, shape.seq)
            b_specs = batch_specs(batch_shape, mesh, rules)

            def populate_step(params, trainable, static, batch):
                loss, (acts, y_base, _), grads = SL.value_and_grad(
                    lambda t: SL.populate_loss_fn(params, cfg, SL.merge_adapters(t, static), _batch(batch)),
                    trainable)
                values = SL._encode_acts(acts, SL.merge_adapters(trainable, static), sl)
                values["y_base"] = y_base
                trainable = apply_updates(trainable, tree_map(lambda g: -1e-3 * g, grads))
                return trainable, values, loss

            args = (params_shape, trainable_shape, static_shape, batch_shape)
            return populate_step, args, (p_specs, t_specs, s_specs, b_specs), None

        # finetune_cached: a batch of cached activations
        b, s = shape.batch, shape.seq
        l, d, r = cfg.n_layers, cfg.d_model, sl.rank
        cdt = SL._CACHE_DTYPES[sl.cache_dtype]
        empty = lambda shp, dtype: torch.empty(shp, dtype=dtype, device=META)  # noqa: E731
        if sl.mode == "freeze_a":
            vals_shape = {"z": empty((b, l, s, r), cdt)}
        elif sl.mode == "int8":
            vals_shape = {"acts_q": empty((b, l, s, d), torch.int8), "acts_scale": empty((b, l, s), torch.float32)}
        else:
            vals_shape = {"acts": empty((b, l, s, d), cdt)}
        vals_shape["y_base"] = empty((b, s, d), cdt)
        vals_shape["labels"] = empty((b, s), torch.int32)
        v_specs = batch_specs(vals_shape, mesh, rules)

        def cached_step(params, trainable, static, opt_state, vals):
            vals = {**vals, "labels": _long(vals["labels"])}
            loss, _, grads = SL.value_and_grad(
                lambda t: (SL.cached_loss_fn(params, cfg, sl, SL.merge_adapters(t, static), vals, dt), None),
                trainable)
            updates, opt_state = opt.update(grads, opt_state, trainable)
            return apply_updates(trainable, updates), opt_state, loss

        cached_step.opt = opt
        args = (params_shape, trainable_shape, static_shape, opt_shape, vals_shape)
        return cached_step, args, (p_specs, t_specs, s_specs, o_specs, v_specs), (t_specs, o_specs, ())

    if step_kind == "prefill":
        b, s = shape.batch, shape.seq
        # the frontend prefix takes the first positions of the window; text
        # or code tokens fill the rest (total == shape.seq)
        s_tok = s - (cfg.frontend_seq if cfg.frontend else 0)
        tokens_shape = torch.empty((b, s_tok), dtype=torch.int32, device=META)
        cache_shape = LM.init_serve_caches(cfg, b, s, device=META)
        c_specs = cache_specs(cache_shape, mesh, rules)
        prefix_shape = (torch.empty((b, cfg.frontend_seq, cfg.d_model), dtype=dt, device=META)
                        if cfg.frontend else None)

        def prefill_step(params, tokens, caches, prefix_embeds):
            return LM.serve_prefill(params, cfg, _long(tokens), caches, prefix_embeds=prefix_embeds)

        args = (params_shape, tokens_shape, cache_shape, prefix_shape)
        pre_specs = batch_specs(prefix_shape, mesh, rules) if prefix_shape is not None else None
        return prefill_step, args, (p_specs, batch_specs(tokens_shape, mesh, rules), c_specs, pre_specs), ((), c_specs)

    if step_kind in ("decode", "decode_adapted"):
        b, s = shape.batch, shape.seq
        token_shape = torch.empty((b, 1), dtype=torch.int32, device=META)
        pos_shape = torch.empty((), dtype=torch.int32, device=META)
        cache_shape = LM.init_serve_caches(cfg, b, s, device=META)
        c_specs = cache_specs(cache_shape, mesh, rules)
        tok_specs = batch_specs(token_shape, mesh, rules)

        if step_kind == "decode_adapted":
            # post-fine-tune serving: the adapters applied at decode time
            # (the skip topology does not merge into the weights)
            sl = skiplora or default_skiplora(cfg)
            ad_shape = SL.init_adapters(LM._MetaGenerator(), cfg, sl)

            def decode_adapted_step(params, adapters, token, pos, caches):
                return LM.serve_decode(params, cfg, _long(token), pos, caches,
                                       adapters=SL.adapters_to_stack(adapters))

            args = (params_shape, ad_shape, token_shape, pos_shape, cache_shape)
            return decode_adapted_step, args, (p_specs, _adapter_specs(), tok_specs, (), c_specs), ((), c_specs)

        def decode_step(params, token, pos, caches):
            return LM.serve_decode(params, cfg, _long(token), pos, caches)

        args = (params_shape, token_shape, pos_shape, cache_shape)
        return decode_step, args, (p_specs, tok_specs, (), c_specs), ((), c_specs)

    raise ValueError(step_kind)
