"""Paper-scale backbone: the 3-layer DNN of Section 5.1.

Counterpart of ``repro.models.mlp``. Structure per Table 2: FC1 -> (LoRA1)
-> BN1 -> ReLU -> FC2 -> (LoRA2) -> BN2 -> ReLU -> FC3 -> (LoRA3) ->
cross-entropy loss. Hidden width 96, LoRA rank 4, input/output 256/3 (Fan)
or 561/6 (HAR).

Parameters are the reference's nested dicts and lists, as tensors; forward
functions return the intermediate feature maps x^k (inputs of each FC
layer) that Skip-LoRA adapters tap and Skip-Cache stores. Random draws come
from a ``torch.Generator`` (the reference takes a key): same shapes and
scales, not the same numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map

Params = Any  # nested dicts / lists of tensors


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    hidden_dim: int
    out_dim: int
    n_layers: int = 3
    lora_rank: int = 4
    batchnorm: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def dims(self) -> tuple[int, ...]:
        """(d0, d1, ..., dn): layer k maps dims[k-1] -> dims[k]."""
        return (self.in_dim,) + (self.hidden_dim,) * (self.n_layers - 1) + (self.out_dim,)


def normal(generator: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Standard normal draws on the generator's device, placed on ``device``:
    a CPU generator gives the same numbers on the card as on the CPU."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device).to(device)


def init_mlp(generator: torch.Generator, cfg: MLPConfig, *, device="cuda") -> Params:
    """He-init FC stack + identity-init inference-mode batchnorm."""
    dims = cfg.dims
    fc = []
    for k in range(cfg.n_layers):
        n, m = dims[k], dims[k + 1]
        w = normal(generator, (n, m), cfg.dtype, device) * math.sqrt(2.0 / n)
        fc.append({"W": w, "b": torch.zeros((m,), dtype=cfg.dtype, device=device)})
    bn = []
    for k in range(cfg.n_layers - 1):
        m = dims[k + 1]
        bn.append({
            "gamma": torch.ones((m,), dtype=cfg.dtype, device=device),
            "beta": torch.zeros((m,), dtype=cfg.dtype, device=device),
            "mean": torch.zeros((m,), dtype=cfg.dtype, device=device),
            "var": torch.ones((m,), dtype=cfg.dtype, device=device),
        })
    return {"fc": fc, "bn": bn}


def bn_apply(bn: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode batch normalization (frozen running statistics)."""
    inv = torch.rsqrt(bn["var"] + eps)
    return (x - bn["mean"]) * inv * bn["gamma"] + bn["beta"]


def bn_update_stats(bn: Params, x: torch.Tensor, *, momentum: float = 0.9) -> Params:
    """Update running statistics from a batch (used only during pre-training).
    The variance is the population one (``jnp.var``)."""
    mean = torch.mean(x, dim=0)
    var = torch.var(x, dim=0, unbiased=False)
    return {
        "gamma": bn["gamma"],
        "beta": bn["beta"],
        "mean": momentum * bn["mean"] + (1 - momentum) * mean,
        "var": momentum * bn["var"] + (1 - momentum) * var,
    }


def bn_apply_batch(bn: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Training-mode BN using batch statistics (pre-training only)."""
    mean = torch.mean(x, dim=0)
    var = torch.var(x, dim=0, unbiased=False)
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * bn["gamma"] + bn["beta"]


def mlp_forward(
    params: Params,
    x: torch.Tensor,
    cfg: MLPConfig,
    *,
    train_bn: bool = False,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Forward pass. Returns (logits, xs) where xs[k] is the input feature
    map of FC layer k. ``xs`` has n_layers entries; the *base* last-layer
    output (pre-adapter, the paper's c_i^n) is the returned logits."""
    xs = []
    h = x
    n = cfg.n_layers
    for k in range(n):
        xs.append(h)
        h = h @ params["fc"][k]["W"] + params["fc"][k]["b"]
        if k < n - 1:
            if cfg.batchnorm:
                bn = params["bn"][k]
                h = bn_apply_batch(bn, h) if train_bn else bn_apply(bn, h)
            h = torch.relu(h)
    return h, xs


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None].long()))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))


def value_and_grad(loss_fn: Callable[[Params], torch.Tensor], tree: Params):
    """(loss, grads) of ``loss_fn(t)`` for the leaves of ``tree``, through
    ``torch.autograd.grad``; a leaf the loss does not use gets a zero
    gradient, as ``jax.grad`` gives it. Only these leaves require grad, so
    autograd records nothing that depends on other tensors alone."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
    it = iter(leaves)
    t = tree_map(lambda _: next(it), tree)
    with torch.enable_grad():
        loss = loss_fn(t)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), tree)


def pretrain_step(params: Params, xb: torch.Tensor, yb: torch.Tensor, cfg: MLPConfig, lr: float) -> Params:
    """One plain-SGD step of the whole backbone, BN statistics included
    (their loss gradient too, as ``jax.grad`` over the whole tree gives),
    then the BN running statistics refreshed from the batch through the
    *updated* params, in the reference's order. Returns new params."""
    _, grads = value_and_grad(lambda p: cross_entropy(mlp_forward(p, xb, cfg)[0], yb), params)
    p = tree_map(lambda a, g: a - lr * g, params, grads)
    h = xb
    for k in range(cfg.n_layers - 1):
        h = h @ p["fc"][k]["W"] + p["fc"][k]["b"]
        if cfg.batchnorm:
            p["bn"][k] = bn_update_stats(p["bn"][k], h)
            h = bn_apply(p["bn"][k], h)
        h = torch.relu(h)
    return p


def pretrain(
    generator: torch.Generator,
    cfg: MLPConfig,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    *,
    epochs: int,
    batch_size: int = 20,
    lr: float = 0.05,
) -> Params:
    """Plain SGD pre-training of the full backbone (paper step 1), on the
    data's device. Each epoch takes ``n // batch_size`` batches of a fresh
    permutation (the remainder is dropped, as in the reference)."""
    dev = x_train.device
    params = init_mlp(generator, cfg, device=dev)
    n = x_train.shape[0]
    steps_per_epoch = max(1, n // batch_size)
    for _ in range(epochs):
        perm = torch.randperm(n, generator=generator, device=generator.device).to(dev)
        for s in range(steps_per_epoch):
            idx = perm[s * batch_size : (s + 1) * batch_size]
            params = pretrain_step(params, x_train[idx], y_train[idx], cfg, lr)
    return params
