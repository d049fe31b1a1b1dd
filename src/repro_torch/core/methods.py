"""The eight fine-tuning methods of the paper (Sections 3-4), MLP scale.

Counterpart of ``repro.core.methods``. Each method is a (init, forward) pair
over an explicit trainable/frozen parameter split. Only the trainable leaves
require grad, so autograd records exactly the backward ops the paper's
Table-1 compute types prescribe (LoRA-Last's backward never touches an FC
weight; Skip-LoRA's backward never chains through the backbone).

Methods:
    ft_all       : all FC weights/biases + BN affine trainable
    ft_last      : last FC layer trainable
    ft_bias      : biases + BN affine trainable
    ft_all_lora  : ft_all + per-layer LoRA (paper's full-cost reference)
    lora_all     : per-layer LoRA adapters (backbone frozen)
    lora_last    : LoRA adapter on the last layer only
    skip_lora    : adapters from every layer's input to the LAST layer output
    skip2_lora   : skip_lora + Skip-Cache (cached forward variant)

The steps (``train_step``, ``cached_train_step``, the ``update`` of
``make_phase_fns``) update the trainable leaves in place and return them;
``init_method`` clones the backbone leaves it makes trainable, so the
backbone itself is never written.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch.models.mlp import MLPConfig, bn_apply, cross_entropy, normal, value_and_grad
from repro_torch.optim.optimizers import tree_leaves, tree_map

Params = Any

METHODS = (
    "ft_all",
    "ft_last",
    "ft_bias",
    "ft_all_lora",
    "lora_all",
    "lora_last",
    "skip_lora",
    "skip2_lora",
)


# ---------------------------------------------------------------------------
# Adapter initialisation
# ---------------------------------------------------------------------------


def init_lora(generator: torch.Generator, n: int, m: int, rank: int, dtype=torch.float32, *,
              device="cuda") -> Params:
    """Standard LoRA init: A ~ N(0, 1/n), B = 0 (adapter starts as identity)."""
    a = normal(generator, (n, rank), dtype, device) * math.sqrt(1.0 / n)
    return {"A": a, "B": torch.zeros((rank, m), dtype=dtype, device=device)}


def init_per_layer_loras(generator: torch.Generator, cfg: MLPConfig, *, device="cuda") -> list[Params]:
    """LoRA-All adapters: layer k gets (dims[k] -> dims[k+1])."""
    dims = cfg.dims
    return [init_lora(generator, dims[k], dims[k + 1], cfg.lora_rank, cfg.dtype, device=device)
            for k in range(cfg.n_layers)]


def init_skip_loras(generator: torch.Generator, cfg: MLPConfig, *, device="cuda") -> list[Params]:
    """Skip-LoRA adapters: layer k input -> LAST layer output (dims[k] -> dims[n])."""
    dims = cfg.dims
    n = cfg.n_layers
    return [init_lora(generator, dims[k], dims[n], cfg.lora_rank, cfg.dtype, device=device) for k in range(n)]


def lora_apply(lora: Params, x: torch.Tensor) -> torch.Tensor:
    """y_B = (x W_A) W_B  (Eqs. 7-8)."""
    return (x @ lora["A"]) @ lora["B"]


# ---------------------------------------------------------------------------
# Parameter partitioning per method
# ---------------------------------------------------------------------------


def init_method(
    generator: torch.Generator, cfg: MLPConfig, backbone: Params, method: str
) -> tuple[Params, Params]:
    """Split a pre-trained backbone into (trainable, frozen) for ``method``.

    The trees are disjoint; ``forward`` recombines them. Trainable backbone
    leaves are clones (the steps update them in place); frozen ones are the
    backbone's own tensors. BN running statistics are always frozen during
    fine-tuning (inference-mode BN), which is what makes activations
    sample-deterministic and hence cacheable. New adapters live on the
    backbone's device."""
    dev = backbone["fc"][0]["W"].device
    own = lambda t: tree_map(torch.clone, t)  # noqa: E731
    fc = backbone["fc"]
    bn = backbone["bn"]
    bn_affine = [{"gamma": b["gamma"], "beta": b["beta"]} for b in bn]
    bn_stats = [{"mean": b["mean"], "var": b["var"]} for b in bn]

    if method == "ft_all":
        trainable = {"fc": own(fc), "bn": own(bn_affine)}
        frozen = {"bn_stats": bn_stats}
    elif method == "ft_last":
        trainable = {"fc_last": own(fc[-1])}
        frozen = {"fc": fc[:-1], "bn": bn_affine, "bn_stats": bn_stats}
    elif method == "ft_bias":
        trainable = {"b": own([layer["b"] for layer in fc]), "bn": own(bn_affine)}
        frozen = {"W": [layer["W"] for layer in fc], "bn_stats": bn_stats}
    elif method == "ft_all_lora":
        trainable = {
            "fc": own(fc),
            "bn": own(bn_affine),
            "lora": init_per_layer_loras(generator, cfg, device=dev),
        }
        frozen = {"bn_stats": bn_stats}
    elif method == "lora_all":
        trainable = {"lora": init_per_layer_loras(generator, cfg, device=dev)}
        frozen = {"fc": fc, "bn": bn_affine, "bn_stats": bn_stats}
    elif method == "lora_last":
        dims = cfg.dims
        trainable = {"lora": init_lora(generator, dims[-2], dims[-1], cfg.lora_rank, cfg.dtype, device=dev)}
        frozen = {"fc": fc, "bn": bn_affine, "bn_stats": bn_stats}
    elif method in ("skip_lora", "skip2_lora"):
        trainable = {"lora": init_skip_loras(generator, cfg, device=dev)}
        frozen = {"fc": fc, "bn": bn_affine, "bn_stats": bn_stats}
    else:
        raise ValueError(f"unknown method {method!r}")
    return trainable, frozen


def _bn_act(h: torch.Tensor, affine: Params, stats: Params) -> torch.Tensor:
    merged = {**affine, **stats}
    return torch.relu(bn_apply(merged, h))


# ---------------------------------------------------------------------------
# Forward passes (full). Each returns (logits, xs) with xs[k] = input of FC k.
# ---------------------------------------------------------------------------


def forward(
    method: str, trainable: Params, frozen: Params, x: torch.Tensor, cfg: MLPConfig
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    n = cfg.n_layers
    xs: list[torch.Tensor] = []
    h = x

    if method == "ft_all":
        for k in range(n):
            xs.append(h)
            h = h @ trainable["fc"][k]["W"] + trainable["fc"][k]["b"]
            if k < n - 1:
                h = _bn_act(h, trainable["bn"][k], frozen["bn_stats"][k])
        return h, xs

    if method == "ft_last":
        for k in range(n - 1):
            xs.append(h)
            h = h @ frozen["fc"][k]["W"] + frozen["fc"][k]["b"]
            h = _bn_act(h, frozen["bn"][k], frozen["bn_stats"][k])
        xs.append(h)
        h = h @ trainable["fc_last"]["W"] + trainable["fc_last"]["b"]
        return h, xs

    if method == "ft_bias":
        for k in range(n):
            xs.append(h)
            h = h @ frozen["W"][k] + trainable["b"][k]
            if k < n - 1:
                h = _bn_act(h, trainable["bn"][k], frozen["bn_stats"][k])
        return h, xs

    if method == "ft_all_lora":
        for k in range(n):
            xs.append(h)
            h = h @ trainable["fc"][k]["W"] + trainable["fc"][k]["b"] + lora_apply(trainable["lora"][k], h)
            if k < n - 1:
                h = _bn_act(h, trainable["bn"][k], frozen["bn_stats"][k])
        return h, xs

    if method == "lora_all":
        for k in range(n):
            xs.append(h)
            h = h @ frozen["fc"][k]["W"] + frozen["fc"][k]["b"] + lora_apply(trainable["lora"][k], h)
            if k < n - 1:
                h = _bn_act(h, frozen["bn"][k], frozen["bn_stats"][k])
        return h, xs

    if method == "lora_last":
        for k in range(n):
            xs.append(h)
            y = h @ frozen["fc"][k]["W"] + frozen["fc"][k]["b"]
            if k == n - 1:
                y = y + lora_apply(trainable["lora"], h)
            else:
                y = _bn_act(y, frozen["bn"][k], frozen["bn_stats"][k])
            h = y
        return h, xs

    if method in ("skip_lora", "skip2_lora"):
        # Backbone forward is entirely frozen; adapters tap every x^k and add
        # into the LAST layer's output (Eq. 17).
        for k in range(n):
            xs.append(h)
            h = h @ frozen["fc"][k]["W"] + frozen["fc"][k]["b"]
            if k < n - 1:
                h = _bn_act(h, frozen["bn"][k], frozen["bn_stats"][k])
        skip = torch.zeros_like(h)
        for k in range(n):
            skip = skip + lora_apply(trainable["lora"][k], xs[k])
        return h + skip, xs

    raise ValueError(f"unknown method {method!r}")


def skip_forward_cached(
    trainable: Params, y_base: torch.Tensor, xs: list[torch.Tensor]
) -> torch.Tensor:
    """Skip2-LoRA cached forward (Section 4.2): y^n <- c^n + sum_k x^k A_k B_k.

    ``y_base`` is the cached frozen-backbone last-layer output c_i^n; ``xs``
    are the cached per-layer inputs. No backbone compute at all."""
    out = y_base
    for k, lora in enumerate(trainable["lora"]):
        out = out + lora_apply(lora, xs[k])
    return out


# ---------------------------------------------------------------------------
# Train steps (plain SGD, Eq. 5-6 / 15-16)
# ---------------------------------------------------------------------------


@torch.no_grad()
def sgd_(trainable: Params, grads: Params, lr: float) -> Params:
    """p <- p - lr * g, in place, leaf by leaf (the reference's ``_sgd``)."""
    for p, g in zip(tree_leaves(trainable), tree_leaves(grads)):
        p.sub_(lr * g)
    return trainable


def train_step(
    method: str,
    cfg: MLPConfig,
    trainable: Params,
    frozen: Params,
    xb: torch.Tensor,
    yb: torch.Tensor,
    lr: float,
) -> tuple[Params, torch.Tensor]:
    """One full-forward SGD step (all methods), in place on ``trainable``."""

    def loss_fn(t):
        logits, _ = forward(method, t, frozen, xb, cfg)
        return cross_entropy(logits, yb)

    loss, grads = value_and_grad(loss_fn, trainable)
    return sgd_(trainable, grads, lr), loss


def cached_train_step(
    trainable: Params,
    y_base: torch.Tensor,
    xs: list[torch.Tensor],
    yb: torch.Tensor,
    lr: float,
) -> tuple[Params, torch.Tensor]:
    """One Skip2-LoRA step from cached activations (zero backbone compute),
    in place on ``trainable``."""

    def loss_fn(t):
        return cross_entropy(skip_forward_cached(t, y_base, xs), yb)

    loss, grads = value_and_grad(loss_fn, trainable)
    return sgd_(trainable, grads, lr), loss


# Convenience: phase-split callables for the timing benchmarks (Table 6/7).


def make_phase_fns(method: str, cfg: MLPConfig) -> dict[str, Callable]:
    """Separate forward / backward / update callables, mirroring the
    paper's per-phase timing rows. ``update`` works in place."""

    @torch.no_grad()
    def fwd(trainable, frozen, xb):
        logits, _ = forward(method, trainable, frozen, xb, cfg)
        return logits

    def bwd(trainable, frozen, xb, yb):
        def loss_fn(t):
            logits, _ = forward(method, t, frozen, xb, cfg)
            return cross_entropy(logits, yb)

        return value_and_grad(loss_fn, trainable)[1]

    def upd(trainable, grads, lr):
        return sgd_(trainable, grads, lr)

    return {"forward": fwd, "backward": bwd, "update": upd}
