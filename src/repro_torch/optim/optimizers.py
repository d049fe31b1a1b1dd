"""Functional optimizers over dicts of tensors.

Counterpart of ``repro.optim.optimizers``, with the same API:
``opt = make_optimizer(...)``; ``state = opt.init(params)``;
``updates, state = opt.update(grads, state, params)``;
``params = apply_updates(params, updates)``. Params, grads and updates are
nested dicts (or lists) of tensors; moments are fp32 whatever the param
dtype, AdamW applies the bias correction, and

    u = -lr * m_hat / (sqrt(v_hat) + eps) - lr * wd * p

as the reference writes it (``torch.optim.AdamW`` orders its arithmetic
differently). Nothing is updated in place: each call returns new tensors.
The int8 moments are ``optim.quantized.int8_adamw``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

Params = Any


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Optional[Params]], tuple[Params, Any]]


@dataclasses.dataclass
class OptState:
    step: torch.Tensor            # () int32
    mu: Params | None = None
    nu: Params | None = None


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf over nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _zeros_like_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)


def sgd(lr: float, *, momentum: float = 0.0) -> Optimizer:
    def init(params):
        mu = tree_map(_zeros_like_f32, params) if momentum else None
        return OptState(step=_step0(params), mu=mu)

    def update(grads, state, params=None):
        del params
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.float(), state.mu, grads)
            return tree_map(lambda m: -lr * m, mu), OptState(step=state.step + 1, mu=mu)
        updates = tree_map(lambda g: -lr * g.float(), grads)
        return updates, OptState(step=state.step + 1)

    return Optimizer(init, update)


def adamw(
    lr: float,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        return OptState(
            step=_step0(params),
            mu=tree_map(_zeros_like_f32, params),
            nu=tree_map(_zeros_like_f32, params),
        )

    def update(grads, state, params=None):
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state.nu, grads)
        # fp32 powers of a Python scalar base: no host read of the step count
        # and no copy to the device, so nothing waits for queued work.
        stepf = step.float()
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        def upd(m, v, p):
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr * weight_decay * p.float()
            return u

        if params is not None:
            updates = tree_map(upd, mu, nu, params)
        else:
            updates = tree_map(lambda m, v: upd(m, v, None), mu, nu)
        return updates, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adam":
        return adamw(lr, weight_decay=0.0, **kw)
    raise ValueError(name)


def apply_updates(params: Params, updates: Params) -> Params:
    """p + u in fp32, back to the param's dtype."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def global_norm(tree: Params) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)
