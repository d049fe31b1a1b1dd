"""Plain PyTorch reference of Skip2-LoRA's cached fine-tuning step.

A tenant's adapters are one (A_l, B_l) pair per layer. Its cached rows hold
every block input (acts, L x S x D) and the last block's output (y_base)
of the frozen backbone, which the reference works out again with its own
float32 forward (``decoder.forward``). A step over rows r:

    h = y_base[r] + sum_l acts_l[r] A_l B_l
    loss = mean over labelled positions of cross entropy(final_norm(h) H^T, label)

then AdamW (Loshchilov and Hutter: bias-corrected moments, eps outside the
square root, decoupled weight decay) on A and B. Initial adapters: A drawn
N(0, 1/D) from the generator the benchmark hands the program, B zero; a
later call starts from the state (adapters, moments, step) the program
held before it. The
rows of each step follow the benchmark's statement of the epoch plan: the
tenant's own permutation stream ``numpy.random.default_rng(((seed +
partition) << 10) ^ epoch).permutation(n)``, cut into batches of ``bpt``
rows, the last batch wrapping to the front.

Imports torch, numpy and this folder's decoder only.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import decoder as D


def plan(seed: int, partition: int, epoch: int, n_rows: int, bpt: int) -> np.ndarray:
    """(steps, bpt) local row ids of one tenant's epoch."""
    perm = np.random.default_rng(((seed + partition) << 10) ^ epoch).permutation(n_rows)
    bs = min(bpt, n_rows)
    steps = -(-n_rows // bs)
    pad = steps * bs - n_rows
    return (np.concatenate([perm, perm[:pad]]) if pad else perm).reshape(steps, bs)


def initial_a(generator: torch.Generator, n_layers: int, d: int, rank: int, n_draws: int) -> list[torch.Tensor]:
    """The first ``n_draws`` initial A stacks (L, D, R) drawn from
    ``generator``, in order."""
    return [torch.randn((n_layers, d, rank), generator=generator, device=generator.device) / math.sqrt(d)
            for _ in range(n_draws)]


def cached_rows(weights: dict, cfg: dict, tokens: torch.Tensor, *, chunk: int = 16,
                precision: str = "fp32") -> tuple[torch.Tensor, torch.Tensor]:
    """The frozen backbone's acts (L, N, S, D) and y_base (N, S, D) of
    ``tokens`` (N, S), ``chunk`` rows a forward."""
    acts, ys = [], []
    for lo in range(0, tokens.shape[0], chunk):
        out = D.forward(weights, cfg, [tokens[lo:lo + chunk]], keep_acts=True, precision=precision)
        acts.append(out["acts"][0])
        ys.append(out["y_base"][0])
    return torch.cat(acts, dim=1), torch.cat(ys, dim=0)


def loss_fn(weights: dict, cfg: dict, acts, y_base, labels, a, b, precision: str) -> torch.Tensor:
    skip = torch.zeros_like(y_base)
    for layer in range(acts.shape[0]):
        skip = skip + D.mm(D.mm(acts[layer], a[layer], precision), b[layer], precision)
    logits = D.logits(weights, cfg, y_base + skip, precision)
    mask = labels >= 0
    ce = F.cross_entropy(logits[mask], labels[mask].long(), reduction="sum")
    return ce / mask.sum().clamp(min=1)


def follow(weights: dict, cfg: dict, acts, y_base, labels, start: dict, steps: np.ndarray, opt: dict, *,
           precision: str = "fp32") -> dict:
    """Train one tenant over ``steps`` (each row the local rows of one
    step) from ``start``: {"A", "step"} and, for a tenant trained before,
    "B", "mu" and "nu" (else B and the moments start at zero). Returns
    {"losses": (steps,), "A", "B", "mu": {"A", "B"}, "nu": {"A", "B"},
    "B0"} after the last step."""
    a0 = start["A"]
    b0 = start.get("B")
    if b0 is None:
        b0 = torch.zeros((a0.shape[0], a0.shape[2], a0.shape[1]), dtype=torch.float32, device=a0.device)
    p = {"A": a0.clone().float(), "B": b0.clone().float()}
    mu = {k: (start["mu"][k].clone().float() if "mu" in start else torch.zeros_like(v)) for k, v in p.items()}
    nu = {k: (start["nu"][k].clone().float() if "nu" in start else torch.zeros_like(v)) for k, v in p.items()}
    b1, b2, eps, lr, wd = opt["b1"], opt["b2"], opt["eps"], opt["lr"], opt["weight_decay"]
    losses = []
    for t, rows in enumerate(steps, start=start["step"] + 1):
        r = torch.as_tensor(rows, device=a0.device)
        a, b = p["A"].requires_grad_(True), p["B"].requires_grad_(True)
        loss = loss_fn(weights, cfg, acts[:, r], y_base[r], labels[r], a, b, precision)
        ga, gb = torch.autograd.grad(loss, (a, b))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in (("A", ga), ("B", gb)):
                mu[k] = b1 * mu[k] + (1 - b1) * g
                nu[k] = b2 * nu[k] + (1 - b2) * g.square()
                upd = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                p[k] = p[k].detach() - lr * upd - lr * wd * p[k].detach()
    return {"losses": np.asarray(losses), "A": p["A"].detach(), "B": p["B"].detach(), "mu": mu, "nu": nu,
            "B0": b0}
