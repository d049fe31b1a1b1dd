"""The numbers that decide ``correct``, worked out from the program's
outputs and the plain reference's, and their limits.

Training (each adapt call that the reference follows, for each sampled
tenant): ``loss_gap``, the widest relative gap of a step's loss;
``grad_gap``, the widest gap between the program's and the reference's
norms of the optimizer's first moment after the call (the gradient as the
optimizer holds it); ``change_gap``, the same of the adapters' change over
the call. A leaf is one layer's A or B of one tenant; a gap of norms is
taken against the reference leaf's norm or the median leaf's, whichever is
larger. Leaves whose reference moment is under a thousandth of the median
leaf's are left out: they move by rounding alone.

Serving (a sample of finished requests): ``logit_gap``, the widest amount
by which a served token's reference logit lies below the reference's best
at that position, and ``mean_gap``, the mean of that amount over every
served token of the sample.
"""

from __future__ import annotations

import numpy as np
import torch

#: a leaf whose reference moment norm is under this share of the median
#: leaf's moves by rounding alone and is not compared
NOUGHT = 1e-3


def _leaf_norms(tree: dict, n_layers: int) -> dict:
    return {(k, layer): float(tree[k][layer].double().norm()) for k in ("A", "B") for layer in range(n_layers)}


def _worst_gap(prog: dict, ref: dict, keys) -> float:
    med = float(np.median([ref[k] for k in keys])) if keys else 0.0
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys), default=0.0)


def train_readings(prog: dict, ref: dict) -> dict:
    """``prog[call][t]``: {"losses", "A", "B", "mu"} of the program's call
    for tenant t; ``ref[call][t]``: the reference's, with "A0" and "B0" its
    start. Each number is the worst over every call and tenant; each
    call's own are kept under its name (not compared)."""
    out = {}
    for call, tenants in ref.items():
        loss_gap, grad_gap, change_gap = 0.0, 0.0, 0.0
        for t, r in tenants.items():
            p = prog[call][t]
            lp, lr = np.asarray(p["losses"], np.float64), np.asarray(r["losses"], np.float64)
            loss_gap = max(loss_gap, float(np.max(np.abs(lp - lr) / np.abs(lr))))
            n_layers = r["A"].shape[0]
            g_ref, g_prog = _leaf_norms(r["mu"], n_layers), _leaf_norms(p["mu"], n_layers)
            start = {"A": r["A0"], "B": r["B0"]}
            c_ref = _leaf_norms({k: r[k] - start[k] for k in ("A", "B")}, n_layers)
            c_prog = _leaf_norms({k: p[k] - start[k] for k in ("A", "B")}, n_layers)
            med = float(np.median(list(g_ref.values())))
            keys = [k for k, v in g_ref.items() if v >= NOUGHT * med]
            grad_gap = max(grad_gap, _worst_gap(g_prog, g_ref, keys))
            change_gap = max(change_gap, _worst_gap(c_prog, c_ref, keys))
        out[call] = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
    worst = {k: max(c[k] for c in out.values()) for k in ("loss_gap", "grad_gap", "change_gap")}
    return {**worst, **out}


def token_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each of ``tokens`` (n,) lies below the best of the reference's
    logits (n, V) at the position that produced it."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, tokens[:, None].long())[:, 0]


def gap_readings(ref_logits: list, tokens: list) -> dict:
    """The widest and the mean gap over every token of every request, and
    (not compared) the quantiles and the share of tokens off the
    reference's best."""
    g = torch.cat([token_gaps(r, t) for r, t in zip(ref_logits, tokens)]).double().cpu()
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64))
    return {"logit_gap": float(g.max()), "mean_gap": float(g.mean()), "p50": float(q[0]), "p90": float(q[1]),
            "p99": float(q[2]), "off_best": float((g > 0).double().mean()), "tokens": int(g.numel())}


def judge(readings: dict, limits: dict) -> list[dict]:
    """Each reading beside its limit, in the order of ``limits``."""
    return [{"name": k, "value": readings[k], "limit": v["limit"]} for k, v in limits.items()]


def passed(checks: list[dict]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)
