"""The model's weights, made on the device from the seed.

One ``torch.randn`` per kind of tensor, stacked over the layers, in the
type the model is served in, then handed out as per-layer views in the
program's parameter layout ({"embed", "stack": [per layer], "final_norm",
"head"}). The plain reference reads the same tree. Scales: projections
N(0, 1/fan_in), embedding and head N(0, 0.02^2), norm scales 1 + N(0,
0.02^2), layernorm biases N(0, 0.02^2), the router float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sub_seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 32-bit seeds drawn from ``seed``."""
    return [int(x) for x in np.random.SeedSequence(seed).generate_state(n, dtype=np.uint32)]


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _normal(g: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device, dtype=dtype).mul_(std)


def make(cfg: dict, seed: int, device) -> dict:
    """The weight tree of configuration ``cfg`` from ``seed`` on ``device``."""
    g = generator(device, seed)
    dt = DTYPES[cfg["dtype"]]
    n, d, h, kvh = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    layernorm = cfg["norm_type"] == "layernorm"
    tree: dict = {"embed": {"table": _normal(g, (cfg["vocab_size"], d), 0.02, dt)}}
    wq = _normal(g, (n, d, h, hd), 1 / math.sqrt(d), dt)
    wk = _normal(g, (n, d, kvh, hd), 1 / math.sqrt(d), dt)
    wv = _normal(g, (n, d, kvh, hd), 1 / math.sqrt(d), dt)
    wo = _normal(g, (n, h, hd, d), 1 / math.sqrt(h * hd), dt)
    scales = _normal(g, (n + 1, 2, d), 0.02, torch.float32).add_(1.0)
    biases = _normal(g, (n + 1, 2, d), 0.02, torch.float32) if layernorm else None
    moe = cfg.get("moe")
    if moe:
        e, fe, fs = moe["n_experts"], moe["d_ff_expert"], moe.get("shared_d_ff", 0)
        router = _normal(g, (n, d, e), 1 / math.sqrt(d), torch.float32)
        eg = _normal(g, (n, e, d, fe), 1 / math.sqrt(d), dt)
        eu = _normal(g, (n, e, d, fe), 1 / math.sqrt(d), dt)
        ed = _normal(g, (n, e, fe, d), 1 / math.sqrt(fe), dt)
        if fs:
            sg = _normal(g, (n, d, fs), 1 / math.sqrt(d), dt)
            su = _normal(g, (n, d, fs), 1 / math.sqrt(d), dt)
            sd = _normal(g, (n, fs, d), 1 / math.sqrt(fs), dt)
    else:
        f = cfg["d_ff"]
        fg = _normal(g, (n, d, f), 1 / math.sqrt(d), dt) if cfg["ffn_gated"] else None
        fu = _normal(g, (n, d, f), 1 / math.sqrt(d), dt)
        fd = _normal(g, (n, f, d), 1 / math.sqrt(f), dt)

    def norm_p(i: int, j: int) -> dict:
        p = {"scale": scales[i, j]}
        if layernorm:
            p["bias"] = biases[i, j]
        return p

    stack = []
    for i in range(n):
        layer = {"norm1": norm_p(i, 0), "attn": {"wq": wq[i], "wk": wk[i], "wv": wv[i], "wo": wo[i]},
                 "norm2": norm_p(i, 1)}
        if moe:
            layer["moe"] = {"router": router[i], "w_gate": eg[i], "w_up": eu[i], "w_down": ed[i]}
            if fs:
                layer["moe"]["shared"] = {"w_gate": sg[i], "w_up": su[i], "w_down": sd[i]}
        else:
            layer["ffn"] = {"w_up": fu[i], "w_down": fd[i]}
            if fg is not None:
                layer["ffn"]["w_gate"] = fg[i]
        stack.append(layer)
    tree["stack"] = stack
    tree["final_norm"] = norm_p(n, 0)
    if not cfg["tie_embeddings"]:
        tree["head"] = {"table": _normal(g, (cfg["vocab_size"], d), 0.02, dt)}
    return tree


def port_config(cfg: dict):
    """The program's ``ModelConfig`` of configuration ``cfg``."""
    from repro_torch.models.config import ModelConfig, MoEConfig

    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size", "rope_pct",
            "rope_theta", "ffn_activation", "ffn_gated", "norm_type", "norm_eps", "tie_embeddings", "dtype")
    moe = cfg.get("moe")
    return ModelConfig(name=cfg["name"], family="moe" if moe else "dense", pattern=("attn",),
                       moe=MoEConfig(**moe) if moe else None, **{k: cfg[k] for k in keys})
