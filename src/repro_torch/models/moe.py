"""Mixture-of-Experts FFN: top-k routing with grouped, capacity-bounded
dispatch (GShard-style).

Counterpart of ``repro.models.moe``. Tokens are routed *within groups* (the
leading dims, the batch rows), so a row's routing never depends on the
other rows. Per group: route -> each (token, k) assignment's position in
its expert by an exclusive cumsum over the S*K assignments -> (G, E, C, D)
expert buffers (C = the per-group capacity) -> gated expert products ->
gate-weighted combine back. An assignment at position >= C drops. Shared
(always-on) experts (qwen2-moe) and a Switch-style aux loss.

Every one of the E*C slots of a group is formed, kept or empty, so the
shapes do not depend on the routing: a step captures into a CUDA graph.
The reference scatters dropped assignments to the out-of-range slot E*C
with ``mode="drop"``; here they go to a dump row E*C that is sliced away.
The reference scatter-adds each slot's output back to its token; here each
assignment gathers its slot's output (the dump row reads zeros) and a
token sums its K in order, so the combine is deterministic on the card,
where a scatter-add's atomics are not. The expert products are plain
``einsum``s, as in the reference, where no Pallas kernel runs them.

``moe_ffn`` is ``dispatch`` -> ``expert_outputs`` -> ``combine`` (+ the
shared FFN) and ``aux_loss``; a model group's members (``models.tp``) run
the last two over their own experts' slots from one dispatch.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.models.ffn import _normal, ffn, init_ffn
from repro_torch.models.layers import activation

Params = Any


def init_moe(generator: torch.Generator, d: int, mcfg: MoEConfig, dtype) -> Params:
    """Router (D, E) fp32, experts ``w_gate``/``w_up`` (E, D, F) and
    ``w_down`` (E, F, D) in ``dtype``, and the shared gated FFN if any."""
    e, f = mcfg.n_experts, mcfg.d_ff_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    params = {
        "router": _normal(generator, (d, e), s_in, torch.float32),
        "w_gate": _normal(generator, (e, d, f), s_in, dtype),
        "w_up": _normal(generator, (e, d, f), s_in, dtype),
        "w_down": _normal(generator, (e, f, d), s_out, dtype),
    }
    if mcfg.n_shared:
        params["shared"] = init_ffn(generator, d, mcfg.shared_d_ff, gated=True, dtype=dtype)
    return params


def _capacity(tokens_per_group: int, mcfg: MoEConfig) -> int:
    cap = int(mcfg.top_k * tokens_per_group * mcfg.capacity_factor / mcfg.n_experts)
    return max(cap, mcfg.top_k)


def route(router_w: torch.Tensor, x: torch.Tensor, mcfg: MoEConfig):
    """x: (G, S, D). Returns (gates (G,S,K) fp32 renormalised, expert_idx
    (G,S,K), probs (G,S,E) fp32): fp32 logits, softmax, top-k."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    gates, expert_idx = torch.topk(probs, mcfg.top_k, dim=-1)
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True), min=1e-9)
    return gates, expert_idx, probs


def dispatch(router_w: torch.Tensor, xg: torch.Tensor, mcfg: MoEConfig) -> dict[str, torch.Tensor]:
    """Route ``xg`` (G, S, D) and place each (token, k) assignment: its
    ``slot`` (G, S*K) in the E*C expert slots (a drop: E*C, the dump row),
    ``keep``, each slot's token and whether it is filled (``slot_token``,
    ``slot_valid``: (G, E*C)), the ``gates``, ``expert_idx`` and ``probs``
    of ``route``, and the capacity ``c``."""
    g_dim, s, _ = xg.shape
    e, k = mcfg.n_experts, mcfg.top_k
    c = _capacity(s, mcfg)
    gates, expert_idx, probs = route(router_w, xg, mcfg)

    # Position of each (token, k) assignment within its expert, per group.
    flat_e = expert_idx.reshape(g_dim, s * k)                      # (G, S*K)
    onehot = F.one_hot(flat_e, e)                                  # (G, S*K, E)
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(2, flat_e[..., None])[..., 0]
    keep = pos < c
    slot = torch.where(keep, flat_e * c + pos, e * c)              # (G, S*K); E*C: the dump row

    # Each kept slot's token; kept slots are distinct, drops all land on the dump row.
    token_ids = (torch.arange(s * k, device=xg.device) // k).expand(g_dim, s * k)
    slot_token = torch.zeros((g_dim, e * c + 1), dtype=torch.long, device=xg.device)
    slot_token.scatter_(1, slot, token_ids)
    slot_valid = torch.zeros((g_dim, e * c + 1), dtype=torch.bool, device=xg.device)
    slot_valid.scatter_(1, slot, True)
    return {"gates": gates, "expert_idx": expert_idx, "probs": probs, "slot": slot, "keep": keep,
            "slot_token": slot_token[:, : e * c], "slot_valid": slot_valid[:, : e * c], "c": c}


def expert_outputs(params: Params, xg: torch.Tensor, slot_token: torch.Tensor, slot_valid: torch.Tensor,
                   c: int, *, act: str) -> torch.Tensor:
    """The slots' expert products: ``slot_token`` / ``slot_valid`` (G,
    n*C) of the n experts ``params`` holds (its ``w_gate``/``w_up`` (n, D,
    F), ``w_down`` (n, F, D)) -> (G, n*C, D), an empty slot a zero input."""
    g_dim, d, dtype = xg.shape[0], xg.shape[-1], xg.dtype
    n = params["w_gate"].shape[0]
    xe = xg.gather(1, slot_token[..., None].expand(-1, -1, d))     # (G, n*C, D)
    xe = (xe * slot_valid[..., None].to(dtype)).reshape(g_dim, n, c, d)
    g_act = activation(act, torch.einsum("gecd,edf->gecf", xe, params["w_gate"].to(dtype)))
    u = torch.einsum("gecd,edf->gecf", xe, params["w_up"].to(dtype))
    ye = torch.einsum("gecf,efd->gecd", g_act * u, params["w_down"].to(dtype))
    return ye.reshape(g_dim, n * c, d)


def combine(ye: torch.Tensor, disp: dict[str, torch.Tensor], lo: int = 0) -> torch.Tensor:
    """Every assignment reads its slot's output, gate-weighted, and a token
    sums its K -> (G, S, D). ``ye`` (G, n, D) holds slots ``[lo, lo + n)``:
    an assignment outside them (a drop, or another member's expert) reads
    the zero dump row."""
    g_dim, n, d = ye.shape
    slot, keep, gates = disp["slot"], disp["keep"], disp["gates"]
    s, k = gates.shape[1], gates.shape[2]
    if lo or n != disp["slot_token"].shape[1]:
        slot = torch.where((slot >= lo) & (slot < lo + n), slot - lo, n)
    ye = torch.cat([ye, ye.new_zeros((g_dim, 1, d))], dim=1)
    picked = ye.gather(1, slot[..., None].expand(-1, -1, d))      # (G, S*K, D)
    w = (gates.reshape(g_dim, s * k) * keep.to(gates.dtype))[..., None].to(ye.dtype)
    return torch.sum((picked * w).reshape(g_dim, s, k, d), dim=2)


def aux_loss(disp: dict[str, torch.Tensor], mcfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (fp32 scalar)."""
    e = mcfg.n_experts
    frac_tokens = torch.mean(F.one_hot(disp["expert_idx"], e).float().sum(dim=2), dim=(0, 1))
    frac_probs = torch.mean(disp["probs"], dim=(0, 1))
    return mcfg.router_aux_weight * e * torch.sum(frac_tokens * frac_probs)


def moe_ffn(params: Params, x: torch.Tensor, mcfg: MoEConfig, *, act: str = "silu"):
    """Apply the MoE FFN. x: (..., S, D) with leading group dims. Returns
    (y, aux_loss fp32 scalar)."""
    orig_shape = x.shape
    s, d = x.shape[-2], x.shape[-1]
    xg = x.reshape(-1, s, d)                                       # (G, S, D)
    disp = dispatch(params["router"], xg, mcfg)
    ye = expert_outputs(params, xg, disp["slot_token"], disp["slot_valid"], disp["c"], act=act)
    y = combine(ye, disp)
    if mcfg.n_shared:
        y = y + ffn(params["shared"], xg, act=act, gated=True)
    return y.reshape(orig_shape), aux_loss(disp, mcfg)
