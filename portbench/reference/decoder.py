"""Plain PyTorch reference of the decoder the configurations describe.

Float32 throughout, TF32 off, no kernels, no cache, no batching across
requests: the equations of a pre-norm decoder written out once. It imports
torch alone, and reads the weight tree the benchmark made (the same tensors
the program is handed), upcasting one layer at a time so that a model whose
float32 copy would not fit the card still runs.

Equations (each departure from the published model is the configuration's
``assumed.departures``):

- embed: h = E[token]
- block l: x = norm1(h); h += attn(x); z = norm2(h); h += ffn(z) or moe(z)
- attn: q, k, v = x Wq, x Wk, x Wv; rotary embedding on the first
  ``int(head_dim * rope_pct) // 2 * 2`` dims of q and k, rotate-half
  convention, angle = position * theta^(-2i / rot_dim); causal softmax of
  q k^T / sqrt(head_dim); output o Wo
- ffn: (act(z Wg) * (z Wu)) Wd
- moe: router logits z R (float32), softmax over experts, top-k, gates
  renormalised to sum 1; within a routing group an expert takes at most
  C = max(k, int(k * G * capacity_factor / E)) assignments in token order
  (k fastest), the rest drop; y = sum of kept gate * expert(z) + shared(z)
- skip (Skip2-LoRA): the sum over layers of block input l times A_l B_l,
  added to the last block's output before the final norm
- logits: final_norm(h) H^T

``precision="fp8"`` rounds both operands of every weight product (the
projections, the experts, the adapters' products and the readout) to
float8 e4m3 with one scale per row of the activations and per output
column of the weights, and multiplies in float32: the control that a
lower-precision path has to fail.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Float32 products in full float32: TF32 off for matmuls and cuDNN,
    restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax / 448), returned in float32. The gradient passes straight
    through in float32: the rounding is of the forward's operands."""
    scale = t.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., K) @ w (K, N), both float32; in "fp8" both rounded first."""
    if precision == "fp8":
        x, w = fp8_round(x, -1), fp8_round(w, 0)
    return x @ w


def norm(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    scale = p["scale"].float()
    if cfg["norm_type"] == "layernorm":
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + cfg["norm_eps"]) * scale + p["bias"].float()
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + cfg["norm_eps"]) * scale


def rope(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """x (B, S, H, hd) at positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    rot = int(hd * cfg["rope_pct"]) // 2 * 2
    if rot == 0:
        return x
    freqs = 1.0 / cfg["rope_theta"] ** (torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : rot // 2], x[..., rot // 2: rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]], dim=-1)


def act(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg["ffn_activation"] == "silu":
        return F.silu(x)
    if cfg["ffn_activation"] == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(cfg["ffn_activation"])


def attention(cfg: dict, p: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """Causal self-attention of sequences x (B, S, D), each from position 0."""
    b, s, d = x.shape
    h, kvh = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    q = mm(x, p["wq"].float().reshape(d, h * hd), precision).reshape(b, s, h, hd)
    k = mm(x, p["wk"].float().reshape(d, kvh * hd), precision).reshape(b, s, kvh, hd)
    v = mm(x, p["wv"].float().reshape(d, kvh * hd), precision).reshape(b, s, kvh, hd)
    q, k = rope(q, cfg), rope(k, cfg)
    rep = h // kvh
    k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, h * hd)
    return mm(o, p["wo"].float().reshape(h * hd, d), precision)


def swiglu(cfg: dict, wg, wu, wd, z: torch.Tensor, precision: str) -> torch.Tensor:
    if cfg["ffn_gated"]:
        hid = act(cfg, mm(z, wg.float(), precision)) * mm(z, wu.float(), precision)
    else:
        hid = act(cfg, mm(z, wu.float(), precision))
    return mm(hid, wd.float(), precision)


def capacity(moe: dict, width: int) -> int:
    return max(moe["top_k"], int(moe["top_k"] * width * moe["capacity_factor"] / moe["n_experts"]))


def moe_ffn(cfg: dict, p: dict, z: torch.Tensor, groups: Sequence[tuple[int, int, int]], precision: str):
    """z (S, D) of one sequence; ``groups`` its routing groups as (start,
    end, width) position ranges, ``width`` the group's length in the
    forward that routed it (a padded admission row is wider than its real
    tokens)."""
    moe = cfg["moe"]
    e, k = moe["n_experts"], moe["top_k"]
    probs = torch.softmax(z @ p["router"].float(), dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    keep = torch.zeros_like(gates, dtype=torch.bool)
    for start, end, width in groups:
        flat = experts[start:end].reshape(-1)
        onehot = F.one_hot(flat, e)
        pos = (onehot.cumsum(dim=0) - onehot).gather(1, flat[:, None])[:, 0]
        keep[start:end] = (pos < capacity(moe, width)).reshape(end - start, k)
    y = torch.zeros_like(z)
    w = gates * keep
    for ex in torch.unique(experts[keep]).tolist():
        tok, slot = torch.nonzero((experts == ex) & keep, as_tuple=True)
        out = swiglu(cfg, p["w_gate"][ex], p["w_up"][ex], p["w_down"][ex], z[tok], precision)
        y.index_add_(0, tok, out * w[tok, slot][:, None])
    if moe.get("n_shared"):
        sh = p["shared"]
        y = y + swiglu(cfg, sh["w_gate"], sh["w_up"], sh["w_down"], z, precision)
    return y


def forward(
    weights: dict,
    cfg: dict,
    seqs: Sequence[torch.Tensor],
    *,
    adapters: Optional[Sequence[Optional[tuple[torch.Tensor, torch.Tensor]]]] = None,
    groups: Optional[Sequence[Sequence[tuple[int, int, int]]]] = None,
    keep_acts: bool = False,
    precision: str = "fp32",
) -> dict:
    """The decoder over each batch of ``seqs`` ((B_i, S_i) token ids, rows
    of one length), layer by layer, so that each layer's weights are
    upcast once for every batch. ``adapters[i]``: batch i's (A (L, D, R),
    B (L, R, D)) or None; ``groups[i]``: the MoE routing groups of each of
    its rows (default: one group of the row's own length). Returns {"h":
    [(B_i, S_i, D)] last block outputs plus the skip term, "y_base": the
    same without it, "acts": [(L, B_i, S_i, D)] block inputs if
    ``keep_acts``}."""
    hs = [weights["embed"]["table"][t].float() for t in seqs]
    skips = [torch.zeros_like(h) for h in hs]
    acts = [[] for _ in seqs] if keep_acts else None
    for layer in range(cfg["n_layers"]):
        p = weights["stack"][layer]
        for i, h in enumerate(hs):
            if keep_acts:
                acts[i].append(h)
            if adapters is not None and adapters[i] is not None:
                a, b = adapters[i]
                skips[i] = skips[i] + mm(mm(h, a[layer].float(), precision), b[layer].float(), precision)
            h = h + attention(cfg, p["attn"], norm(cfg, p["norm1"], h), precision)
            zz = norm(cfg, p["norm2"], h)
            if "moe" in p:
                g = groups[i] if groups is not None else [(0, h.shape[1], h.shape[1])]
                h = h + torch.stack([moe_ffn(cfg, p["moe"], row, g, precision) for row in zz])
            else:
                f = p["ffn"]
                h = h + swiglu(cfg, f.get("w_gate"), f["w_up"], f["w_down"], zz, precision)
            hs[i] = h
    return {"h": [h + s for h, s in zip(hs, skips)], "y_base": hs,
            "acts": [torch.stack(a) for a in acts] if keep_acts else None}


def logits(weights: dict, cfg: dict, h: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """(..., D) last hidden -> (..., V) float32 logits."""
    hn = norm(cfg, weights["final_norm"], h)
    table = weights["embed" if cfg["tie_embeddings"] else "head"]["table"]
    return mm(hn, table.float().T, precision)
