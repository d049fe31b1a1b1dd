"""Recurrent sequence blocks: Mamba (selective SSM), mLSTM and sLSTM (xLSTM).

Counterpart of ``repro.models.ssm``. Each block has two forms over the same
parameters:
  - ``*_seq``:  the full-sequence forward (training / prefill), which also
    returns the final recurrent state so serving can continue from it;
  - ``*_step``: a one-token update against an explicit state (decode).

The reference scans over time with ``lax.scan``; here each ``*_seq`` is a
Python loop over time, one small step of eager ops a position. States are
dicts of tensors with the reference's dtypes: the recurrent memories in
fp32, the conv window (and sLSTM's ``h``) in the cache dtype. The
functions return new states; ``blocks.block_forward`` copies them into the
serve cache in place, as the attention caches are updated.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import MambaConfig, ModelConfig, XLSTMConfig
from repro_torch.models.ffn import _normal

Params = Any


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C). Returns (y, new_state)
    where the state holds the last K-1 inputs for streaming decode."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                                 # (B, S+K-1, C)
    y = 0
    for i in range(k):
        y = y + xp[:, i : i + x.shape[1], :] * w[i][None, None, :].to(x.dtype)
    new_state = xp[:, xp.shape[1] - (k - 1) :, :]
    if state is not None:
        new_state = new_state.to(state.dtype)
    return y, new_state


# ---------------------------------------------------------------------------
# Mamba (selective state-space model, arXiv:2312.00752)
# ---------------------------------------------------------------------------


def init_mamba(generator: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    mc = cfg.mamba or MambaConfig()
    d, di, n = cfg.d_model, mc.d_inner(cfg.d_model), mc.d_state
    dt_rank = max(1, d // 16)
    dev = generator.device
    return {
        "in_proj": _normal(generator, (d, 2 * di), 1.0 / math.sqrt(d), dtype),
        "conv_w": _normal(generator, (mc.d_conv, di), 0.2, dtype),
        "x_proj": _normal(generator, (di, dt_rank + 2 * n), 1.0 / math.sqrt(di), dtype),
        "dt_proj": _normal(generator, (dt_rank, di), 1.0 / math.sqrt(dt_rank), dtype),
        "dt_bias": torch.zeros((di,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)).expand(di, n).clone(),
        "d_skip": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": _normal(generator, (di, d), 1.0 / math.sqrt(di), dtype),
    }


def init_mamba_state(batch: int, cfg: ModelConfig, dtype, *, device=None) -> Params:
    mc = cfg.mamba or MambaConfig()
    di = mc.d_inner(cfg.d_model)
    return {
        "ssm": torch.zeros((batch, di, mc.d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype, device=device),
    }


def _mamba_scan_inputs(params: Params, x: torch.Tensor, cfg: ModelConfig, conv_state):
    """Shared projections of the seq and step forms. x: (B,S,D)."""
    mc = cfg.mamba or MambaConfig()
    dtype = x.dtype
    di = mc.d_inner(cfg.d_model)
    xin, z = torch.chunk(x @ params["in_proj"].to(dtype), 2, dim=-1)
    xc, new_conv = _causal_conv1d(xin, params["conv_w"], conv_state)
    xc = F.silu(xc)
    proj = xc @ params["x_proj"].to(dtype)
    dt_rank = params["dt_proj"].shape[0]
    dt_r, b, c = torch.split(proj, [dt_rank, mc.d_state, proj.shape[-1] - dt_rank - mc.d_state], dim=-1)
    dt = F.softplus(dt_r @ params["dt_proj"].to(dtype) + params["dt_bias"].to(dtype))
    return xc, z, dt, b, c, new_conv, di


def mamba_seq(params: Params, x: torch.Tensor, cfg: ModelConfig, state: Optional[Params] = None):
    """Full-sequence selective scan. x: (B,S,D) -> (y, final state)."""
    mc = cfg.mamba or MambaConfig()
    conv_state = state["conv"] if state is not None else None
    xc, z, dt, b, c, new_conv, di = _mamba_scan_inputs(params, x, cfg, conv_state)
    a = -torch.exp(params["a_log"].float())                         # (Di, N) fp32
    h = state["ssm"] if state is not None else torch.zeros(
        (x.shape[0], di, mc.d_state), dtype=torch.float32, device=x.device)
    dt_f, b_f, c_f, xc_f = dt.float(), b.float(), c.float(), xc.float()
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dt_f[:, t, :, None] * a[None])               # (B,Di,N)
        dbx = dt_f[:, t, :, None] * b_f[:, t, None, :] * xc_f[:, t, :, None]
        h = da * h + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, c_f[:, t]).to(x.dtype))
    y = torch.stack(ys, dim=1) + xc * params["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ params["out_proj"].to(x.dtype)
    return out, {"ssm": h, "conv": new_conv}


def mamba_step(params: Params, x: torch.Tensor, cfg: ModelConfig, state: Params):
    """Single-token decode. x: (B,1,D)."""
    return mamba_seq(params, x, cfg, state)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell, arXiv:2405.04517)
# ---------------------------------------------------------------------------


def init_mlstm(generator: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    xc = cfg.xlstm or XLSTMConfig()
    d = cfg.d_model
    di = int(d * xc.mlstm_proj_factor)
    h = cfg.n_heads
    hd = di // h
    s, si = 1.0 / math.sqrt(d), 1.0 / math.sqrt(di)
    return {
        "up_proj": _normal(generator, (d, 2 * di), s, dtype),
        "conv_w": _normal(generator, (xc.conv_kernel, di), 0.2, dtype),
        "wq": _normal(generator, (di, h, hd), si, dtype),
        "wk": _normal(generator, (di, h, hd), si, dtype),
        "wv": _normal(generator, (di, h, hd), si, dtype),
        "w_i": _normal(generator, (di, h), si, dtype),
        "w_f": _normal(generator, (di, h), si, dtype),
        "f_bias": torch.full((h,), 3.0, dtype=dtype, device=generator.device),
        "down_proj": _normal(generator, (di, d), si, dtype),
    }


def init_mlstm_state(batch: int, cfg: ModelConfig, dtype, *, device=None) -> Params:
    xc = cfg.xlstm or XLSTMConfig()
    di = int(cfg.d_model * xc.mlstm_proj_factor)
    h = cfg.n_heads
    hd = di // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, h, hd, hd), **f32),
        "n": torch.zeros((batch, h, hd), **f32),
        "m": torch.zeros((batch, h), **f32),
        "conv": torch.zeros((batch, xc.conv_kernel - 1, di), dtype=dtype, device=device),
    }


def _sqrt_in(n: int, dtype) -> float:
    """sqrt(n) rounded as the reference computes it, in ``dtype``."""
    return torch.sqrt(torch.tensor(float(n)).to(dtype).float()).to(dtype).item()


def mlstm_seq(params: Params, x: torch.Tensor, cfg: ModelConfig, state: Optional[Params] = None):
    """Full-sequence mLSTM with stabilised exponential gating."""
    xc_cfg = cfg.xlstm or XLSTMConfig()
    dtype = x.dtype
    b, s, d = x.shape
    di = int(d * xc_cfg.mlstm_proj_factor)
    nh = cfg.n_heads
    hd = di // nh

    a_in, z = torch.chunk(x @ params["up_proj"].to(dtype), 2, dim=-1)
    a_c, new_conv = _causal_conv1d(a_in, params["conv_w"], state["conv"] if state is not None else None)
    a_c = F.silu(a_c)

    q = torch.einsum("bsd,dnh->bsnh", a_c, params["wq"].to(dtype)).float()
    k = (torch.einsum("bsd,dnh->bsnh", a_c, params["wk"].to(dtype)) / _sqrt_in(hd, dtype)).float()
    v = torch.einsum("bsd,dnh->bsnh", a_in, params["wv"].to(dtype)).float()
    ig = (a_c @ params["w_i"].to(dtype)).float()                                   # (B,S,H)
    fg = (a_c @ params["w_f"].to(dtype)).float() + params["f_bias"].float()
    logf_all = F.logsigmoid(fg)

    if state is None:
        c = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        m = torch.zeros((b, nh), dtype=torch.float32, device=x.device)
    else:
        c, n, m = state["c"], state["n"], state["m"]

    hs = []
    for t in range(s):
        i_t, logf = ig[:, t], logf_all[:, t]                       # (B,H)
        m_new = torch.maximum(logf + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(logf + m - m_new)
        kf, vf, qf = k[:, t], v[:, t], q[:, t]                     # (B,H,hd)
        c = f_p[..., None, None] * c + i_p[..., None, None] * (kf[..., :, None] * vf[..., None, :])
        n = f_p[..., None] * n + i_p[..., None] * kf
        num = torch.einsum("bnhg,bnh->bng", c, qf)
        den = torch.clamp(torch.abs(torch.sum(n * qf, dim=-1)), min=1.0)
        hs.append((num / den[..., None]).to(dtype))
        m = m_new
    h = torch.stack(hs, dim=1).reshape(b, s, di)
    h = h * F.silu(z)
    out = h @ params["down_proj"].to(dtype)
    return out, {"c": c, "n": n, "m": m, "conv": new_conv}


def mlstm_step(params: Params, x: torch.Tensor, cfg: ModelConfig, state: Params):
    return mlstm_seq(params, x, cfg, state)


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory cell with recurrent block-diagonal weights)
# ---------------------------------------------------------------------------


def init_slstm(generator: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    xc = cfg.xlstm or XLSTMConfig()
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    dff = int(d * xc.slstm_ff_factor)
    bias = torch.zeros((4, d), dtype=torch.float32, device=generator.device)
    bias[1] = 3.0   # f-gate bias +3 for stability
    return {
        "w_in": _normal(generator, (d, 4, d), 1.0 / math.sqrt(d), dtype),
        "r": _normal(generator, (4, nh, hd, hd), 1.0 / math.sqrt(hd), dtype),
        "bias": bias.to(dtype),
        "ff_up": _normal(generator, (d, 2 * dff), 1.0 / math.sqrt(d), dtype),
        "ff_down": _normal(generator, (dff, d), 1.0 / math.sqrt(dff), dtype),
    }


def init_slstm_state(batch: int, cfg: ModelConfig, dtype, *, device=None) -> Params:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "h": torch.zeros((batch, d), dtype=dtype, device=device),
        "c": torch.zeros((batch, d), **f32),
        "n": torch.ones((batch, d), **f32),
        "m": torch.zeros((batch, d), **f32),
    }


def slstm_seq(params: Params, x: torch.Tensor, cfg: ModelConfig, state: Optional[Params] = None):
    dtype = x.dtype
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = d // nh

    gates_in = torch.einsum("bsd,dge->bsge", x, params["w_in"].to(dtype))        # (B,S,4,D)
    st = state if state is not None else init_slstm_state(b, cfg, dtype, device=x.device)
    r, bias = params["r"].to(dtype), params["bias"].to(dtype)[None]

    h, c, n, m = st["h"].to(dtype), st["c"].float(), st["n"].float(), st["m"].float()
    hs = []
    for t in range(s):
        rec = torch.einsum("bnh,gnhk->bgnk", h.reshape(b, nh, hd), r)
        g = (gates_in[:, t] + rec.reshape(b, 4, d) + bias).float()
        i_raw, f_raw, z_raw, o_raw = g.unbind(1)
        logf = F.logsigmoid(f_raw)
        m_new = torch.maximum(logf + m, i_raw)
        i_p = torch.exp(i_raw - m_new)
        f_p = torch.exp(logf + m - m_new)
        c = f_p * c + i_p * torch.tanh(z_raw)
        n = f_p * n + i_p
        h = (torch.sigmoid(o_raw) * c / torch.clamp(n, min=1e-6)).to(dtype)
        m = m_new
        hs.append(h)
    h_seq = torch.stack(hs, dim=1)                                                 # (B,S,D)

    # Gated FF (factor 4/3).
    ug, uu = torch.chunk(h_seq @ params["ff_up"].to(dtype), 2, dim=-1)
    out = (F.silu(ug) * uu) @ params["ff_down"].to(dtype)
    return out, {"h": h.to(st["h"].dtype), "c": c, "n": n, "m": m}


def slstm_step(params: Params, x: torch.Tensor, cfg: ModelConfig, state: Params):
    return slstm_seq(params, x, cfg, state)
