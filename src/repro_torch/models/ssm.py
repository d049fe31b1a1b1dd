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

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import MambaConfig, ModelConfig, XLSTMConfig
from repro_torch.models.ffn import _normal

Params = Any

#: ``sample_time_loops(k)`` (a dry-run's counter, ``launch.op_analysis.
#: count``) sets itself here: a time loop over more than ``k`` positions then
#: issues its first ``k`` steps only, and records its length.
_LOOP_SAMPLE: contextvars.ContextVar = contextvars.ContextVar("ssm_loop_sample", default=None)


@dataclasses.dataclass
class LoopSample:
    steps: int
    lengths: set = dataclasses.field(default_factory=set)   # of the loops cut short


@contextlib.contextmanager
def sample_time_loops(steps: int):
    """Inside, each time loop over ``s > steps`` positions issues steps
    ``0 .. steps - 1`` and ``stack_steps`` pads their outputs to ``s`` with
    zeros: every count is then affine in ``steps`` (a first step, ``steps -
    2`` middle ones, a last one), so two runs give the whole loop's."""
    sample = LoopSample(steps)
    token = _LOOP_SAMPLE.set(sample)
    try:
        yield sample
    finally:
        _LOOP_SAMPLE.reset(token)


def time_steps(s: int) -> range:
    """The steps of a recurrence over ``s`` positions: ``range(s)``, or its
    first ones inside ``sample_time_loops``."""
    sample = _LOOP_SAMPLE.get()
    if sample is None or s <= sample.steps:
        return range(s)
    sample.lengths.add(s)
    return range(sample.steps)


def stack_steps(outs: list, s: int) -> torch.Tensor:
    """A loop's per-step outputs stacked on dim 1, ``s`` of them: those of a
    sampled loop and zeros for the steps it did not issue (one ``cat``
    reads and writes what ``stack`` would)."""
    if len(outs) == s:
        return torch.stack(outs, dim=1)
    first = outs[0]
    pad = torch.zeros((first.shape[0], s - len(outs), *first.shape[1:]), dtype=first.dtype, device=first.device)
    return torch.cat([o.unsqueeze(1) for o in outs] + [pad], dim=1)


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


def mamba_conv(params: Params, xin: torch.Tensor, conv_state=None):
    """The causal conv and SiLU over (a slice of) d_inner: (xc, new conv
    window)."""
    xc, new_conv = _causal_conv1d(xin, params["conv_w"], conv_state)
    return F.silu(xc), new_conv


def mamba_split_proj(proj: torch.Tensor, dt_rank: int, d_state: int):
    """``xc @ x_proj`` -> (dt_low, B, C)."""
    return torch.split(proj, [dt_rank, d_state, proj.shape[-1] - dt_rank - d_state], dim=-1)


def mamba_dt(params: Params, dt_r: torch.Tensor) -> torch.Tensor:
    dtype = dt_r.dtype
    return F.softplus(dt_r @ params["dt_proj"].to(dtype) + params["dt_bias"].to(dtype))


def mamba_scan(params: Params, xc, z, dt, b, c, h=None):
    """The selective scan over time on (a slice of) d_inner, then the skip
    and the gate: (y (B,S,Di) in xc's dtype, final fp32 state (B,Di,N))."""
    a = -torch.exp(params["a_log"].float())                         # (Di, N) fp32
    if h is None:
        h = torch.zeros((xc.shape[0], xc.shape[2], a.shape[1]), dtype=torch.float32, device=xc.device)
    dt_f, b_f, c_f, xc_f = dt.float(), b.float(), c.float(), xc.float()
    ys = []
    for t in time_steps(xc.shape[1]):
        da = torch.exp(dt_f[:, t, :, None] * a[None])               # (B,Di,N)
        dbx = dt_f[:, t, :, None] * b_f[:, t, None, :] * xc_f[:, t, :, None]
        h = da * h + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, c_f[:, t]).to(xc.dtype))
    y = stack_steps(ys, xc.shape[1]) + xc * params["d_skip"].to(xc.dtype)
    return y * F.silu(z), h


def mamba_mix(params: Params, xin: torch.Tensor, z: torch.Tensor, cfg: ModelConfig, state: Optional[Params] = None):
    """The mixer after ``in_proj``: conv, projections, scan, gate and
    ``out_proj`` -> (out, final state)."""
    mc = cfg.mamba or MambaConfig()
    xc, new_conv = mamba_conv(params, xin, state["conv"] if state is not None else None)
    dt_r, b, c = mamba_split_proj(xc @ params["x_proj"].to(xc.dtype), params["dt_proj"].shape[0], mc.d_state)
    y, h = mamba_scan(params, xc, z, mamba_dt(params, dt_r), b, c, state["ssm"] if state is not None else None)
    return y @ params["out_proj"].to(xc.dtype), {"ssm": h, "conv": new_conv}


def mamba_seq(params: Params, x: torch.Tensor, cfg: ModelConfig, state: Optional[Params] = None):
    """Full-sequence selective scan. x: (B,S,D) -> (y, final state)."""
    xin, z = torch.chunk(x @ params["in_proj"].to(x.dtype), 2, dim=-1)
    return mamba_mix(params, xin, z, cfg, state)


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


def mlstm_conv(params: Params, a_in: torch.Tensor, conv_state=None):
    a_c, new_conv = _causal_conv1d(a_in, params["conv_w"], conv_state)
    return F.silu(a_c), new_conv


def mlstm_proj(params: Params, a_in: torch.Tensor, a_c: torch.Tensor):
    """The head projections and gate pre-activations of (a slice of)
    d_inner, in the model dtype: (q, k, v (B,S,H,hd), i, f (B,S,H)), k
    not yet scaled, f without its bias."""
    dtype = a_c.dtype
    q = torch.einsum("bsd,dnh->bsnh", a_c, params["wq"].to(dtype))
    k = torch.einsum("bsd,dnh->bsnh", a_c, params["wk"].to(dtype))
    v = torch.einsum("bsd,dnh->bsnh", a_in, params["wv"].to(dtype))
    return q, k, v, a_c @ params["w_i"].to(dtype), a_c @ params["w_f"].to(dtype)


def mlstm_gates(q, k, v, ig, fg, f_bias):
    """``mlstm_proj``'s sums -> fp32 (q, k / sqrt(hd), v, i, log f)."""
    dtype = q.dtype
    k = (k / _sqrt_in(q.shape[-1], dtype)).float()
    return q.float(), k, v.float(), ig.float(), F.logsigmoid(fg.float() + f_bias.float())


def mlstm_recur(q, k, v, ig, logf_all, c, n, m, dtype):
    """The stabilised recurrence over time for the heads given: (h
    (B,S,H,hd) in ``dtype``, c, n, m)."""
    hs = []
    for t in time_steps(q.shape[1]):
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
    return stack_steps(hs, q.shape[1]), c, n, m


def mlstm_zero_state(b: int, nh: int, hd: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    return torch.zeros((b, nh, hd, hd), **f32), torch.zeros((b, nh, hd), **f32), torch.zeros((b, nh), **f32)


def mlstm_mix(params: Params, a_in: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
              state: Optional[Params] = None):
    """The cell after ``up_proj``: conv, projections, recurrence, gate and
    ``down_proj`` -> (out, final state)."""
    dtype = a_in.dtype
    b, s, di = a_in.shape
    nh = cfg.n_heads
    a_c, new_conv = mlstm_conv(params, a_in, state["conv"] if state is not None else None)
    q, k, v, ig, logf_all = mlstm_gates(*mlstm_proj(params, a_in, a_c), params["f_bias"])
    c, n, m = mlstm_zero_state(b, nh, di // nh, a_in.device) if state is None else (state["c"], state["n"], state["m"])
    h, c, n, m = mlstm_recur(q, k, v, ig, logf_all, c, n, m, dtype)
    h = h.reshape(b, s, di) * F.silu(z)
    out = h @ params["down_proj"].to(dtype)
    return out, {"c": c, "n": n, "m": m, "conv": new_conv}


def mlstm_seq(params: Params, x: torch.Tensor, cfg: ModelConfig, state: Optional[Params] = None):
    """Full-sequence mLSTM with stabilised exponential gating."""
    a_in, z = torch.chunk(x @ params["up_proj"].to(x.dtype), 2, dim=-1)
    return mlstm_mix(params, a_in, z, cfg, state)


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
    for t in time_steps(s):
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
    h_seq = stack_steps(hs, s)                                                     # (B,S,D)

    # Gated FF (factor 4/3).
    ug, uu = torch.chunk(h_seq @ params["ff_up"].to(dtype), 2, dim=-1)
    out = (F.silu(ug) * uu) @ params["ff_down"].to(dtype)
    return out, {"h": h.to(st["h"].dtype), "c": c, "n": n, "m": m}


def slstm_step(params: Params, x: torch.Tensor, cfg: ModelConfig, state: Params):
    return slstm_seq(params, x, cfg, state)
