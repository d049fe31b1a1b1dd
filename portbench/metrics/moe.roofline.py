"""moe.roofline: one ``models/moe.py:moe_ffn`` call at the decode shape
(``max_batch`` rows of one token) over the first layer's experts, its
device time from the profiler's trace (L2 flushed), against its least
time: the router, the experts that the benchmark's own float32 routing
picks for those rows and the shared FFN read once, the rows read and
written once, at the HBM bandwidth (the products of the routed and shared
experts at the bf16 peak are far shorter)."""

import torch

from portbench import flops as FL
from portbench.harness import kernel_ms


def read(ctx):
    from repro_torch.models.moe import moe_ffn

    d = ctx.driver
    rows, dm = d.tr["scheduler"]["max_batch"], d.cfg["d_model"]
    p = d.weights["stack"][0]["moe"]
    g = torch.Generator(device="cuda").manual_seed(d.seed % (1 << 62))
    x = torch.randn((rows, 1, dm), generator=g, device="cuda").to(torch.bfloat16)
    probs = torch.softmax(x.float().reshape(rows, dm) @ p["router"].float(), dim=-1)
    hit = torch.unique(torch.topk(probs, d.cfg["moe"]["top_k"], dim=-1).indices).numel()
    ms = kernel_ms(lambda: moe_ffn(p, x, d.port_cfg.moe, act=d.cfg["ffn_activation"]))
    if ms is None:
        return None
    m = d.cfg["moe"]
    ops = 2 * rows * dm * (m["n_experts"] + m["top_k"] * 3 * m["d_ff_expert"] + 3 * m.get("shared_d_ff", 0))
    return FL.roofline_share(ops, FL.moe_bytes(d.cfg, rows, hit), ms * 1e-3, FL.PEAK_BF16)
