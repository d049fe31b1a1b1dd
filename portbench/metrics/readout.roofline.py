"""readout.roofline: the readout loss (``models/lm.py:lm_loss_rows``, forward
and backward to the hidden state) at the cell's step shape (rows per step
x seq positions), its device time from the profiler's trace (L2 flushed),
against its least time: two products of 2 M D V at the float32 peak (the
logits are float32)."""

import torch

from portbench import flops as FL
from portbench.harness import kernel_ms


def read(ctx):
    from repro_torch.models.lm import lm_loss_rows

    d = ctx.driver
    tr, job = d.tr, d.job
    rows = job["batch_per_tenant"] * (1 if job["new_tenant"] else tr["tenants"])
    seq, dm = tr["seq"], d.cfg["d_model"]
    g = torch.Generator(device="cuda").manual_seed(d.seed % (1 << 62))
    h = torch.randn((rows, seq, dm), generator=g, device="cuda").to(torch.bfloat16).requires_grad_(True)
    labels = torch.randint(0, d.cfg["vocab_size"], (rows, seq), generator=g, device="cuda")

    def step():
        ll, cnt = lm_loss_rows(d.weights, d.port_cfg, h, labels)
        (gh,) = torch.autograd.grad(-ll.sum() / cnt.sum(), h)
        return gh

    ms = kernel_ms(step, reps=10)
    if ms is None:
        return None
    ops = FL.readout_train_flops(d.cfg, rows * seq)
    nbytes = d.cfg["vocab_size"] * dm * 2 + 2 * rows * seq * dm * 2
    return FL.roofline_share(ops, nbytes, ms * 1e-3, FL.PEAK_FP32)
