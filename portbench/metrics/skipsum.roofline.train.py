"""skipsum.roofline.train: the grouped skip sum forward (K5) and backward
(K9) as the cached fleet step calls it (``kernels/skip_lora/ops.py:
skip_lora_grouped_train`` over bf16 acts (L, rows, seq, D) and the
tenants' float32 stacks), its device time from the profiler's trace (L2
flushed), against its least time: each input read once and each output
written once at the HBM bandwidth, or its operations at the bf16 peak."""

import torch

from portbench import flops as FL
from portbench.harness import kernel_ms


def read(ctx):
    from repro_torch.kernels.skip_lora.ops import skip_lora_grouped_train

    d = ctx.driver
    tr, job = d.tr, d.job
    n_t = 1 if job["new_tenant"] else tr["tenants"]
    bpt, seq, dm, nl, r = job["batch_per_tenant"], tr["seq"], d.cfg["d_model"], d.cfg["n_layers"], tr["rank"]
    g = torch.Generator(device="cuda").manual_seed(d.seed % (1 << 62))
    acts = torch.randn((nl, n_t * bpt, seq, dm), generator=g, device="cuda").to(torch.bfloat16)
    a = (torch.randn((n_t, nl, dm, r), generator=g, device="cuda") / dm**0.5).requires_grad_(True)
    b = (torch.randn((n_t, nl, r, dm), generator=g, device="cuda") * 0.02).requires_grad_(True)
    rt = torch.arange(n_t, dtype=torch.int32, device="cuda").repeat_interleave(bpt)
    gout = torch.randn((n_t * bpt, seq, dm), generator=g, device="cuda").to(torch.bfloat16)

    def step():
        out = skip_lora_grouped_train(acts, a, b, rt)
        return torch.autograd.grad(out, (a, b), gout)

    ms = kernel_ms(step)
    if ms is None:
        return None
    positions = n_t * bpt * seq
    return FL.roofline_share(FL.skipsum_train_ops(d.cfg, positions, r),
                             FL.skipsum_train_bytes(d.cfg, positions, n_t, r), ms * 1e-3, FL.PEAK_BF16)
