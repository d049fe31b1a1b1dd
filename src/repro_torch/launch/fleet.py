"""Fleet fine-tuning launcher, the counterpart of ``repro.launch.fleet``.

  python -m repro_torch.launch.fleet --arch stablelm-1.6b --full \
      --tenants 4 --samples 16 --batch-per-tenant 2 --seq 128 --rank 8 \
      --epochs 3 --lr 1e-3 --mode full --use-kernel

N tenants' adapters trained in one loop (``core.fleet_finetune``): epoch 0
populates every tenant's cache partition with one backbone forward per fleet
batch, later epochs are cached grouped steps. Each epoch prints its mean
per-tenant loss and wall time in the reference's format.

Same flags as the reference's CLI, plus ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions). ``--use-kernel`` sends the
grouped skip sum through K5 (``full``) or K8 (``int8``) forward and K9
backward; without it the sum is the ``blocked_skip_sum`` einsum. Weights are
random from seed 0, tokens and labels from seeds 1 and 2, adapters from
seed 3.

The reference drives its fleet through ``SessionRuntime.ingest`` and
``.adapt``, which at ``--devices 1`` equals the offline ``fleet_finetune``
bitwise (its ``--check-parity``); this CLI runs ``fleet_finetune`` directly.
``--devices`` other than 1 and ``--check-parity`` need the session runtime,
which belongs to a later slice of the port: they exit with a message.
"""

from __future__ import annotations

import argparse
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import fleet_finetune as FF
from repro_torch.core import lm_skiplora as SL
from repro_torch.models.lm import init_lm
from repro_torch.optim.optimizers import adamw


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--devices", type=int, default=1,
                    help="tenant-parallel devices (the session runtime: not ported)")
    ap.add_argument("--samples", type=int, default=8, help="samples per tenant")
    ap.add_argument("--batch-per-tenant", type=int, default=4)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--mode", default="full", choices=["full", "int8"])
    ap.add_argument("--use-kernel", action="store_true",
                    help="grouped CUDA kernels on the card (their plain versions on the CPU)")
    ap.add_argument("--check-parity", action="store_true",
                    help="session runtime against the offline trainer (the session runtime: not ported)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """(cfg, sl) for the flags; refuses what needs the session runtime."""
    if args.devices != 1 or args.check_parity:
        raise SystemExit(
            "--devices > 1 and --check-parity run the fleet through the session runtime "
            "(SessionRuntime ingest/adapt), which belongs to a later slice of the port; "
            "this CLI runs the offline fleet_finetune on one device"
        )
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    sl = SL.SkipLoRAConfig(rank=args.rank, mode=args.mode, cache_dtype="float32",
                           use_fused_kernel=args.use_kernel)
    return cfg, sl


def make_inputs(args: argparse.Namespace, cfg, device) -> tuple[Any, torch.Tensor, torch.Tensor]:
    """Seeded random weights (seed 0) and (tenants, samples, seq) tokens and
    labels (seeds 1 and 2) on ``device``."""
    shape = (args.tenants, args.samples, args.seq)

    def ints(seed):
        g = torch.Generator(device=device).manual_seed(seed)
        return torch.randint(0, cfg.vocab_size, shape, generator=g, device=device, dtype=torch.int32)

    return init_lm(torch.Generator(device=device).manual_seed(0), cfg), ints(1), ints(2)


def run(args, cfg, sl, params, tokens, labels, *, adapters: Optional[Any] = None, on_epoch=None) -> dict:
    """``fleet_finetune`` on the given inputs, printing one line as each
    epoch ends, then calling ``on_epoch(epoch, losses, seconds)`` if given.
    ``adapters``: initial stacked adapters (default: drawn from seed 3 on
    the params' device)."""
    n_t = args.tenants
    bpt = min(args.batch_per_tenant, args.samples)   # fleet_index_matrix clamp
    dev = params["embed"]["table"].device
    if dev.type == "cuda" and args.use_kernel:
        from repro_torch.kernels.skip_lora import kernel as K

        fwd = "grouped_skip_sum_fwd_actint8" if sl.mode == "int8" else "grouped_skip_sum_fwd"
        K.build(["grouped_skip_sum_fwd", fwd, "grouped_skip_sum_bwd"])   # not inside an epoch's time

    def report(e, ls, dt):
        kind = "populate" if e == 0 else "cached  "
        print(f"epoch {e} [{kind}] mean loss {float(np.mean(ls)):.4f} "
              f"time {dt:.2f}s ({n_t / dt:.1f} tenants/s/epoch)")
        if on_epoch is not None:
            on_epoch(e, ls, dt)

    res = FF.fleet_finetune(
        torch.Generator(device=dev).manual_seed(3), cfg, sl, params, tokens, labels,
        epochs=args.epochs, batch_per_tenant=bpt, optimizer=adamw(args.lr),
        use_kernel=args.use_kernel, adapters=adapters, on_epoch=report,
    )
    return {"losses": res.losses, "epoch_times": res.epoch_times_s, "devices": 1, "result": res}


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg, sl = setup(args)
    device = torch.device(args.device)
    params, tokens, labels = make_inputs(args, cfg, device)
    print(f"arch={cfg.name} mode={sl.mode} rank={sl.rank} tenants={args.tenants} "
          f"samples/tenant={args.samples} batch/tenant={args.batch_per_tenant} seq={args.seq} "
          f"use_kernel={args.use_kernel} device={device}")
    return run(args, cfg, sl, params, tokens, labels)


if __name__ == "__main__":
    main()
