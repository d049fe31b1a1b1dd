"""Skip2-LoRA fine-tuning launcher, the counterpart of ``repro.launch.finetune``.

  python -m repro_torch.launch.finetune --arch stablelm-1.6b --full \
      --epochs 3 --samples 64 --batch 8 --seq 128 --mode full --use-kernel

The paper's loop on one tenant: epoch 0 *populates* the activation cache
(a frozen-backbone forward per batch, with an adapter step), and every
later epoch is a *cached* epoch with no backbone compute. Each epoch prints
its mean step loss and wall time; the last line is the cached-epoch speedup
over the populate epoch.

Same flags as the reference's CLI, plus ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions). ``--use-kernel`` sets
``SkipLoRAConfig.use_fused_kernel``: the cached step's skip sum goes through
K1 (``full``) or K3 (``int8``) and K2. Weights are random from seed 0,
adapters from seed 1, tokens from ``data.pipeline``'s synthetic store.

Every mode runs the single-tenant epoch loop of ``core.lm_skiplora``. The
reference sends ``full`` and ``int8`` through its ``SessionRuntime``, which
belongs to the session-runtime slice of the port, so ``--hbm-mb`` > 0 and
``--cache-dir`` (its tiered cache engine) raise ``NotImplementedError``.
Epoch orders come from ``data.pipeline.epoch_permutation`` (seed 2, one
permutation per epoch) batched by ``core.batch_plan.index_matrix``: the
reference draws them from ``jax.random``, which torch cannot reproduce, so
the two launchers visit the samples in different orders.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import lm_skiplora as SL
from repro_torch.core.batch_plan import index_matrix
from repro_torch.data.pipeline import DataConfig, epoch_permutation, make_pipeline
from repro_torch.models.lm import init_lm
from repro_torch.optim.optimizers import adamw

ORDER_SEED = 2


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mode", default="full", choices=["full", "int8", "freeze_a"])
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--hbm-mb", type=float, default=0.0,
                    help="cache HBM budget in MiB (the tiered engine: not ported)")
    ap.add_argument("--cache-dir", default=None,
                    help="host-tier directory (the tiered engine: not ported)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Run:
    """Everything one fine-tuning run carries from epoch to epoch."""

    args: argparse.Namespace
    cfg: Any
    sl: SL.SkipLoRAConfig
    device: torch.device
    params: Any
    tokens: torch.Tensor
    labels: torch.Tensor
    trainable: Any
    static: Any
    opt_state: Any
    cache: Any
    populate_epoch: Any
    cached_epoch: Any


def epoch_index_matrix(epoch: int, n: int, batch: int, device) -> torch.Tensor:
    """(steps, batch) sample ids of one epoch; a non-dividing tail wraps."""
    perm = epoch_permutation(ORDER_SEED, epoch, n)
    return torch.as_tensor(index_matrix(perm, batch, tail="wrap"), device=device)


def prepare(args: argparse.Namespace) -> Run:
    """Model, data, adapters, optimizer and an empty cache on ``args.device``."""
    if args.hbm_mb > 0 or args.cache_dir is not None:
        raise NotImplementedError(
            "--hbm-mb / --cache-dir need the session runtime's tiered cache engine, "
            "which belongs to the session-runtime slice and is not ported yet")
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    sl = SL.SkipLoRAConfig(rank=args.rank, mode=args.mode, cache_dtype="float32",
                           use_fused_kernel=args.use_kernel)
    params = init_lm(torch.Generator(device=device).manual_seed(0), cfg)
    store, _ = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                        global_batch=args.batch, num_samples=args.samples))
    staged = store.batch(np.arange(args.samples))
    adapters = SL.init_adapters(torch.Generator(device=device).manual_seed(1), cfg, sl)
    trainable, static = SL.split_trainable(adapters, sl)
    opt = adamw(args.lr)
    if device.type == "cuda" and sl.use_fused_kernel and sl.mode != "freeze_a":
        from repro_torch.kernels.skip_lora import kernel as K

        fwd = "skip_lora_fwd_int8" if sl.mode == "int8" else "skip_lora_fwd"
        K.build([fwd, "skip_lora_bwd"])   # not inside the first cached epoch's time
    return Run(
        args=args, cfg=cfg, sl=sl, device=device, params=params,
        tokens=torch.as_tensor(staged["tokens"], device=device),
        labels=torch.as_tensor(staged["labels"], device=device),
        trainable=trainable, static=static, opt_state=opt.init(trainable),
        cache=SL.init_lm_cache(args.samples, cfg, sl, args.seq, device=device),
        populate_epoch=SL.make_populate_epoch(cfg, sl, opt),
        cached_epoch=SL.make_cached_epoch(cfg, sl, opt),
    )


def run_epoch(run: Run, epoch: int) -> torch.Tensor:
    """Epoch 0 populates the cache, later epochs read it. Returns the step
    losses (steps,) on the device; the run's adapters and optimizer state
    advance."""
    idx_mat = epoch_index_matrix(epoch, run.args.samples, run.args.batch, run.device)
    if epoch == 0:
        run.trainable, run.opt_state, run.cache, losses = run.populate_epoch(
            run.params, run.trainable, run.static, run.opt_state, run.cache,
            run.tokens, run.labels, idx_mat,
        )
    else:
        run.trainable, run.opt_state, losses = run.cached_epoch(
            run.params, run.trainable, run.static, run.opt_state, run.cache, idx_mat,
        )
    return losses


def main(argv=None) -> dict:
    args = parse_args(argv)
    run = prepare(args)
    print(f"arch={run.cfg.name} mode={run.sl.mode} rank={run.sl.rank} "
          f"cache/sample={SL.cache_nbytes_per_sample(run.cfg, run.sl, args.seq) / 2**20:.2f} MiB "
          f"device={run.device}")
    epoch_times, losses = [], []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        ls = run_epoch(run, epoch)
        mean = float(ls.mean())   # waits for the device
        dt = time.perf_counter() - t0
        epoch_times.append(dt)
        losses.append(mean)
        kind = "populate" if epoch == 0 else "cached  "
        print(f"epoch {epoch} [{kind}] loss {mean:.4f} time {dt:.2f}s")
    if len(epoch_times) > 1:
        speedup = epoch_times[0] / (sum(epoch_times[1:]) / len(epoch_times[1:]))
        print(f"cached-epoch speedup vs populate epoch: {speedup:.1f}x")
    return {"epoch_times": epoch_times, "losses": losses, "run": run}


if __name__ == "__main__":
    main()
