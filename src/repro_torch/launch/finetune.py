"""Skip2-LoRA fine-tuning launcher, the counterpart of ``repro.launch.finetune``.

  python -m repro_torch.launch.finetune --arch stablelm-1.6b --full \
      --epochs 3 --samples 64 --batch 8 --seq 128 --mode full --use-kernel

The paper's Algorithm 1 on one tenant. Modes ``full`` and ``int8`` run, as
the reference's CLI does, as a one-tenant ``SessionRuntime``: epoch 0
*ingests* the fine-tuning set (populate forwards that write the activation
cache) and then runs one ``adapt`` epoch; every later epoch is a cached
``adapt`` with no backbone compute. Each epoch prints its mean step loss,
wall time and adapt path; the last line is the cached-epoch speedup over
epoch 0. On the card the epochs are CUDA-graph replays (the session's
resident adapt, or ``core.lm_skiplora``'s epochs), and an epoch that
captured its graphs says how much of its time the captures and its eager
first step took.

With ``--hbm-mb`` the runtime's ``TieredCacheEngine`` holds that many MiB of
cache rows on the device: the rest spill to the host tier (on disk under
``--cache-dir``, else in memory) and ``adapt`` takes the streaming path
instead of the resident one; the tier counts print at the end.

Same flags as the reference's CLI, plus ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions). In the session modes
``--use-kernel`` sends ingest's last-position sum through K5 and adapt's
grouped sums through K5 (``full``) or K8 (``int8``) forward and K9 backward;
without it they are the plain versions and the ``blocked_skip_sum`` einsum.
Weights are random from seed 0, adapters from seed 1, tokens from
``data.pipeline``'s synthetic store; the session's epoch orders are the
fleet planner's (``core.batch_plan``), the reference's own.

``--mode freeze_a`` (an R-wide cache, not a fleet mode) keeps the
single-tenant epoch loop of ``core.lm_skiplora`` (``prepare`` /
``run_epoch``), as the reference's ``_legacy_freeze_a`` does: epoch 0
populates with an adapter step, ``--use-kernel`` sets
``SkipLoRAConfig.use_fused_kernel`` (K1 or K3 forward and K2 backward in the
modes that take them), and epoch orders come from
``data.pipeline.epoch_permutation`` (seed 2) batched by
``core.batch_plan.index_matrix``, where the reference draws them from
``jax.random``.
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
from repro_torch.core.cuda_graph import capture_note
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
                    help="cache device budget in MiB; 0 = fully device-resident")
    ap.add_argument("--cache-dir", default=None,
                    help="host-tier directory (disk spill); default in memory")
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


def _setup(args: argparse.Namespace, params=None):
    """(device, cfg, sl, params, tokens, labels) for the flags; ``params``
    defaults to the seed-0 draw."""
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    sl = SL.SkipLoRAConfig(rank=args.rank, mode=args.mode, cache_dtype="float32",
                           use_fused_kernel=args.use_kernel)
    if params is None:
        params = init_lm(torch.Generator(device=device).manual_seed(0), cfg)
    store, _ = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                        global_batch=args.batch, num_samples=args.samples))
    staged = store.batch(np.arange(args.samples))
    return (device, cfg, sl, params, torch.as_tensor(staged["tokens"], device=device),
            torch.as_tensor(staged["labels"], device=device))


def prepare(args: argparse.Namespace, params=None) -> Run:
    """The single-tenant loop's model, data, adapters, optimizer and empty
    cache on ``args.device``; ``params``, a backbone already drawn for
    ``args.arch`` on that device, saves drawing it again."""
    device, cfg, sl, params, tokens, labels = _setup(args, params)
    adapters = SL.init_adapters(torch.Generator(device=device).manual_seed(1), cfg, sl)
    trainable, static = SL.split_trainable(adapters, sl)
    opt = adamw(args.lr)
    if device.type == "cuda" and sl.use_fused_kernel and sl.mode != "freeze_a":
        from repro_torch.kernels.skip_lora import kernel as K

        fwd = "skip_lora_fwd_int8" if sl.mode == "int8" else "skip_lora_fwd"
        K.build([fwd, "skip_lora_bwd"])   # not inside the first cached epoch's time
    return Run(
        args=args, cfg=cfg, sl=sl, device=device, params=params, tokens=tokens, labels=labels,
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
    if args.mode == "freeze_a":
        if args.hbm_mb > 0 or args.cache_dir is not None:
            raise SystemExit("--hbm-mb / --cache-dir place the session runtime's cache: modes full and int8")
        return _single_tenant_main(args)
    return _session_main(args)


def _report(epoch: int, mean: float, dt: float, extra: str = "") -> None:
    kind = "populate" if epoch == 0 else "cached  "
    print(f"epoch {epoch} [{kind}] loss {mean:.4f} time {dt:.2f}s{extra}")


def _speedup(epoch_times: list[float]) -> None:
    if len(epoch_times) > 1:
        speedup = epoch_times[0] / (sum(epoch_times[1:]) / len(epoch_times[1:]))
        print(f"cached-epoch speedup vs populate epoch: {speedup:.1f}x")


def _session_main(args: argparse.Namespace) -> dict:
    """Modes full and int8 as a one-tenant session: ingest, then adapt."""
    from repro_torch.core.runtime import SessionRuntime

    device, cfg, sl, params, tokens, labels = _setup(args)
    print(f"arch={cfg.name} mode={sl.mode} rank={sl.rank} "
          f"cache/sample={SL.cache_nbytes_per_sample(cfg, sl, args.seq) / 2**20:.2f} MiB device={device}")
    rt = SessionRuntime(
        cfg, sl, params, max_tenants=1, samples_per_tenant=args.samples, seq=args.seq, lr=args.lr,
        use_kernel=args.use_kernel, hbm_budget_bytes=int(args.hbm_mb * 2**20) if args.hbm_mb > 0 else None,
        cache_dir=args.cache_dir, device=device,
    )
    if args.hbm_mb > 0:
        print(f"tiered engine: HBM budget {args.hbm_mb:g} MiB -> {rt.engine.capacity}/{args.samples} rows resident")
    if device.type == "cuda" and args.use_kernel:
        from repro_torch.kernels.skip_lora import kernel as K

        fwd = "grouped_skip_sum_fwd_actint8" if sl.mode == "int8" else "grouped_skip_sum_fwd"
        K.build(["grouped_skip_sum_fwd", fwd, "grouped_skip_sum_bwd"])   # not inside epoch 0's time
    epoch_times, losses, paths = [], [], []
    generator = torch.Generator(device=device).manual_seed(1)
    for epoch in range(args.epochs):
        graphs0 = rt.epoch_graph_stats()
        t0 = time.perf_counter()
        if epoch == 0:
            # Populate: ingest the whole set, one backbone forward a sample
            # (in a live session these logits serve the caller).
            for lo in range(0, args.samples, args.batch):
                rt.ingest("device-0", tokens[lo:lo + args.batch], labels[lo:lo + args.batch])
        out = rt.adapt(epochs=1, batch_per_tenant=args.batch, generator=generator)
        mean = float(out["losses"]["device-0"].mean())   # on the host: the epoch has ended
        dt = time.perf_counter() - t0
        epoch_times.append(dt)
        losses.append(mean)
        paths.append(out["path"])
        _report(epoch, mean, dt, f" ({out['path']} path{capture_note(rt.epoch_graph_stats(), graphs0)})")
    _speedup(epoch_times)
    result = {"epoch_times": epoch_times, "losses": losses, "paths": paths, "runtime": rt}
    if args.hbm_mb > 0:
        st = rt.engine.stats
        print(f"cache tiers: hbm_hits={st.hbm_hits} host_hits={st.host_hits} staged_hits={st.staged_hits} "
              f"spills={st.spills} hbm_hit_rate={st.hbm_hit_rate():.2f}")
        result["cache_stats"] = st
    return result


def _single_tenant_main(args: argparse.Namespace) -> dict:
    """The single-tenant loop of ``core.lm_skiplora`` (mode freeze_a)."""
    run = prepare(args)
    print(f"arch={run.cfg.name} mode={run.sl.mode} rank={run.sl.rank} "
          f"cache/sample={SL.cache_nbytes_per_sample(run.cfg, run.sl, args.seq) / 2**20:.2f} MiB "
          f"device={run.device}")
    epoch_times, losses = [], []
    for epoch in range(args.epochs):
        graphs0 = SL.GRAPHS.stats.copy()
        t0 = time.perf_counter()
        ls = run_epoch(run, epoch)
        mean = float(ls.mean())   # waits for the device
        dt = time.perf_counter() - t0
        epoch_times.append(dt)
        losses.append(mean)
        note = capture_note(SL.GRAPHS.stats, graphs0)
        _report(epoch, mean, dt, f" ({note[2:]})" if note else "")
    _speedup(epoch_times)
    return {"epoch_times": epoch_times, "losses": losses, "run": run}


if __name__ == "__main__":
    main()
