"""End-to-end example: Skip2-LoRA fine-tune a ~100M-parameter LM, on the port.

The twin of the reference's ``examples/finetune_lm.py``: the same flags,
configs, data and printed lines. It builds a 14-layer / d=576
stablelm-family model (~100M params with its 50k vocab, float32), runs
Algorithm 1 -- one populate epoch that fills the activation cache, then
cached epochs with ZERO backbone compute -- and reports the loss curve and
the measured cached-epoch speedup. On the card each epoch phase is
CUDA-graph replays of one captured step (``core.lm_skiplora``), the port's
form of the reference's one ``lax.scan`` dispatch, so the wall time
measures the paper's arithmetic rather than Python dispatch; the first
epoch of each phase includes its capture, as the reference's includes its
compile, and a last line gives the capture seconds. On the CPU the epochs
are the eager loop.

  PYTHONPATH=src python -m repro_torch.examples.finetune_lm            # ~100M, on the card
  PYTHONPATH=src python -m repro_torch.examples.finetune_lm --small --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import lm_skiplora as SL
from repro_torch.data.pipeline import DataConfig, epoch_permutation, make_pipeline
from repro_torch.models.lm import init_lm
from repro_torch.optim.optimizers import adamw


def build_100m_config(small: bool):
    base = get_config("stablelm-1.6b")
    if small:
        return dataclasses.replace(
            base, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
            d_ff=352, vocab_size=2048, dtype="float32",
        )
    # ~100M: 14L x 576d x SwiGLU(1536) + 50k x 576 embeddings (untied x2).
    return dataclasses.replace(
        base, n_layers=14, d_model=576, n_heads=8, n_kv_heads=8,
        d_ff=1536, vocab_size=50304, dtype="float32",
    )


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, and ``--device`` (default the card)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--samples", type=int, default=0, help="0 -> default")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=0, help="0 -> default")
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--mode", default="full", choices=["full", "int8", "freeze_a"])
    ap.add_argument("--device", default="cuda")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    args.samples = args.samples or (32 if args.small else 64)
    args.seq = args.seq or (64 if args.small else 256)
    return args


def staged_data(cfg, args) -> tuple[np.ndarray, np.ndarray]:
    """The fine-tune set, staged once: (samples, seq) tokens and labels from
    the synthetic pipeline."""
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
                      num_samples=args.samples)
    store, _ = make_pipeline(dcfg)
    staged = store.batch(np.arange(args.samples))
    return staged["tokens"], staged["labels"]


def finetune(cfg, sl: SL.SkipLoRAConfig, params, adapters, tokens: torch.Tensor, labels: torch.Tensor, *,
             epochs: int, batch: int, lr: float = 2e-3) -> dict:
    """Algorithm 1 on the tokens' device from the given backbone and flat
    adapters: epoch 0 populates the cache, later epochs read it. Every epoch
    visits ``epoch_permutation(0, 0, samples)`` cut to whole batches, as the
    reference's does. Prints one line an epoch; returns {"losses": each
    epoch's step losses (steps,) as numpy, "times": epoch seconds,
    "trainable", "graphs": ``SL.GRAPHS.stats`` gained over the run}."""
    samples = tokens.shape[0]
    steps_per_epoch = samples // batch
    trainable, static = SL.split_trainable(adapters, sl)
    opt = adamw(lr)
    opt_state = opt.init(trainable)
    cache = SL.init_lm_cache(samples, cfg, sl, tokens.shape[1], device=tokens.device)
    populate_epoch = SL.make_populate_epoch(cfg, sl, opt)
    cached_epoch = SL.make_cached_epoch(cfg, sl, opt)
    stats0 = SL.GRAPHS.stats.copy()

    losses, times = [], []
    for epoch in range(epochs):
        perm = epoch_permutation(0, 0, samples)
        idx_mat = torch.as_tensor(perm[: steps_per_epoch * batch].reshape(steps_per_epoch, batch),
                                  device=tokens.device)
        t0 = time.perf_counter()
        if epoch == 0:
            trainable, opt_state, cache, ls = populate_epoch(
                params, trainable, static, opt_state, cache, tokens, labels, idx_mat)
        else:
            trainable, opt_state, ls = cached_epoch(params, trainable, static, opt_state, cache, idx_mat)
        ls = ls.cpu().numpy()   # waits for the device
        dt = time.perf_counter() - t0
        times.append(dt)
        losses.append(ls)
        kind = "populate" if epoch == 0 else "cached"
        print(f"epoch {epoch:2d} [{kind:8s}] loss={float(ls[-1]):.4f} {dt:6.2f}s")

    if len(times) > 2:
        cached_avg = sum(times[1:]) / len(times[1:])
        print(f"\ncached epoch speedup vs populate: {times[0]/cached_avg:.1f}x "
              f"(backbone forward fully skipped after epoch 0)")
    gained = SL.GRAPHS.stats.copy()
    gained.subtract(stats0)
    if tokens.is_cuda:
        print(f"CUDA graphs: {gained['captures']} captured in {gained['capture_s']:.2f}s "
              f"(+{gained['first_step_s']:.2f}s eager first steps), {gained['replays']} step replays")
    return {"losses": losses, "times": times, "trainable": trainable, "graphs": gained}


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    cfg = build_100m_config(args.small)
    sl = SL.SkipLoRAConfig(rank=args.rank, mode=args.mode, cache_dtype="float32")
    steps_per_epoch = args.samples // args.batch
    print(
        f"model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab_size} "
        f"params={cfg.param_count()/1e6:.1f}M | mode={sl.mode} rank={sl.rank} | "
        f"{args.epochs} epochs x {steps_per_epoch} steps | "
        f"cache {SL.cache_nbytes_per_sample(cfg, sl, args.seq)*args.samples/2**20:.1f} MiB"
    )
    params = init_lm(torch.Generator(device=device).manual_seed(0), cfg)
    adapters = SL.init_adapters(torch.Generator(device=device).manual_seed(1), cfg, sl)
    tokens, labels = (torch.as_tensor(a, device=device) for a in staged_data(cfg, args))
    return finetune(cfg, sl, params, adapters, tokens, labels, epochs=args.epochs, batch=args.batch)


if __name__ == "__main__":
    main()
