"""Multi-tenant serving launcher, the counterpart of ``repro.launch.serve``.

  python -m repro_torch.launch.serve --arch stablelm-1.6b --no-reduced \
      --batch 4 --prompt-len 128 --gen 32 --tenants 3 [--pool-compress int8]

Same flags as the reference's CLI, plus ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions). ``--reduced/--no-reduced`` is a
working pair here, default reduced. With ``--tenants N`` the launcher builds
an ``AdapterPool``, registers N demo tenants (B ~ 0.02 N(0, 1)), and serves
one mixed batch -- row 0 on the base model via the zero slot, the other rows
cycling through the tenants -- with ``generate_grouped`` over
``pool.lookup(tenants)``, which is what the reference's one-shard session
runs. Weights and prompts are random, drawn from fixed seeds.
``--scheduler``, ``--loop`` and ``--unroll`` other than 1 are not ported yet
and raise.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import lm_skiplora as SL
from repro_torch.core.adapter_pool import AdapterPool
from repro_torch.core.runtime import generate, generate_grouped
from repro_torch.models.lm import init_lm


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def demo_pool(cfg, n_tenants: int, rank: int, compress, device) -> AdapterPool:
    """Pool with ``n_tenants`` pretend on-device fine-tunes (B != 0)."""
    sl = SL.SkipLoRAConfig(rank=rank)
    pool = AdapterPool(n_tenants + 1, cfg, rank, compress=compress, device=device)
    for t in range(n_tenants):
        ad = SL.init_adapters(_gen(100 + t, device), cfg, sl)
        ad["B"] = torch.randn(ad["B"].shape, generator=_gen(200 + t, device), device=device) * 0.02
        pool.register(f"tenant-{t}", ad)
    return pool


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--with-adapters", action="store_true")
    ap.add_argument("--tenants", type=int, default=0,
                    help="serve a multi-tenant batch over this many adapters")
    ap.add_argument("--pool-compress", choices=["int8"], default=None)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--unroll", type=int, default=1,
                    help="(reference's scan knob; not ported)")
    ap.add_argument("--loop", action="store_true", help="(not ported)")
    ap.add_argument("--scheduler", action="store_true", help="(not ported)")
    ap.add_argument("--chunk", type=int, default=4,
                    help="decode steps per scheduler dispatch (not ported)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for flag, on in (("--scheduler", args.scheduler), ("--loop", args.loop),
                     ("--unroll", args.unroll != 1)):
        if on:
            raise NotImplementedError(f"{flag} is not yet ported")

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    params = init_lm(_gen(0, device), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=_gen(3, device), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.tenants > 0:
        pool = demo_pool(cfg, args.tenants, args.rank, args.pool_compress, device)
        tenants = [None] + [f"tenant-{i % args.tenants}" for i in range(1, args.batch)]
        sync()
        t0 = time.perf_counter()
        toks = generate_grouped(
            params, cfg, prompts, pool.pools(), pool.lookup(tenants),
            max_new=args.gen, temperature=args.temperature, device=device,
        )
        sync()
        dt = time.perf_counter() - t0
        print(f"[grouped x{args.tenants} tenants, pool {pool.nbytes() / 2**20:.1f} MiB, "
              f"compress={args.pool_compress}]")
    else:
        adapters_stack = None
        if args.with_adapters:
            ad = SL.init_adapters(_gen(1, device), cfg, SL.SkipLoRAConfig(rank=args.rank))
            ad["B"] = torch.randn(ad["B"].shape, generator=_gen(2, device), device=device) * 0.01
            adapters_stack = SL.adapters_to_stack(ad)
        sync()
        t0 = time.perf_counter()
        toks = generate(
            params, cfg, prompts, max_new=args.gen, adapters_stack=adapters_stack,
            temperature=args.temperature, device=device,
        )
        sync()
        dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s on {where}, first call)")
    print("first sequences:", toks[:2, :8].tolist())


if __name__ == "__main__":
    main()
