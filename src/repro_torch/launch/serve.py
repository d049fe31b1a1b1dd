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
runs. ``--scheduler`` serves the same rows as one request each through a
``SessionRuntime``'s continuous-batching ``RequestScheduler`` (admission
bucket 2, ``--chunk`` decode steps a dispatch; ``max(--tenants, 1)`` demo
tenants). Weights and prompts are random, drawn from fixed seeds.
``--unroll N`` replays one CUDA graph for every N decode steps on the card
(the CPU runs the same steps eagerly); ``--loop`` runs single-stack serving
as the per-token eager loop (``generate_loop``) instead, and is refused with
``--scheduler`` or ``--tenants``, as the reference refuses it. The last
lines say how the decode ran: graph replays and eager steps.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import decode_graph
from repro_torch.core import lm_skiplora as SL
from repro_torch.core.adapter_pool import AdapterPool
from repro_torch.core.runtime import SessionRuntime, generate, generate_grouped, generate_loop
from repro_torch.models.lm import init_lm


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _register_demo(pool: AdapterPool, cfg, n_tenants: int, rank: int, device) -> None:
    """Register ``n_tenants`` pretend on-device fine-tunes (B != 0)."""
    sl = SL.SkipLoRAConfig(rank=rank)
    for t in range(n_tenants):
        ad = SL.init_adapters(_gen(100 + t, device), cfg, sl)
        ad["B"] = torch.randn(ad["B"].shape, generator=_gen(200 + t, device), device=device) * 0.02
        pool.register(f"tenant-{t}", ad)


def demo_pool(cfg, n_tenants: int, rank: int, compress, device) -> AdapterPool:
    """Pool with ``n_tenants`` demo tenants ``tenant-0``... plus the zero slot."""
    pool = AdapterPool(n_tenants + 1, cfg, rank, compress=compress, device=device)
    _register_demo(pool, cfg, n_tenants, rank, device)
    return pool


def demo_runtime(cfg, n_tenants: int, rank: int, compress, params, device) -> SessionRuntime:
    """Serving session whose pool holds ``demo_pool``'s tenants."""
    rt = SessionRuntime(cfg, SL.SkipLoRAConfig(rank=rank), params, max_tenants=n_tenants,
                        samples_per_tenant=1, seq=8, pool_compress=compress, device=device)
    _register_demo(rt.pool, cfg, n_tenants, rank, device)
    return rt


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
                    help="decode steps per CUDA-graph replay")
    ap.add_argument("--loop", action="store_true",
                    help="use the per-token eager loop instead of the graph replays")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve through the continuous-batching request scheduler (one "
                         "request per batch row, staggered admission) instead of one "
                         "pre-formed batch")
    ap.add_argument("--chunk", type=int, default=4,
                    help="decode steps per scheduler dispatch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.loop and args.scheduler:
        ap.error("--loop and --scheduler are mutually exclusive")
    if args.loop and args.tenants > 0:
        ap.error("--loop applies to single-stack serving; the grouped multi-tenant path always "
                 "replays the decode graph")
    if args.unroll < 1:
        ap.error(f"--unroll {args.unroll} < 1")

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

    stats0 = dict(decode_graph.GRAPHS.stats)
    if args.scheduler:
        n_t = max(args.tenants, 1)
        rt = demo_runtime(cfg, n_t, args.rank, args.pool_compress, params, device)
        rt.attach_scheduler(max_batch=args.batch, max_prompt=args.prompt_len,
                            max_new_cap=args.gen, chunk=args.chunk,
                            admit_bucket=min(2, args.batch))
        tenants = [None] + [f"tenant-{i % n_t}" for i in range(1, args.batch)]
        sync()
        t0 = time.perf_counter()
        reqs = [rt.enqueue_serve(t, prompts[i].cpu().numpy(), max_new=args.gen,
                                 temperature=args.temperature)
                for i, t in enumerate(tenants)]
        rt.drain()
        sync()
        dt = time.perf_counter() - t0
        toks = torch.stack([torch.as_tensor(r.result()) for r in reqs])
        c = rt.scheduler.counters
        print(f"[scheduler: {c['dispatch/admit']} admit + {c['dispatch/admit_reuse']} reuse "
              f"admit + {c['dispatch/step']} step dispatches, chunk {args.chunk}]")
    elif args.tenants > 0:
        pool = demo_pool(cfg, args.tenants, args.rank, args.pool_compress, device)
        tenants = [None] + [f"tenant-{i % args.tenants}" for i in range(1, args.batch)]
        sync()
        t0 = time.perf_counter()
        toks = generate_grouped(
            params, cfg, prompts, pool.pools(), pool.lookup(tenants),
            max_new=args.gen, temperature=args.temperature, unroll=args.unroll, device=device,
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
        if args.loop:
            toks = generate_loop(params, cfg, prompts, max_new=args.gen, adapters_stack=adapters_stack,
                                 temperature=args.temperature, device=device)
        else:
            toks = generate(params, cfg, prompts, max_new=args.gen, adapters_stack=adapters_stack,
                            temperature=args.temperature, unroll=args.unroll, device=device)
        sync()
        dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    stats = decode_graph.GRAPHS.stats
    replays = stats["replays"] - stats0.get("replays", 0)
    eager = stats["eager_steps"] - stats0.get("eager_steps", 0)
    if args.loop:
        decode = f"{args.gen} eager decode steps (per-token loop)"
    elif device.type == "cpu":
        decode = "eager decode steps (CPU)"
    else:
        decode = (f"{replays} decode graph replay{'s' if replays != 1 else ''}"
                  f"{f' + {eager} eager warm-up step' if eager else ''}, unroll {args.unroll}")
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s on {where}, first call; {decode})")
    print("first sequences:", toks[:2, :8].tolist())


if __name__ == "__main__":
    main()
