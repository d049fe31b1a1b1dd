"""Multi-tenant serving of Skip-LoRA adapters (post-fine-tune deploy), on the port.

The twin of the reference's ``examples/serve_adapted.py``: the same config,
draws and printed lines. The skip topology can't be merged into the
backbone (each adapter connects layer-k input to the final output), so
serving always pays a running skip-sum. At fleet scale every request row
belongs to a different user's on-device fine-tune, so the flow is:

  1. register each tenant's fine-tuned stack in an ``AdapterPool``
     (slot-based, LRU-evicting, optionally int8-compressed);
  2. ``pool.lookup`` the batch's tenants into per-row slot indices
     (``None`` -> the pinned zero slot = base model);
  3. ``generate_grouped``: ONE backbone prefill + the decode steps (CUDA-graph
     replays on the card), the per-row skip-sums gathered from the pool by
     the grouped sum's plain version (``use_kernel=False``, as the reference
     runs it).

This example registers three pretend tenants, serves a mixed batch (base +
three different adapters) in one call, and checks each row's tokens match
single-tenant serving of the same adapter stack.

  PYTHONPATH=src python -m repro_torch.examples.serve_adapted [--device cpu]
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

RANK = 8
BATCH, PROMPT_LEN, GEN = 4, 24, 12


def build_config():
    return reduce_config(get_config("gemma2-9b"))  # exercises softcaps + local/global


def serve(cfg, params, adapters: dict, prompts: torch.Tensor, *, gen: int = GEN, rank: int = RANK) -> dict:
    """Register ``adapters`` (tenant -> flat {"A", "B"}) in an 8-slot pool on
    the prompts' device, serve base + every tenant in one grouped call, and
    hold each row against single-tenant ``generate``. Prints the
    reference's three lines; returns {"mixed": (B, gen) tokens, "agree":
    rows equal to solo serving, "diverged", "pool"}."""
    device = prompts.device
    pool = AdapterPool(8, cfg, rank, device=device)
    stacks = {}
    for t, ad in adapters.items():
        pool.register(t, ad)
        stacks[t] = SL.adapters_to_stack(ad)

    # One mixed batch: row 0 serves the base model via the zero slot.
    who = [None] + list(adapters)
    idx = pool.lookup(who)
    t0 = time.perf_counter()
    mixed = generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=gen, use_kernel=False, device=device)
    mixed = mixed.cpu()   # waits for the device
    t_mixed = time.perf_counter() - t0

    # Reference: serve each row alone under its own stack.
    agree = 0
    for row, tenant in enumerate(who):
        stack = None if tenant is None else stacks[tenant]
        solo = generate(params, cfg, prompts[row: row + 1], max_new=gen, adapters_stack=stack, device=device)
        agree += int(torch.equal(mixed[row], solo[0].cpu()))

    base_row, adapted_rows = mixed[0], mixed[1:]
    diverged = float((adapted_rows != base_row.expand_as(adapted_rows)).float().mean())
    print(f"mixed batch {tuple(mixed.shape)} in {t_mixed:.2f}s "
          f"(1 prefill + {gen} decode steps incl. graph capture; pool {pool.nbytes() / 2**20:.2f} MiB, "
          f"{len(pool)} tenants)")
    print(f"rows matching single-tenant serving: {agree}/{len(who)}")
    print(f"adapter-vs-base token divergence rate: {diverged:.2f} "
          "(adapters steer the model)")
    return {"mixed": mixed, "agree": agree, "diverged": diverged, "pool": pool}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    cfg = build_config()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg)

    # Pretend three users fine-tuned on-device: give each B a nonzero value.
    sl = SL.SkipLoRAConfig(rank=RANK)
    adapters = {}
    for t in range(3):
        ad = SL.init_adapters(torch.Generator(device=dev).manual_seed(10 + t), cfg, sl)
        g = torch.Generator(device=dev).manual_seed(20 + t)
        ad["B"] = torch.randn(ad["B"].shape, generator=g, device=dev) * 0.02
        adapters[f"user-{t}"] = ad

    g = torch.Generator(device=dev).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=g, device=dev)
    return serve(cfg, params, adapters, prompts)


if __name__ == "__main__":
    main()
