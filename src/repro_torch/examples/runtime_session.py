"""A continual-learning session: serve, ingest, adapt, serve -- one engine.

The twin of the reference's ``examples/runtime_session.py`` on the port. A
fleet of devices serves from a shared ``AdapterPool`` while each device's
freshly collected samples flow into its skip-cache partition; a grouped
fine-tune advances every tenant's adapters with no backbone compute and
writes them back into the live pool mid-session.

It runs two tenants through the loop and shows the properties that make the
runtime coherent:

  1. ingestion doubles as serving: the populate forward returns adapted
     last-position logits while writing the cache;
  2. an ``adapt`` is visible to the very next ``serve`` (the write-back goes
     into the pool in place, and its slot is pinned against LRU churn);
  3. the interleaved trajectory is the offline ``fleet_finetune`` trajectory,
     bitwise;
  4. a session checkpoint (``checkpoint.save_runtime_session``) restored into
     a fresh runtime continues bitwise as the uninterrupted session does.

  PYTHONPATH=src python -m repro_torch.examples.runtime_session [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.checkpoint.checkpoint import restore_runtime_session, save_runtime_session
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import fleet_finetune as FF
from repro_torch.core import lm_skiplora as SL
from repro_torch.core.runtime import SessionRuntime
from repro_torch.models.lm import init_lm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    cfg = reduce_config(get_config("stablelm-1.6b"))
    sl = SL.SkipLoRAConfig(rank=8, mode="full", cache_dtype="float32", use_fused_kernel=True)
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    n_t, n_per, seq, bpt, epochs = 2, 8, 16, 4, 3

    def runtime():
        return SessionRuntime(cfg, sl, params, max_tenants=n_t, samples_per_tenant=n_per, seq=seq,
                              lr=1e-2, use_kernel=True, device=dev)

    def ints(seed, shape):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, cfg.vocab_size, shape, generator=g, device=dev)

    rt = runtime()
    prompts = ints(1, (n_t, 10))
    tokens, labels = ints(2, (n_t, n_per, seq)), ints(3, (n_t, n_per, seq))

    # serve: nobody fine-tuned yet -> base model for everyone.
    base = rt.serve([None] * n_t, prompts, max_new=8)
    print(f"serve (base)  : {tuple(base.shape)} tokens")

    # ingest: each device's collected batches; logits come back per batch.
    for t in range(n_t):
        for lo in range(0, n_per, bpt):
            logits = rt.ingest(f"device-{t}", tokens[t, lo:lo + bpt], labels[t, lo:lo + bpt])
    print(f"ingest        : {n_t * n_per} rows cached (+ {tuple(logits.shape)} logits per batch, serving for free)")

    # adapt: grouped cached epochs, write-back + pin, ready to serve.
    out = rt.adapt(epochs=epochs, batch_per_tenant=bpt, generator=torch.Generator(device=dev).manual_seed(4))
    mean0 = sum(float(out["losses"][f"device-{t}"][0].mean()) for t in range(n_t)) / n_t
    mean1 = sum(float(out["losses"][f"device-{t}"][-1].mean()) for t in range(n_t)) / n_t
    print(f"adapt         : {epochs} epochs on the {out['path']} path, mean loss {mean0:.4f} -> {mean1:.4f}, "
          f"pinned={sorted(rt.pool.pinned())}")

    # serve again, now with trained slots.
    adapted = rt.serve([f"device-{t}" for t in range(n_t)], prompts, max_new=8)
    changed = float((adapted != base).float().mean())
    print(f"serve (tuned) : {tuple(adapted.shape)} tokens, {changed:.0%} of tokens steered by the adapters")

    # parity: the interleaved session == the offline fleet trainer, bitwise.
    ref = FF.fleet_finetune(torch.Generator(device=dev).manual_seed(4), cfg, sl, params, tokens, labels,
                            epochs=epochs, batch_per_tenant=bpt, lr=1e-2, use_kernel=True)
    exact = all(torch.equal(rt.tenant(f"device-{t}").adapters[k], ref.adapters[k][t])
                for t in range(n_t) for k in ("A", "B"))
    print(f"offline parity: interleaved == fleet_finetune bitwise? {exact}")

    # checkpoint: save, restore into a fresh runtime, both continue one epoch.
    with tempfile.TemporaryDirectory() as d:
        restored = runtime()
        restore_runtime_session(save_runtime_session(d, 1, rt), restored)
    cont = [r.adapt(epochs=1, batch_per_tenant=bpt) for r in (rt, restored)]
    resumed = all(torch.equal(rt.tenant(t).adapters[k], restored.tenant(t).adapters[k])
                  for t in rt.pool.tenants() for k in ("A", "B"))
    resumed &= all((cont[0]["losses"][t] == cont[1]["losses"][t]).all() for t in cont[0]["losses"])
    print(f"checkpoint    : restored session continues bitwise? {resumed}")
    return {"offline_parity": exact, "checkpoint_resume": resumed}


if __name__ == "__main__":
    main()
