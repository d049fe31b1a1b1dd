"""Fleet fine-tuning launcher, the counterpart of ``repro.launch.fleet``.

  python -m repro_torch.launch.fleet --arch stablelm-1.6b --full \
      --tenants 4 --samples 16 --batch-per-tenant 2 --seq 128 --rank 8 \
      --epochs 3 --lr 1e-3 --mode full --use-kernel

N tenants' adapters trained as one session, as the reference's CLI runs
them (its ``_runtime_main``): a ``SessionRuntime`` ingests every tenant's
samples (populate forwards that fill each tenant's cache partition, one
batch of ``--batch-per-tenant`` rows at a time), then runs one grouped
``adapt`` epoch per epoch with write-back into the session's pool. Each
epoch prints its mean per-tenant loss and wall time in the reference's
format.

``--check-parity`` also runs the offline trainer (``core.fleet_finetune``:
epoch 0 populates with an adapter step, later epochs are cached grouped
steps) on the same inputs and initial adapters, and exits nonzero unless
the session's losses and adapters equal it bitwise (mode ``full``; mode
``int8`` trains on the quantised cache in every session epoch, the offline
populate epoch on full-precision activations, so it is refused).
``--devices N`` runs the session over a data mesh of N devices (the first N
CUDA devices, or N repeated CPU entries with ``--device cpu``), one logical
shard a device, each shard's tenants one adapt group on its device; the
tenants must divide over the devices. Its parity bar is 1e-5, the
reference's: a group of fewer tenants runs its products at other shapes.

Same flags as the reference's CLI, plus ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions). ``--use-kernel`` sends the
grouped skip sum through K5 (``full``) or K8 (``int8``) forward and K9
backward, and ingest's last-position sum through K5; without it the sums are
the plain versions and the ``blocked_skip_sum`` einsum. Weights are random
from seed 0, tokens and labels from seeds 1 and 2, adapters from seed 3.
``run`` is the offline trainer on its own.
"""

from __future__ import annotations

import argparse
import time
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
                    help="tenant-parallel devices (with --device cpu, repeated CPU entries)")
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
                    help="hold the session's losses and adapters to the offline trainer's, bitwise")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """(cfg, sl) for the flags; refuses what the port does not run."""
    if args.devices < 1 or args.tenants % args.devices:
        raise SystemExit(f"--tenants {args.tenants} must divide over --devices {args.devices}")
    if args.check_parity and args.mode != "full":
        raise SystemExit(
            "--check-parity requires --mode full: int8 session epochs train on the quantised "
            "cache, while the offline populate epoch steps on full-precision activations"
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


def _build_kernels(args, sl, dev) -> None:
    """Build the grouped kernels before any epoch is timed."""
    if dev.type == "cuda" and args.use_kernel:
        from repro_torch.kernels.skip_lora import kernel as K

        fwd = "grouped_skip_sum_fwd_actint8" if sl.mode == "int8" else "grouped_skip_sum_fwd"
        K.build(["grouped_skip_sum_fwd", fwd, "grouped_skip_sum_bwd"])


def run(args, cfg, sl, params, tokens, labels, *, adapters: Optional[Any] = None, on_epoch=None) -> dict:
    """The offline ``fleet_finetune`` on the given inputs, printing one line
    as each epoch ends, then calling ``on_epoch(epoch, losses, seconds)`` if
    given. ``adapters``: initial stacked adapters (default: drawn from seed
    3 on the params' device)."""
    n_t = args.tenants
    bpt = min(args.batch_per_tenant, args.samples)   # fleet_index_matrix clamp
    dev = params["embed"]["table"].device
    _build_kernels(args, sl, dev)

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


def run_session(args, cfg, sl, params, tokens, labels, *, on_epoch=None) -> dict:
    """The fleet as one session: ingest every tenant's samples, then one
    ``adapt`` epoch per epoch, printing one line as each epoch ends and
    calling ``on_epoch(epoch, losses (steps, N), seconds)`` if given. Fresh
    tenants draw their adapters from seed 3 on the params' device, as
    ``run`` does."""
    from repro_torch.core.runtime import SessionRuntime
    from repro_torch.launch.run import mesh_devices
    from repro_torch.runtime.sharding import make_mesh

    n_t, n_per = args.tenants, args.samples
    bpt = min(args.batch_per_tenant, n_per)   # fleet_index_matrix clamp
    dev = params["embed"]["table"].device
    _build_kernels(args, sl, dev)
    devices = [dev] if args.devices == 1 else mesh_devices(dev.type, args.devices)
    rt = SessionRuntime(cfg, sl, params, max_tenants=n_t, samples_per_tenant=n_per, seq=args.seq,
                        optimizer=adamw(args.lr), use_kernel=args.use_kernel,
                        mesh=make_mesh((args.devices,), ("data",), devices=devices))
    t0 = time.perf_counter()
    for t in range(n_t):
        for lo in range(0, n_per, bpt):
            rt.ingest(t, tokens[t, lo:lo + bpt], labels[t, lo:lo + bpt])
    _sync(rt)
    ingest_s = time.perf_counter() - t0
    generator = torch.Generator(device=dev).manual_seed(3)
    losses, times = [], []
    for e in range(args.epochs):
        t0 = time.perf_counter()
        out = rt.adapt(epochs=1, batch_per_tenant=bpt, generator=generator)
        ls = np.stack([out["losses"][t][0] for t in range(n_t)], axis=-1)   # on the host
        dt = time.perf_counter() - t0
        times.append(dt)
        losses.append(ls)
        kind = "populate" if e == 0 else "cached  "
        extra = f" (+{ingest_s:.2f}s ingest)" if e == 0 else ""
        print(f"epoch {e} [{kind}] mean loss {float(np.mean(ls)):.4f} time {dt:.2f}s{extra} "
              f"({n_t / dt:.1f} tenants/s/epoch, {len(out['groups'])} group(s), {out['path']} path)")
        if on_epoch is not None:
            on_epoch(e, ls, dt)
    return {"losses": np.stack(losses), "epoch_times": times, "ingest_s": ingest_s, "devices": args.devices,
            "runtime": rt}


def _sync(rt) -> None:
    for d in set(rt.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg, sl = setup(args)
    device = torch.device(args.device)
    params, tokens, labels = make_inputs(args, cfg, device)
    print(f"arch={cfg.name} mode={sl.mode} rank={sl.rank} tenants={args.tenants} "
          f"samples/tenant={args.samples} batch/tenant={args.batch_per_tenant} seq={args.seq} "
          f"use_kernel={args.use_kernel} device={device}")
    out = run_session(args, cfg, sl, params, tokens, labels)
    if args.check_parity:
        ref = run(args, cfg, sl, params, tokens, labels)["result"]
        rt = out["runtime"]
        diff = float(np.max(np.abs(ref.losses - out["losses"])))
        adiff = max(
            float((rt.tenant(t).adapters[k].to(ref.adapters[k].device) - ref.adapters[k][t]).abs().max())
            for t in range(args.tenants) for k in ("A", "B")
        )
        print(f"parity_max_abs_diff={diff:.3e}")
        print(f"parity_adapter_diff={adiff:.3e}")
        out.update(parity_max_abs_diff=diff, parity_adapter_diff=adiff)
        # one device: bitwise; several: the groups' products run at other
        # shapes than the joint fleet's (the reference's bar, 1e-5)
        tol = 0.0 if args.devices == 1 else 1e-5
        if diff > tol or adiff > tol:
            raise SystemExit(f"session/offline parity broken: losses {diff:.3e} adapters {adiff:.3e} "
                             f"(tol {tol:.0e})")
    return out


if __name__ == "__main__":
    main()
