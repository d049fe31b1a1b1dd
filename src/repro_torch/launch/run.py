"""Interleaved continual-learning session CLI, the counterpart of
``repro.launch.run``.

One ``SessionRuntime`` processes an interleaved stream of serve, ingest and
adapt events over its adapter pool and skip-cache engine: ``serve/base``,
then each round every tenant ingests freshly "collected" samples (the
populate forward that writes its cache partition and returns logits),
``adapt/r{n}`` runs a grouped cached adapt whose write-back changes what the
next serve returns, and ``serve/mixed/r{n}`` serves the base model next to
every tenant.

  python -m repro_torch.launch.run --arch stablelm-1.6b --tenants 3 \
      --rounds 2 --samples-per-round 4 --seq 16 --gen 8 --adapt-epochs 2

Same flags as the reference's CLI, plus ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions). ``--scheduler`` serves through the
continuous-batching request scheduler; ``--control*`` turns on the control
plane; ``--hbm-mb`` bounds the cache's device tier; ``--checkpoint-dir D``
runs the stream under a ``SessionSupervisor`` (a session checkpoint at every
event boundary, a restart replays no completed event) and
``--inject-failure K`` raises inside event K on its first execution (the
crash drill). Weights are random from seed 0, prompts from seed 1; each
(round, tenant) draws its samples from its own seed, so a restarted session
regenerates the same batches. Fresh tenants draw their adapters from seed 3.

The data axis: ``--devices N`` runs the session over a data mesh of the
first N CUDA devices (with ``--device cpu``, N repeated CPU entries, the
port's form of the reference's forced host devices), ``--shards S`` fixes
the logical shard count (default N; the tenants must divide over it),
``--check-parity`` replays the same stream on a 1-device twin with the same
logical layout and exits nonzero unless adapters, adapt losses, slot tables
and serve tokens are equal bitwise (it prints ``parity OK``), and
``--elastic-devices M`` restarts the crash drill on only M devices.

The model axis: ``--mesh DxM`` runs the session over a (data, model) mesh
of D*M devices, each of the D shards' backbones split over a group of M
(``models.tp``); ``--pipeline-stages N`` (N == M, with ``--scheduler``)
runs the scheduler's admission prefill as GPipe microbatches over each
group. As in the reference, ``--use-kernel`` and ``--checkpoint-dir`` are
refused with M > 1, and ``--check-parity`` holds the 2-D session against
its 1-device twin with tokens and slot tables equal and adapters and
losses within rtol 1e-3 / atol 1e-5 (the model axis reorders partial
sums). ``--unroll N`` serves with one CUDA-graph replay for every N decode steps
on the card.

``main`` returns the metrics (the reference's names) with the live runtime
under "runtime" and, when supervised, {"restarts", "resumed_at",
"executions"} under "supervisor"; ``--json`` writes the metrics without the
runtime.
"""

from __future__ import annotations

import argparse
import json
import time


def _parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--samples-per-round", type=int, default=4)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--adapt-epochs", type=int, default=1)
    ap.add_argument("--batch-per-tenant", type=int, default=4)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--mode", default="full", choices=["full", "int8"])
    ap.add_argument("--pool-compress", choices=["int8", "int4", "nf4"], default=None)
    ap.add_argument("--control", action="store_true",
                    help="enable the adapter control plane: per-tenant shadow eval inside adapt, "
                         "regression gate on write-back, versioned slots with rollback")
    ap.add_argument("--control-threshold", type=float, default=0.0,
                    help="max tolerated held-out regression (post - pre) before the gate fires")
    ap.add_argument("--control-mode", default="reject", choices=["reject", "quarantine"],
                    help="what a gated write-back does to training state")
    ap.add_argument("--holdout-every", type=int, default=4,
                    help="every N-th ingested row per tenant is held out for shadow eval")
    ap.add_argument("--history-depth", type=int, default=2,
                    help="previous adapter versions kept per tenant for rollback")
    ap.add_argument("--use-kernel", action="store_true",
                    help="grouped CUDA kernels on the card (their plain versions on the CPU)")
    ap.add_argument("--hbm-mb", type=float, default=0.0,
                    help="cache device-tier budget in MiB; 0 = fully device-resident")
    ap.add_argument("--unroll", type=int, default=1, help="decode steps per CUDA-graph replay of a serve")
    ap.add_argument("--devices", type=int, default=1,
                    help="data-mesh devices (with --device cpu, repeated CPU entries)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="2-D (data, model) session mesh: D shards, each backbone split over M devices")
    ap.add_argument("--pipeline-stages", type=int, default=0, metavar="N",
                    help="pipeline the scheduler's admission prefill over N stages (requires --mesh DxM with "
                         "N == M and --scheduler; decode stays on the tensor-parallel path)")
    ap.add_argument("--shards", type=int, default=None,
                    help="logical shard count (default: --devices, or D with --mesh DxM)")
    ap.add_argument("--check-parity", action="store_true",
                    help="sharded session vs 1-device same-layout twin at zero tolerance (requires --devices >= 2)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="supervise the event stream with per-event session checkpoints")
    ap.add_argument("--inject-failure", type=int, default=None, metavar="K",
                    help="crash inside event K once (requires --checkpoint-dir)")
    ap.add_argument("--elastic-devices", type=int, default=None, metavar="M",
                    help="restart on only M devices after the injected failure")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve through the continuous-batching request scheduler (per-request "
                         "admission + drain) instead of pre-formed serve batches")
    ap.add_argument("--sched-chunk", type=int, default=4, help="decode steps per scheduler dispatch")
    ap.add_argument("--json", default=None, help="write metrics to this path")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _refuse(args: argparse.Namespace) -> int:
    """Exit with a message for flags that do not fit together (the
    reference's refusals). Sets ``args.devices`` from ``--mesh`` and
    returns the model-axis size M."""
    n_model = 1
    if args.mesh:
        d, _, m = args.mesh.lower().partition("x")
        try:
            args.mesh_dm = (int(d), int(m or 1))
        except ValueError:
            raise SystemExit(f"--mesh wants DxM (e.g. 2x2), got {args.mesh!r}")
        if min(args.mesh_dm) < 1:
            raise SystemExit(f"--mesh axes must be >= 1, got {args.mesh!r}")
        args.devices = args.mesh_dm[0] * args.mesh_dm[1]
        n_model = args.mesh_dm[1]
    if args.pipeline_stages:
        if args.pipeline_stages != n_model or n_model < 2:
            raise SystemExit("--pipeline-stages N repurposes the model axis as the pipeline, so N must equal M of "
                             f"--mesh DxM (got N={args.pipeline_stages}, M={n_model})")
        if not args.scheduler:
            raise SystemExit("--pipeline-stages pipelines the scheduler's admission prefill; add --scheduler")
    if n_model > 1 and args.use_kernel:
        raise SystemExit("the grouped skip-LoRA kernels do not run over a model axis; drop --use-kernel for "
                         "--mesh with M > 1")
    if n_model > 1 and args.checkpoint_dir:
        raise SystemExit("supervised restart re-meshes along the data axis only; --checkpoint-dir is not "
                         "supported with --mesh M > 1")
    if args.unroll < 1:
        raise SystemExit(f"--unroll {args.unroll} < 1")
    if args.devices < 1:
        raise SystemExit(f"--devices {args.devices} < 1")
    n_shards = _n_shards(args)
    if n_shards < 1 or args.tenants % n_shards:
        raise SystemExit(f"--tenants {args.tenants} must divide over {n_shards} shards")
    if args.check_parity and args.devices < 2:
        raise SystemExit(
            "--check-parity compares an N-device mesh against its 1-device twin (--devices >= 2); for "
            "the one-device session's bitwise bar against the offline trainer use launch/fleet.py "
            "--devices 1 --check-parity"
        )
    if args.inject_failure is not None and not args.checkpoint_dir:
        raise SystemExit("--inject-failure requires --checkpoint-dir")
    if args.elastic_devices is not None and (args.inject_failure is None or args.elastic_devices < 1):
        raise SystemExit("--elastic-devices M restarts the crash drill on M >= 1 devices: it requires "
                         "--checkpoint-dir and --inject-failure")
    return n_model


def _n_shards(args: argparse.Namespace) -> int:
    if args.shards is not None:
        return args.shards
    return args.mesh_dm[0] if args.mesh else args.devices


def mesh_devices(device: str, n: int) -> list:
    """The first ``n`` devices of the kind ``device`` names: CUDA devices in
    order (exits when there are fewer), or ``n`` repeated CPU entries."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n
    have = torch.cuda.device_count()
    if have < n:
        raise SystemExit(f"need {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def main(argv=None) -> dict:
    args = _parse_args(argv)
    n_model = _refuse(args)

    import torch

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.core.control_plane import ControlConfig
    from repro_torch.core.runtime import SessionRuntime
    from repro_torch.models.lm import init_lm
    from repro_torch.runtime.fault import SessionSupervisor, elastic_session_mesh
    from repro_torch.runtime.sharding import make_mesh

    devices = mesh_devices(args.device, args.devices)
    n_shards = _n_shards(args)
    dev = devices[0]
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    sl = SL.SkipLoRAConfig(rank=args.rank, mode=args.mode, cache_dtype="float32",
                           use_fused_kernel=args.use_kernel)
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    control_cfg = (
        ControlConfig(holdout_every=args.holdout_every, threshold=args.control_threshold,
                      mode=args.control_mode, history_depth=args.history_depth)
        if args.control else None
    )
    names = [f"tenant-{t}" for t in range(args.tenants)]

    def ints(seed: int, shape) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, cfg.vocab_size, shape, generator=g, device=dev, dtype=torch.int32)

    prompts = ints(1, (args.tenants + 1, args.prompt_len))

    def make_runtime(mesh, stages: int = 0) -> SessionRuntime:
        return SessionRuntime(
            cfg, sl, params, max_tenants=args.tenants,
            samples_per_tenant=args.rounds * args.samples_per_round, seq=args.seq, lr=args.lr,
            use_kernel=args.use_kernel, pool_compress=args.pool_compress,
            hbm_budget_bytes=(int(args.hbm_mb * 2**20) if args.hbm_mb > 0 else None),
            control=control_cfg, mesh=mesh, placement_shards=n_shards, pipeline_stages=stages,
        )

    def data_mesh(n: int):
        return make_mesh((n,), ("data",), devices=devices[:n])

    def session_mesh():
        if n_model > 1:
            return make_mesh(args.mesh_dm, ("data", "model"), devices=devices)
        return data_mesh(args.devices)

    # ---- the event stream: one closure per serve / ingest / adapt ---------
    # Per-tenant samples come from (round, tenant), not from a carried
    # generator, so a restarted session regenerates the same batches.
    def tenant_batch(rnd: int, t: int):
        seed = (2 << 32) + 2 * (rnd * args.tenants + t)
        shape = (args.samples_per_round, args.seq)
        return ints(seed, shape), ints(seed + 1, shape)

    def sched_serve(rt: SessionRuntime, who):
        """One serve event through the request scheduler: each row its own
        request, drained, the token streams stacked back into (B, gen)."""
        if rt._scheduler is None:
            rt.attach_scheduler(max_batch=args.tenants + 1, max_prompt=args.prompt_len,
                                max_new_cap=args.gen, chunk=args.sched_chunk,
                                admit_bucket=min(2, args.tenants + 1))
        reqs = [rt.enqueue_serve(t, prompts[j].cpu().numpy(), max_new=args.gen) for j, t in enumerate(who)]
        rt.drain()
        return torch.stack([torch.as_tensor(r.result()) for r in reqs])

    def serve_event(rt, who):
        if args.scheduler:
            return sched_serve(rt, who)
        return rt.serve(who, prompts, max_new=args.gen, unroll=args.unroll)

    events, labels = [], []

    def ev(label, fn):
        events.append(fn)
        labels.append(label)

    ev("serve/base", lambda rt, i: serve_event(rt, [None] * (args.tenants + 1)))
    for rnd in range(args.rounds):
        for t, name in enumerate(names):
            ev(f"ingest/{name}/r{rnd}", lambda rt, i, rnd=rnd, t=t, name=name:
               rt.ingest(name, *tenant_batch(rnd, t)))
        ev(f"adapt/r{rnd}", lambda rt, i: rt.adapt(
            names, epochs=args.adapt_epochs, batch_per_tenant=args.batch_per_tenant,
            generator=torch.Generator().manual_seed(3),
        ))
        ev(f"serve/mixed/r{rnd}", lambda rt, i: serve_event(rt, [None] + names))

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    timings: dict[str, float] = {}

    def run_stream(rt: SessionRuntime) -> dict[int, object]:
        results = {}
        for i, (fn, label) in enumerate(zip(events, labels)):
            t0 = time.perf_counter()
            out = fn(rt, i)
            sync()
            dt = time.perf_counter() - t0
            kind = label.split("/")[0]
            timings[kind] = timings.get(kind, 0.0) + dt
            print(f"{label:<24s} {dt:6.2f}s")
            results[i] = out
        return results

    supervisor = None
    t_session0 = time.perf_counter()
    if args.checkpoint_dir:
        # ---- supervised session: checkpoint / restart at event boundaries --
        fail_at = {"k": args.inject_failure}
        healthy = {"n": args.devices}
        executions = [0] * len(events)

        def boot_runtime():
            # elastic re-mesh over whatever survived: the logical shard
            # layout travels in the checkpoint, only the devices change
            return make_runtime(elastic_session_mesh(devices[:healthy["n"]]))

        def wrap(fn):
            def run_event(rt, idx):
                executions[idx] += 1
                if fail_at["k"] == idx:
                    fail_at["k"] = None   # crash once
                    if args.elastic_devices is not None:
                        healthy["n"] = args.elastic_devices   # devices lost
                    raise RuntimeError(f"injected failure in event {idx}")
                out = fn(rt, idx)
                sync()
                return out
            return run_event

        sup = SessionSupervisor(args.checkpoint_dir, save_every=1)
        rt, info = sup.run(boot_runtime, [wrap(fn) for fn in events])
        results = info["results"]
        print(f"supervised: {len(events)} events, {info['restarts']} restarts, resumed at event "
              f"{info['resumed_at']}, {len(info['results'])} executed this incarnation "
              f"(zero replay of completed events), on {len(rt.devices)} device(s) at the end")
        supervisor = {"restarts": info["restarts"], "resumed_at": info["resumed_at"], "executions": executions}
    else:
        rt = make_runtime(session_mesh(), args.pipeline_stages)
        results = run_stream(rt)
    session_s = time.perf_counter() - t_session0

    stats = rt.stats()
    # backbone bytes: one whole replica a device, or a group member's split
    bytes_total = sum(x.numel() * x.element_size() for x in _leaves(params))
    members = rt.params.members if n_model > 1 else [params]
    bytes_peak = max(sum(x.numel() * x.element_size() for x in _leaves(m)) for m in members)
    metrics = {
        **{f"time/{k}_s": v for k, v in timings.items()},
        "session/tenants_per_s": args.tenants * args.rounds / session_s,
        "session/wall_s": session_s,
        "session/devices": float(args.devices),
        "session/shards": float(rt.n_shards),
        "session/model_parallel": float(rt.model_parallel),
        "session/pipeline_stages": float(rt.pipeline_stages),
        "session/backbone_bytes_total": float(bytes_total),
        "session/backbone_bytes_per_device_peak": float(bytes_peak),
        **stats,
    }
    cm = rt.control_metrics()
    if cm is not None:
        # scalar gate counters next to the runtime counters; the per-tenant
        # ledger nests under "control"
        for k in ("accepted", "rejected", "quarantined", "rollbacks"):
            metrics[f"control/{k}"] = float(cm[k])
        metrics["control"] = cm
    if supervisor is not None:
        metrics["supervisor"] = supervisor
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"\nsession: {args.tenants} tenants x {args.rounds} rounds on {args.devices} device(s) ({where}) / "
          f"{rt.n_shards} shard(s) in {session_s:.2f}s ({metrics['session/tenants_per_s']:.2f} tenant-rounds/s)")
    for k in sorted(stats):
        print(f"  {k} = {stats[k]:.3f}")

    if args.check_parity:
        # The 1-device twin: the same logical layout and events. Placement
        # along the data axis moves no value, so everything is bitwise.
        print("\n--check-parity: replaying on the 1-device same-layout twin")
        twin = make_runtime(data_mesh(1))
        twin_results = run_stream(twin)
        # the model axis reorders partial sums: adapters and losses within a
        # tolerance there, everything else bitwise; tokens always exact
        tol = dict(rtol=1e-3, atol=1e-5) if n_model > 1 else None
        diffs = _parity_diffs(rt, twin, names, labels, results, twin_results, tol)
        metrics["parity/diffs"] = float(len(diffs))
        if diffs:
            raise SystemExit(f"sharded/twin parity broken: {diffs}")
        bar = ("tokens and slot tables exact; adapters and losses within rtol 1e-3 / atol 1e-5" if n_model > 1
               else "bitwise (adapters, losses, tokens, slot tables)")
        print(f"parity OK: {args.devices}-device session == 1-device twin, {bar}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(metrics, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    metrics["runtime"] = rt
    return metrics


def _parity_diffs(rt, twin, names, labels, results, twin_results, tol=None) -> list[str]:
    """What differs between a session and its twin: every tenant's adapters,
    each adapt event's losses (within ``tol``, allclose keywords, where
    given, else bitwise), each serve event's tokens, the slot tables."""
    import numpy as np
    import torch

    def same(x, y) -> bool:
        x, y = np.asarray(x), np.asarray(y)
        return bool(np.allclose(x, y, **tol)) if tol else bool(np.array_equal(x, y))

    diffs = []
    for name in names:
        for k in ("A", "B"):
            if not same(rt.tenant(name).adapters[k].cpu().numpy(), twin.tenant(name).adapters[k].cpu().numpy()):
                diffs.append(f"adapters[{name}][{k}]")
    for i, label in enumerate(labels):
        if i not in results:
            continue
        if label.startswith("adapt/"):
            for name in names:
                if not same(results[i]["losses"][name], twin_results[i]["losses"][name]):
                    diffs.append(f"losses[{label}][{name}]")
        if label.startswith("serve/") and not torch.equal(torch.as_tensor(results[i]).cpu(),
                                                          torch.as_tensor(twin_results[i]).cpu()):
            diffs.append(f"tokens[{label}]")
    if rt.pool.slot_table() != twin.pool.slot_table():
        diffs.append("pool slot tables")
    return diffs


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
