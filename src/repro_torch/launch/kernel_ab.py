"""Hold two trees of the port against each other on one card: the outputs of
the skip-sum kernels and K4 at the shapes ``chip_smoke.py`` runs them, the
device time of chosen kernels, and the cached training step.

    PYTHONPATH=<tree>/src python3 src/repro_torch/launch/kernel_ab.py --save OUT.pt
    python3 src/repro_torch/launch/kernel_ab.py --compare A.pt B.pt [C.pt ...]

``--save`` runs on the ``repro_torch`` that ``PYTHONPATH`` names (run the
file by its path, so one copy measures a parent checkout unpacked beside
the repo and the change alike) and writes a digest of every output (the
outputs themselves for ``KEEP``'s kernels, whose bits a change may move),
each time and the package's path into OUT. ``--compare`` prints, for the first two files, how many
outputs are the same bits and, where both kept them, the largest
difference of the others (for bf16 outputs also in bf16 ulps of the
output's largest value and of each row's: a value near zero after
cancellation carries the rounding of its row's scale); then each time in
every file, in the order
given, so a run of parent, change, change, parent on one card reads as two
pairs.

Times are device milliseconds: CUDA events around one call, the L2 flushed
and the stream held by a spin kernel before it, as ``chip_smoke.py`` times
them; a cached step's over 10 calls after a populate epoch, at full width
(stablelm-1.6b, 64 samples, batch 8, seq 128, rank 8, ``--use-kernel``).
Every input is made on the card from fixed seeds.
"""

from __future__ import annotations

import argparse
import hashlib
import sys

import torch

L, D, RANK = 24, 2048, 8
SPIN = 10_000_000        # ~5 ms at the H100's ~2 GHz
STEP_SPIN = 500_000_000  # ~250 ms: longer than one eager step's host time
DECODE, PREFILL = (1, 1, 1, 1, 1, 0), (128, 128, 128, 128, 128, 0)
KEEP = ("K1", "K3", "K6")   # kernels whose outputs are saved whole, the others as digests


def time_ms(fn, reps: int = 20, spin: int = SPIN) -> float:
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def passes(fn) -> str:
    """Device time of each kernel one call of ``fn`` launches (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per: dict[str, list] = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                agg = per.setdefault(ev.name.split("<")[0].split("(")[0].split()[-1], [0.0, 0])
                agg[0] += ev.time_range.elapsed_us()
                agg[1] += 1
        if per:
            return "; ".join(f"{k} x{n} {t:.1f} us" for k, (t, n) in per.items())
    return "not measured"


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _grouped(groups, rank, dtype, seed, lnum=L, d=D):
    g = _gen(seed)
    n, m = len(groups), sum(groups)
    x = torch.randn((lnum, m, d), generator=g, device="cuda").to(dtype)
    a = torch.randn((n, lnum, d, rank), generator=g, device="cuda") / d**0.5
    b = torch.randn((n, lnum, rank, d), generator=g, device="cuda") * 0.02
    a[0], b[0] = 0.0, 0.0
    idx = torch.cat([torch.full((c,), s, dtype=torch.int32, device="cuda") for s, c in enumerate(groups)])
    idx = idx[torch.randperm(m, generator=g, device="cuda")]
    return x, a, b, idx


def outputs() -> dict[str, torch.Tensor]:
    """Each kernel's output at its main-path shapes and a few ranks, both
    geometries of the tensor-core route forced in turn, on the CPU."""
    from repro_torch.core.lm_skiplora import quantize_int8
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops, quant as Q

    out: dict[str, torch.Tensor] = {}
    rule = K.grouped_fwd_geometry

    def both(key, fn):
        for geometry in ("few_rows", "many_rows"):
            K.grouped_fwd_geometry = lambda m, m_pad, geometry=geometry: geometry
            try:
                out[f"{key} {geometry}"] = fn().cpu()
            finally:
                K.grouped_fwd_geometry = rule

    shapes = {"decode": DECODE, "serve": (1, 1, 1, 1), "5x128": PREFILL, "fleet": (256,) * 4,
              "ragged": (300, 0, 200, 524)}
    for label, groups in shapes.items():
        for rank in (4, 8, 16, 32, 64) if label in ("decode", "fleet") else (RANK,):
            for dtype in (torch.bfloat16, torch.float32):
                x, a, b, idx = _grouped(groups, rank, dtype, seed=rank)
                row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], ops.TM)
                dn = str(dtype)[6:]
                for pd in (torch.float32, torch.bfloat16):
                    ap, bp = a.to(pd), b.to(pd)
                    both(f"K5 {label} R{rank} {dn} rows {str(pd)[6:]} pool",
                         lambda: K.grouped_skip_sum_fwd(x, ap, bp, row_src, tile_slot, ops.TM))
                p8 = (*quantize_int8(a), *quantize_int8(b))
                both(f"K6 {label} R{rank} {dn}",
                     lambda: K.grouped_skip_sum_fwd_int8(x, *p8, row_src, tile_slot, ops.TM))
                for kind in Q.Q4_KINDS:
                    p4 = (*Q.quantize_q4(a, kind), *Q.quantize_q4(b, kind), Q.codebook(kind, "cuda"))
                    both(f"K7 {kind} {label} R{rank} {dn}",
                         lambda: K.grouped_skip_sum_fwd_q4(x, *p4, row_src, tile_slot, ops.TM))
                if dtype == torch.float32 and label in ("fleet", "ragged"):
                    q, s = quantize_int8(x)
                    both(f"K8 {label} R{rank}",
                         lambda: K.grouped_skip_sum_fwd_actint8(q, s, a, b, row_src, tile_slot, ops.TM))
                if label in ("fleet", "ragged"):
                    g = torch.randn(x.shape[1:], generator=_gen(rank + 1), device="cuda").to(dtype)
                    ga, gb = K.grouped_skip_sum_bwd(x, a, b, g, row_src, tile_slot, ops.TM)
                    out[f"K9 {label} R{rank} {dn} gA"], out[f"K9 {label} R{rank} {dn} gB"] = ga.cpu(), gb.cpu()
    for m in (1024, 1000):
        for rank in (4, 8, 16, 32, 64) if m == 1024 else (RANK,):
            for dtype in (torch.bfloat16, torch.float32):
                g = _gen(11 + rank)
                x = torch.randn((L, m, D), generator=g, device="cuda").to(dtype)
                a = torch.randn((L, D, rank), generator=g, device="cuda") / D**0.5
                b = torch.randn((L, rank, D), generator=g, device="cuda") * 0.02
                gr = torch.randn((m, D), generator=g, device="cuda").to(dtype)
                dn = str(dtype)[6:]
                for wd in (torch.float32, torch.bfloat16):
                    aw, bw = a.to(wd), b.to(wd)
                    key = f"M{m} R{rank} {dn} rows {str(wd)[6:]} adapters"
                    out[f"K1 {key}"] = K.skip_lora_fwd(x, aw, bw).cpu()
                    ga, gb = K.skip_lora_bwd(x, aw, bw, gr)
                    out[f"K2 {key} gA"], out[f"K2 {key} gB"] = ga.cpu(), gb.cpu()
                    if dtype == torch.bfloat16:
                        q, s = quantize_int8(x)
                        out[f"K3 {key}"] = K.skip_lora_fwd_int8(q, s, aw, bw).cpu()
    for label, d, off in (("D200", 200, 0), ("x 6 bytes off 16", D, 3)):   # K1's plain loads
        for dtype in (torch.bfloat16, torch.float32):
            g = _gen(17)
            x = torch.randn((L, 1000, d), generator=g, device="cuda").to(dtype)
            if off:
                x = torch.empty(x.numel() + off, dtype=dtype, device="cuda")[off:].view(x.shape).copy_(x)
            a = torch.randn((L, d, RANK), generator=g, device="cuda") / d**0.5
            b = torch.randn((L, RANK, d), generator=g, device="cuda") * 0.02
            for wd in (torch.float32, torch.bfloat16):
                out[f"K1 {label} M1000 R{RANK} {str(dtype)[6:]} rows {str(wd)[6:]} adapters"] = K.skip_lora_fwd(
                    x, a.to(wd), b.to(wd)).cpu()
    for b_, h, hkv, s_, hd, window, cap, dtype in ((8, 32, 32, 128, 64, 0, 0.0, torch.bfloat16),
                                                   (8, 32, 32, 128, 64, 0, 0.0, torch.float32),
                                                   (1, 16, 8, 1024, 256, 512, 50.0, torch.bfloat16)):
        g = _gen(13)
        q = torch.randn((b_, h, s_, hd), generator=g, device="cuda").to(dtype)
        k = torch.randn((b_, hkv, s_, hd), generator=g, device="cuda").to(dtype)
        v = torch.randn((b_, hkv, s_, hd), generator=g, device="cuda").to(dtype)
        out[f"K4 S{s_} hd{hd} {str(dtype)[6:]}"] = FK.flash_attn_fwd(q, k, v, window=window, softcap=cap,
                                                                   scale=hd**-0.5).cpu()
    torch.cuda.synchronize()
    return out


def kernel_times() -> dict[str, object]:
    """K1 (bf16 and fp32 rows) and K3 at the cached step; K6 at the serve
    shape, fleet serving's decode step and 5 slots of 128 rows: device ms
    and the profiler's pass split."""
    from repro_torch.core.lm_skiplora import quantize_int8
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops

    times: dict[str, object] = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = _gen(11)
        x = torch.randn((L, 1024, D), generator=g, device="cuda").to(dtype)
        a = torch.randn((L, D, RANK), generator=g, device="cuda") / D**0.5
        b = torch.randn((L, RANK, D), generator=g, device="cuda") * 0.02
        run = lambda: K.skip_lora_fwd(x, a, b)  # noqa: E731
        key = f"K1 cached-step {str(dtype)[6:]}"
        times[f"{key} ms"], times[f"{key} passes"] = time_ms(run), passes(run)
    del x
    g = _gen(11)
    x = torch.randn((L, 1024, D), generator=g, device="cuda").to(torch.bfloat16)
    a = torch.randn((L, D, RANK), generator=g, device="cuda") / D**0.5
    b = torch.randn((L, RANK, D), generator=g, device="cuda") * 0.02
    q, s = quantize_int8(x)
    run = lambda: K.skip_lora_fwd_int8(q, s, a, b)  # noqa: E731
    times["K3 cached-step ms"], times["K3 cached-step passes"] = time_ms(run), passes(run)
    for label, groups in (("serve", (1, 1, 1, 1)), ("decode", DECODE), ("5x128", PREFILL)):
        for dtype in (torch.bfloat16, torch.float32):
            x, a, b, idx = _grouped(groups, RANK, dtype, seed=7)
            pool = (*quantize_int8(a), *quantize_int8(b))
            row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], ops.TM)
            run = lambda: K.grouped_skip_sum_fwd_int8(x, *pool, row_src, tile_slot, ops.TM)  # noqa: E731
            key = f"K6 {label} {str(dtype)[6:]}"
            times[f"{key} ms"], times[f"{key} passes"] = time_ms(run), passes(run)
    return times


def step_times() -> dict[str, float]:
    """The cached training step's device ms, modes full and int8, at full
    width after a populate epoch (the launcher's own functions)."""
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.launch import finetune as FT
    from repro_torch.optim.optimizers import adamw

    times = {}
    for mode in ("full", "int8"):
        args = FT.parse_args(["--full", "--use-kernel", "--samples", "64", "--batch", "8", "--seq", "128",
                              "--rank", str(RANK), "--epochs", "2", "--mode", mode])
        run = FT.prepare(args)
        FT.run_epoch(run, 0)
        idx = FT.epoch_index_matrix(1, args.samples, args.batch, run.device)[0]
        step = SL.make_cached_step(run.cfg, run.sl, adamw(args.lr))
        times[f"cached step {mode} ms"] = time_ms(
            lambda: step(run.params, run.trainable, run.static, run.opt_state, run.cache, idx),
            reps=10, spin=STEP_SPIN)
        del run, step
        torch.cuda.empty_cache()
    return times


def digest(t: torch.Tensor) -> str:
    return f"{t.dtype} {tuple(t.shape)} " + hashlib.sha256(t.contiguous().view(torch.uint8).numpy()).hexdigest()


def compare(files: list[str]) -> None:
    runs = [torch.load(f, weights_only=False) for f in files]
    a, b = runs[0]["digests"], runs[1]["digests"]
    same = [k for k in a if a[k] == b.get(k)]
    differ = [k for k in a if k in b and k not in same]
    print(f"bits: {len(same)} of {len(a)} outputs of {files[0]} bitwise those of {files[1]}; "
          f"missing from the second: {sorted(set(a) - set(b))}")
    kept_a, kept_b = runs[0]["kept"], runs[1]["kept"]
    for k in differ:
        if k in kept_a and k in kept_b:
            x, y = kept_a[k].float(), kept_b[k].float()
            ulps = ""
            if kept_a[k].dtype == torch.bfloat16:   # one bf16 ulp at |v| in [2^e, 2^(e+1)) is 2^(e-7)
                def ulp(v):
                    return 2.0 ** (torch.floor(torch.log2(v.clamp_min(2.0**-126))) - 7)

                d, big = (x - y).abs(), torch.maximum(x.abs(), y.abs())
                ulps = (f", {(d.max() / ulp(big.max())).item():.2f} bf16 ulps of the largest value, "
                        f"{(d / ulp(big.amax(dim=-1, keepdim=True))).max().item():.2f} of each row's largest")
            print(f"  differ: {k}: max |diff| {(x - y).abs().max().item():.3e} (max |value| "
                  f"{x.abs().max().item():.3e}){ulps}")
        else:
            print(f"  differ: {k}")
    for key in runs[0]["times"]:
        vals = [r["times"].get(key) for r in runs]
        if isinstance(vals[0], float):
            print(f"{key}: " + " / ".join(f"{v:.4f}" for v in vals))
        else:
            for f, v in zip(files, vals):
                print(f"{key} [{f}]: {v}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args(argv)
    if args.compare:
        compare(args.compare)
        return
    if not args.save:
        ap.error("give --save OUT or --compare FILES")
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch

    print(f"kernel_ab: repro_torch from {repro_torch.__file__} on {torch.cuda.get_device_name(0)}")
    outs = outputs()
    times = {**kernel_times(), **step_times()}
    for k, v in times.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    torch.save({"digests": {k: digest(v) for k, v in outs.items()},
                "kept": {k: v for k, v in outs.items() if k.split()[0] in KEEP},
                "times": times, "package": repro_torch.__file__}, args.save)
    print(f"saved {len(outs)} outputs to {args.save}")


if __name__ == "__main__":
    main()
