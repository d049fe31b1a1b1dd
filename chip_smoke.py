#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (or a few) before the last line:
  1. device: the card's name and power limit from nvidia-smi.
  2. build: the nine hand-written kernels compiled with nvcc from csrc/, one
     nvcc per source, all started together.
  3. kernels: each kernel against its plain PyTorch version on the card, with
     kernel / plain times (CUDA events, L2 flushed), the bound and, where one
     PyTorch call computes the same function, its time:
       - K5/K6 (grouped skip-sum) at the serve shape and a ragged shape;
       - K1/K2/K3 (skip-sum forward, adapter backward, int8 forward) at the
         cached-step shape (L 24, M 1024, D 2048, R 8, bf16), a ragged
         M 1000 and fp32;
       - K4 (flash attention) at the populate shape (B 8 x H 32, S 128,
         hd 64, bf16) and a gemma-2-like shape (window 512, softcap 50,
         hd 256, GQA 2:1, S 1024).
  4. serve: full-width stablelm-1.6b (24 layers, seeded random weights)
     through ``generate_grouped`` with a float and an int8 adapter pool:
     3 demo tenants plus the zero slot, 4 prompts of 128 tokens, 32 greedy
     new tokens. Each kernel's launch count must rise by 1 + 32, and the
     zero-slot row must equal row 0 of base ``generate``. A reduced config
     must give the same tokens on the card as on the CPU.
  5. trace: one float-pool call under torch.profiler, device busy share and
     the grouped skip-sum kernels' share of device time.
  6. train: the paper's loop through ``repro_torch.launch.finetune`` at full
     width (stablelm-1.6b, bf16, 64 samples, batch 8, seq 128, rank 8,
     ``--use-kernel``), modes full and int8, one populate and two cached
     epochs. K1 or K3, and K2, must launch exactly 8 times per cached epoch
     and no kernel during populate; losses finite and the cached-epoch mean
     loss falling; one cached step's adapter gradients with the kernels equal
     to the same step through the plain versions on the card. Populate and
     cached epoch times; one populate and one cached step's device time
     (CUDA events) and busy share (torch.profiler), and the cached step's
     device time split into readout loss, skip-sum kernels and AdamW.
  7. checks: a reduced float32 config fine-tunes to the same losses and
     adapters on the card (kernels) as on the CPU (plain versions); one
     full-width attention layer gives the same output with and without K4.
  8. kernels, fleet slice: K7 (packed 4-bit pool, int4 and nf4) at the serve
     shape and a ragged M 512, its zero slot bitwise K5's exact zeros; K8
     (int8 activations) and K9 (grouped backward, run twice for identical
     bits, and with an empty slot) at the fleet cached step's shape (L 24,
     M 1024, D 2048, R 8, N 4).
  9. fleet: 4 tenants x 16 samples x seq 128 through
     ``repro_torch.launch.fleet`` at full width (batch per tenant 2, rank 8,
     ``--use-kernel``), modes full and int8, one populate and two cached
     epochs: exactly 8 K5 + 8 K9 per populate epoch, 8 K5 (full) or K8 (int8)
     + 8 K9 per cached epoch, nothing else; every tenant's loss falling; one
     cached step's stacked gradients with the kernels equal to the einsum
     route's; frozen and empty slots exactly zero. Then write-back of the 4
     tenants into float, int8, int4 and nf4 pools and ``generate_grouped``
     over them plus a base row: 33 launches of the pool's kernel a call, the
     base row equal to base ``generate``, ``register_many`` equal to
     ``register``, ``rollback`` bitwise; tokens/s per pool. A reduced float32
     fleet gives the same losses and adapters on the card as on the CPU.
The kernels line {"kernels": [...]} comes next, then the last line
{"ok": true, "device": {...}}. Any failure raises and the exit code is
nonzero; without CUDA, or without the repo's ``src`` next to this file, it
exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "stablelm-1.6b"
BATCH, PROMPT, NEW, TENANTS, RANK = 4, 128, 32, 3, 8
# the train phase: the reference launcher's shape at full width
TRAIN_ARGS = ["--arch", ARCH, "--full", "--use-kernel", "--samples", "64", "--batch", "8",
              "--seq", "128", "--rank", str(RANK), "--epochs", "3"]
TRAIN_STEPS = 64 // 8
# the fleet phase: 4 tenants' cached steps fill the cached-step shape (M 1024)
FLEET_TENANTS, FLEET_SAMPLES, FLEET_BPT, FLEET_SEQ = 4, 16, 2, 128
FLEET_ARGS = ["--arch", ARCH, "--full", "--use-kernel", "--tenants", str(FLEET_TENANTS),
              "--samples", str(FLEET_SAMPLES), "--batch-per-tenant", str(FLEET_BPT), "--seq", str(FLEET_SEQ),
              "--rank", str(RANK), "--epochs", "3", "--lr", "1e-3", "--device", "cuda"]
FLEET_STEPS = FLEET_SAMPLES // FLEET_BPT
SKIP_SRC = "src/repro_torch/kernels/skip_lora/csrc"
TPU_SKIP = "src/repro/kernels/skip_lora/kernel.py"
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; fp32 (CUDA cores) and
# bf16 (dense tensor cores) operations/s.
HBM_BPS = 3.35e12
SPIN_CYCLES = 10_000_000   # ~5 ms at the H100's ~2 GHz: longer than a kernel call's host time
STEP_SPIN = 500_000_000    # ~250 ms: longer than the host time of one eager training step
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def _rel_err(got, want):
    """(max |got - want|, max |want|) in fp32."""
    return (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()


def _profile(fn):
    """Run ``fn`` once under torch.profiler -> (wall ms, {kernel name: [device ms,
    launches]}) for the work on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:   # work on the card, not the host ops that launched it
            agg = per_kernel.setdefault(ev.name, [0.0, 0])
            agg[0] += ev.time_range.elapsed_us() / 1e3
            agg[1] += 1
    return wall_ms, per_kernel


def time_ms(fn, reps: int = 20, spin: int = SPIN_CYCLES) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around each call, the
    50 MB L2 flushed before it (on the serve path the backbone's weights
    stream through L2 between two skip-sum calls), and the stream held by a
    spin kernel while the host enqueues the call, so Python time between
    launches does not count as device time."""
    import torch

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


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _case(torch, dtype, m_rows, groups, seed, int8):
    """Inputs at L=24, D=2048, R=8, N=4: x (L, M, D), a pool and (M,) slots
    with the given group sizes, rows shuffled."""
    from repro_torch.core.lm_skiplora import quantize_int8

    g = torch.Generator(device="cuda").manual_seed(seed)
    lnum, d, r, n = 24, 2048, RANK, 4
    x = torch.randn((lnum, m_rows, d), generator=g, device="cuda").to(dtype)
    a = torch.randn((n, lnum, d, r), generator=g, device="cuda") / d**0.5
    b = torch.randn((n, lnum, r, d), generator=g, device="cuda") * 0.02
    a[0] = 0
    b[0] = 0
    idx = torch.cat([torch.full((c,), s, dtype=torch.int32, device="cuda") for s, c in enumerate(groups)])
    idx = idx[torch.randperm(m_rows, generator=g, device="cuda")]
    if int8:
        qa, sa = quantize_int8(a)
        qb, sb = quantize_int8(b)
        return x, (qa, sa, qb, sb), idx
    return x, (a, b), idx


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(x, pool, idx, out):
    """Least time for the work: bytes (x read once, each active slot's
    adapter blocks read once, out written once) over HBM bandwidth, against
    the multiply-adds (2 * M * L * R * 2D) over the input type's peak."""
    active = idx.unique().numel()
    n = pool[0].shape[0]
    pool_bytes = _nbytes(*pool) * active // n
    nbytes = _nbytes(x, out) + pool_bytes
    lnum, m, d = x.shape
    r = pool[0].shape[-1]
    ops = 2 * m * lnum * r * 2 * d
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[str(x.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes", nbytes) if t_bytes >= t_ops else (t_ops, "operations", nbytes)


def kernel_phase(torch):
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops, ref as R

    specs = {
        "grouped_skip_sum_fwd": dict(int8=False, replaces="src/repro/kernels/skip_lora/kernel.py:204"),
        "grouped_skip_sum_fwd_int8": dict(int8=True, replaces="src/repro/kernels/skip_lora/kernel.py:261"),
    }
    results = {}
    for name, spec in specs.items():
        int8 = spec["int8"]
        for label, m_rows, groups in (("serve", 4, (1, 1, 1, 1)), ("ragged", 512, (37, 300, 5, 170))):
            for dtype in (torch.bfloat16, torch.float32):
                x, pool, idx = _case(torch, dtype, m_rows, groups, seed=7, int8=int8)
                row_src, tile_slot = ops._plan(idx, pool[0].shape[0], m_rows, ops.TM)
                launch = K.grouped_skip_sum_fwd_int8 if int8 else K.grouped_skip_sum_fwd
                wrapper = ops.skip_lora_grouped_int8 if int8 else ops.skip_lora_grouped
                plain = R.skip_lora_grouped_int8_ref if int8 else R.skip_lora_grouped_ref
                got = launch(x, *pool, row_src, tile_slot, ops.TM)
                got_w = wrapper(x[:, :, None], *pool, idx)[:, 0]
                want = plain(x, *pool, idx)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), f"{name} {label} {dtype}: non-finite output")
                check(torch.equal(got, got_w), f"{name} {label} {dtype}: wrapper != kernel launch")
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                # bf16: the two sum in different orders, so z and out may
                # round one bf16 ulp apart -> 2 ulps of the largest output.
                # fp32: order-of-summation noise over D = 2048 products.
                tol = (2.0**-7 if dtype == torch.bfloat16 else 1e-5) * scale
                check(err <= tol, f"{name} {label} {dtype}: max |kernel - plain| {err:.3e} > {tol:.3e}")
                k_ms = time_ms(lambda: launch(x, *pool, row_src, tile_slot, ops.TM))
                w_ms = time_ms(lambda: wrapper(x[:, :, None], *pool, idx))
                p_ms = time_ms(lambda: plain(x, *pool, idx), reps=5)
                bound_ms, bound_by, nbytes = _bound(x, pool, idx, got)
                print(f"kernel {name} {label} M={m_rows} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e}) kernel {k_ms * 1e3:.1f} us, wrapper {w_ms * 1e3:.1f} us, "
                      f"plain {p_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B)")
                if label == "serve" and dtype == torch.bfloat16:
                    results[name] = {
                        "name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/skip_lora/csrc/{K.SOURCES[name]}",
                        "replaces": spec["replaces"], "launches": None,
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": bound_ms, "bound_us": bound_ms * 1e3, "bound_by": bound_by,
                        "library_ms": None,
                        "wrapper_ms": w_ms, "bound_bytes": nbytes,
                        "shape": f"L=24 M={m_rows} D=2048 R={RANK} N=4 bf16",
                    }
    return results


# ---------------------------------------------------------------------------
# Phase 4: the serve path
# ---------------------------------------------------------------------------


def serve_phase(torch, device_name):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.runtime import generate, generate_grouped
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.launch.serve import demo_pool
    from repro_torch.models.lm import init_lm

    dev = torch.device("cuda")

    # A small input first: the card (kernels) and the CPU (plain versions)
    # must give the same greedy tokens on a reduced float32 config.
    small = reduce_config(get_config(ARCH))
    params = init_lm(torch.Generator().manual_seed(0), small)
    pool = demo_pool(small, TENANTS, RANK, None, "cpu")
    idx = pool.lookup([None, "tenant-0", "tenant-1", "tenant-2"])
    prompts = torch.randint(0, small.vocab_size, (BATCH, 16), generator=torch.Generator().manual_seed(3))
    toks = {}
    for where in ("cpu", "cuda"):
        toks[where] = generate_grouped(
            _to(params, where), small, prompts.to(where), _to(pool.pools(), where), idx.to(where),
            max_new=8, device=where,
        ).cpu()
    check(torch.equal(toks["cpu"], toks["cuda"]), f"reduced {ARCH}: card tokens {toks['cuda'].tolist()} "
          f"!= CPU tokens {toks['cpu'].tolist()}")
    print(f"serve small: reduced {ARCH} greedy tokens equal on card and CPU")

    cfg = get_config(ARCH)
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    tenants = [None] + [f"tenant-{i % TENANTS}" for i in range(1, BATCH)]
    base = generate(params, cfg, prompts, max_new=NEW, device=dev)
    launches, pools = {}, {}
    for compress, kname in ((None, "grouped_skip_sum_fwd"), ("int8", "grouped_skip_sum_fwd_int8")):
        pool = pools[compress] = demo_pool(cfg, TENANTS, RANK, compress, dev)
        idx = pool.lookup(tenants)
        generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, device=dev)  # warm-up
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        out = generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        launches[kname] = counts[kname]
        check(counts[kname] >= 1 + NEW, f"{kname}: {counts[kname]} launches < {1 + NEW}")
        check(tuple(out.shape) == (BATCH, NEW), f"tokens shape {tuple(out.shape)}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids out of range")
        check(torch.equal(out[0], base[0]), f"pool {compress}: zero-slot row {out[0].tolist()} "
              f"!= base row {base[0].tolist()}")
        check(not torch.equal(out[1:], base[1:]), f"pool {compress}: adapters changed no token")
        print(f"serve {ARCH} full width, pool={compress or 'float'}: {BATCH}x{PROMPT} prompt + {NEW} new "
              f"in {dt:.3f} s = {BATCH * NEW / dt:.1f} tok/s on {device_name}; launches {counts}; "
              f"zero-slot row == base generate")
    trace_phase(torch, device_name, cfg, params, prompts, pools[None], pools[None].lookup(tenants))
    return launches


def trace_phase(torch, device_name, cfg, params, prompts, pool, idx):
    """One float-pool ``generate_grouped`` call under ``torch.profiler``:
    device kernel time against the host clock, and the share of the grouped
    skip-sum kernels. Reports "not measured" if the profiler saw no device
    time."""
    from repro_torch.core.runtime import generate_grouped

    dev = torch.device("cuda")
    wall_ms, per_kernel = _profile(
        lambda: generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, device=dev))
    busy = sum(t for t, _ in per_kernel.values())
    if not busy:
        print("trace: device time not measured (the profiler recorded no device activity)")
        return
    phase = {p: sum(t for k, (t, _) in per_kernel.items() if p in k) for p in ("project_a", "project_b")}
    skip = sum(phase.values())
    top = "; ".join(f"{k[:50]} x{c} {t:.2f} ms"
                    for k, (t, c) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6])
    print(f"trace {ARCH} float pool, one generate_grouped call on {device_name}: wall {wall_ms:.1f} ms "
          f"(profiled), device kernels {busy:.1f} ms = {100 * busy / wall_ms:.1f}% busy, "
          f"grouped skip-sum kernels {skip:.2f} ms = {100 * skip / busy:.2f}% of device time "
          f"(phase 1 {phase['project_a']:.2f} ms, phase 2 {phase['project_b']:.2f} ms over {1 + NEW} calls); "
          f"top: {top}")


def _bound_ms(nbytes, ops, dtype_name):
    """Least time for the work: bytes over HBM bandwidth against operations
    over the peak of the input type -> (ms, "bytes" | "operations")."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _entry(name, source, replaces, err, k_ms, p_ms, bound, nbytes, lib_ms, shape, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound[0], "bound_us": bound[0] * 1e3, "bound_by": bound[1],
            "bound_bytes": nbytes, "library_ms": lib_ms, "shape": shape, **extra}


# ---------------------------------------------------------------------------
# Phase 3b: K1, K2, K3 (one adapter stack over all rows)
# ---------------------------------------------------------------------------


def fused_kernel_phase(torch):
    """K1/K2/K3 against their plain versions at the cached step's shape
    (L 24, M 1024, D 2048, R 8, fp32 adapters), a ragged M and fp32 (K1
    and K2: K3's input is an int8 payload in every case). The
    plain versions are two (K1, K3) or four (K2) cuBLAS products through
    einsum: no single PyTorch call computes these functions, so there is no
    library time."""
    from repro_torch.core.lm_skiplora import quantize_int8
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops, ref as R

    lnum, d, r = 24, 2048, RANK
    results = {}
    for label, m, dtype in (("cached-step", 1024, torch.bfloat16), ("ragged", 1000, torch.bfloat16),
                            ("fp32", 1024, torch.float32)):
        g = torch.Generator(device="cuda").manual_seed(11)
        x = torch.randn((lnum, m, d), generator=g, device="cuda").to(dtype)
        a = torch.randn((lnum, d, r), generator=g, device="cuda") / d**0.5
        b = torch.randn((lnum, r, d), generator=g, device="cuda") * 0.02
        gr = torch.randn((m, d), generator=g, device="cuda").to(dtype)
        q, s = quantize_int8(x)
        dname = str(dtype).split(".")[-1]
        bf16 = dtype == torch.bfloat16
        mm = 2 * lnum * m * d * r   # operations of one (L, M, D) x (D, R) product
        cases = {
            "skip_lora_fwd": dict(
                run=lambda: K.skip_lora_fwd(x, a, b), plain=lambda: R.skip_lora_fwd_ref(x, a, b),
                nbytes=_nbytes(x, a, b) + m * d * x.element_size(), ops=2 * mm, dt=dname,
                tol=2.0**-7 if bf16 else 1e-5, replaces=f"{TPU_SKIP}:100"),
            "skip_lora_bwd": dict(
                run=lambda: K.skip_lora_bwd(x, a, b, gr), plain=lambda: R.skip_lora_bwd_ref(x, a, b, gr),
                nbytes=_nbytes(x, gr, a, b) + 2 * lnum * d * r * 4, ops=4 * mm, dt=dname,
                tol=2.0**-6 if bf16 else 1e-5, replaces=f"{TPU_SKIP}:149"),
            "skip_lora_fwd_int8": dict(
                run=lambda: K.skip_lora_fwd_int8(q, s, a, b), plain=lambda: R.skip_lora_int8_fwd_ref(q, s, a, b),
                nbytes=_nbytes(q, s, a, b) + m * d * 2, ops=2 * mm, dt="bfloat16",
                tol=2.0**-7, replaces=f"{TPU_SKIP}:536"),
        }
        if not bf16:   # K3 takes an int8 payload and gives bf16 whatever x was: the cached-step case
            del cases["skip_lora_fwd_int8"]
        # the autograd wrappers launch the same kernels
        a_w, b_w = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        out_w = ops.skip_lora_fused(x[:, :, None], a_w, b_w)[:, 0]
        (out_w.float() * gr.float()).sum().backward()
        check(torch.equal(out_w, K.skip_lora_fwd(x, a, b)), f"K1 {label}: wrapper != kernel launch")
        check(torch.equal(a_w.grad, K.skip_lora_bwd(x, a, b, gr)[0]), f"K2 {label}: wrapper != kernel launch")
        for name, c in cases.items():
            got, want = c["run"](), c["plain"]()
            torch.cuda.synchronize()
            gots = got if isinstance(got, tuple) else (got,)
            wants = want if isinstance(want, tuple) else (want,)
            errs = []
            for gt, wt in zip(gots, wants):
                check(bool(torch.isfinite(gt).all()), f"{name} {label}: non-finite output")
                err, scale = _rel_err(gt, wt)
                check(err <= c["tol"] * scale, f"{name} {label}: max |kernel - plain| {err:.3e} > "
                      f"{c['tol'] * scale:.3e}")
                errs.append(err)
            err = max(errs)
            if name == "skip_lora_bwd":
                again = K.skip_lora_bwd(x, a, b, gr)
                check(all(torch.equal(u, v) for u, v in zip(got, again)), f"K2 {label}: not deterministic")
            k_ms = time_ms(c["run"])
            p_ms = time_ms(c["plain"], reps=5)
            bound = _bound_ms(c["nbytes"], c["ops"], c["dt"])
            if label == "cached-step":   # device time of each pass of the kernel
                c["run"]()
                torch.cuda.synchronize()
                passes = "; ".join(f"{k.split('<')[0].split('(')[0].split()[-1]} x{n} {t * 1e3:.1f} us"
                                   for k, (t, n) in _profile(c["run"])[1].items())
                print(f"kernel {name} {label} passes (profiler): {passes}")
            print(f"kernel {name} {label} L={lnum} M={m} D={d} R={r} {dname}: max_abs_err {err:.3e} "
                  f"(tol {c['tol']:.1e} x max) kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us "
                  f"(cuBLAS products via einsum), bound {bound[0] * 1e3:.2f} us ({bound[1]}, "
                  f"{c['nbytes']} B, {c['ops']} ops)")
            if label == "cached-step":
                results[name] = _entry(name, f"{SKIP_SRC}/{K.SOURCES[name]}", c["replaces"], err, k_ms, p_ms,
                                       bound, c["nbytes"], None, f"L={lnum} M={m} D={d} R={r} {dname}")
        del x, q, gr
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 3c: K4 (flash attention)
# ---------------------------------------------------------------------------


def _attn_pairs(s, window):
    """(query, key) pairs the causal (windowed) mask keeps in one head."""
    return sum(min(i + 1, window) if window > 0 else i + 1 for i in range(s))


def flash_phase(torch):
    """K4 against its plain version at the populate shape and a gemma-2-like
    shape; the library yardstick is ``F.scaled_dot_product_attention`` with
    a boolean mask, on the shape without softcap (it has none)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ops as FO
    from repro_torch.kernels.flash_attn import ref as FR

    results = {}
    cases = [  # label, b, h, hkv, s, hd, window, softcap, dtype
        ("populate", 8, 32, 32, 128, 64, 0, 0.0, torch.bfloat16),
        ("populate", 8, 32, 32, 128, 64, 0, 0.0, torch.float32),
        ("gemma2-like", 1, 16, 8, 1024, 256, 512, 50.0, torch.bfloat16),
    ]
    for label, b, h, hkv, s, hd, window, cap, dtype in cases:
        g = torch.Generator(device="cuda").manual_seed(13)
        q = torch.randn((b, h, s, hd), generator=g, device="cuda").to(dtype)
        k = torch.randn((b, hkv, s, hd), generator=g, device="cuda").to(dtype)
        v = torch.randn((b, hkv, s, hd), generator=g, device="cuda").to(dtype)
        scale = hd**-0.5
        run = lambda: FK.flash_attn_fwd(q, k, v, window=window, softcap=cap, scale=scale)  # noqa: E731
        plain = lambda: FR.flash_attention_ref(q, k, v, window=window, softcap=cap, scale=scale)  # noqa: E731
        got, want = run(), plain()
        check(torch.equal(got, FO.flash_attention(q, k, v, window=window, softcap=cap, scale=scale)),
              f"K4 {label}: wrapper != kernel launch")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K4 {label}: non-finite output")
        err, mag = _rel_err(got, want)
        # bf16: probabilities round to bf16 before the value product here,
        # after normalisation in the plain version -> 4 ulps of the largest output
        tol = (2.0**-6 if dtype == torch.bfloat16 else 1e-5) * mag
        check(err <= tol, f"K4 {label} {dtype}: max |kernel - plain| {err:.3e} > {tol:.3e}")
        k_ms = time_ms(run)
        p_ms = time_ms(plain, reps=5)
        lib_ms = None
        if not cap and h == hkv:
            idx = torch.arange(s, device="cuda")
            mask = idx[None, :] <= idx[:, None]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale))
        nbytes = _nbytes(q, k, v, got)
        ops = 4 * hd * _attn_pairs(s, window) * b * h
        dname = str(dtype).split(".")[-1]
        bound = _bound_ms(nbytes, ops, dname)
        lib = f"{lib_ms * 1e3:.1f} us" if lib_ms is not None else "none (softcap / GQA)"
        print(f"kernel flash_attn_fwd {label} B={b} H={h} Hkv={hkv} S={s} hd={hd} window={window} "
              f"softcap={cap} {dname}: max_abs_err {err:.3e} (tol {tol:.3e}) kernel {k_ms * 1e3:.1f} us, "
              f"plain {p_ms * 1e3:.1f} us, library sdpa {lib}, bound {bound[0] * 1e3:.2f} us "
              f"({bound[1]}, {nbytes} B, {ops} ops)")
        if label == "populate" and dtype == torch.bfloat16:
            results["flash_attn_fwd"] = _entry(
                "flash_attn_fwd", "src/repro_torch/kernels/flash_attn/csrc/flash_attn_fwd.cu",
                "src/repro/kernels/flash_attn/kernel.py:96", err, k_ms, p_ms, bound, nbytes, lib_ms,
                f"B={b} H={h} S={s} hd={hd} {dname} causal")
    return results


# ---------------------------------------------------------------------------
# Phase 6: the training loop at full width
# ---------------------------------------------------------------------------


def _launches():
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.skip_lora import kernel as K

    return {**K.LAUNCHES, **FK.LAUNCHES}


def _reset_launches():
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.skip_lora import kernel as K

    K.reset_launches()
    FK.reset_launches()


def train_phase(torch, device_name):
    """Populate + 2 cached epochs per mode through the launcher's own
    functions; returns each kernel's launches over the phase's epochs."""
    from repro_torch.launch import finetune as FT

    totals = {"skip_lora_fwd": 0, "skip_lora_bwd": 0, "skip_lora_fwd_int8": 0, "flash_attn_fwd": 0}
    for mode, fwd in (("full", "skip_lora_fwd"), ("int8", "skip_lora_fwd_int8")):
        args = FT.parse_args([*TRAIN_ARGS, "--mode", mode])
        run = FT.prepare(args)
        check(run.device.type == "cuda", f"the launcher runs on {run.device}, not the card")
        times, means = [], []
        for epoch in range(args.epochs):
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            losses = FT.run_epoch(run, epoch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts = _launches()
            want = {k: 0 for k in counts}
            if epoch > 0:
                want[fwd] = want["skip_lora_bwd"] = TRAIN_STEPS
            check(counts == want, f"train {mode} epoch {epoch}: launches {counts} != {want}")
            for k in totals:
                totals[k] += counts[k]
            check(tuple(losses.shape) == (TRAIN_STEPS,), f"losses shape {tuple(losses.shape)}")
            check(bool(torch.isfinite(losses).all()), f"train {mode} epoch {epoch}: non-finite loss")
            means.append(float(losses.mean()))
        check(means[2] < means[1], f"train {mode}: cached-epoch mean loss did not fall: {means}")
        speedup = times[0] / (sum(times[1:]) / 2)
        print(f"train {ARCH} full width mode={mode} --use-kernel on {device_name}: 64 samples, batch 8, "
              f"seq 128, rank {RANK}: populate epoch {times[0]:.3f} s, cached epochs {times[1]:.3f} / "
              f"{times[2]:.3f} s, cached-epoch speedup {speedup:.2f}x; mean losses "
              f"{' / '.join(f'{v:.4f}' for v in means)}; launches per cached epoch: {fwd} {TRAIN_STEPS}, "
              f"skip_lora_bwd {TRAIN_STEPS}; during populate: none")
        _grad_check(torch, run, mode)
        if mode == "full":
            _step_split(torch, run, device_name)
        del run
        torch.cuda.empty_cache()
    return totals


def _batch_vals(run):
    from repro_torch.core.skip_cache import cache_read
    from repro_torch.launch import finetune as FT

    idx = FT.epoch_index_matrix(1, run.args.samples, run.args.batch, run.device)[0]
    return idx, cache_read(run.cache, idx)


def _grad_check(torch, run, mode):
    """One cached step's adapter gradients on the card: the kernels (K1 or
    K3, and K2) against the same step with ``use_fused_kernel`` off, the
    reference's einsum route, which autograd differentiates in plain
    PyTorch. Tolerance 2^-6 of the largest gradient: z and gz round to bf16
    in both, one ulp apart at most, and one such element moves a whole sum
    over M; the einsum route also rounds each gradient to bf16."""
    import dataclasses

    from repro_torch.core import lm_skiplora as SL
    from repro_torch.models.lm import model_dtype

    _, vals = _batch_vals(run)
    dtype = model_dtype(run.cfg)

    def grads(sl):
        return SL.value_and_grad(
            lambda t: (SL.cached_loss_fn(run.params, run.cfg, sl, SL.merge_adapters(t, run.static),
                                         vals, dtype), None), run.trainable)

    check(run.sl.use_fused_kernel, f"train {mode}: the launcher did not turn the kernels on")
    loss_k, _, got = grads(run.sl)
    loss_p, _, want = grads(dataclasses.replace(run.sl, use_fused_kernel=False))
    msg = []
    for k in want:
        err, mag = _rel_err(got[k], want[k])
        check(err <= 2.0**-6 * mag, f"train {mode}: grad {k} kernels vs plain {err:.3e} > {2.0**-6 * mag:.3e}")
        msg.append(f"{k} {err:.3e} (max {mag:.3e})")
    print(f"train {mode}: one cached step on the card, kernels vs einsum route: loss {float(loss_k):.6f} "
          f"vs {float(loss_p):.6f}, max |grad diff| {', '.join(msg)}")


def _busy(torch, fn):
    """(device ms, profiled wall ms, kernels recorded) of one call of ``fn``
    under torch.profiler, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    wall, per_kernel = _profile(fn)
    return (sum(t for t, _ in per_kernel.values()), wall, sum(n for _, n in per_kernel.values()))


def _step_split(torch, run, device_name):
    """The cached step's device time (CUDA events, L2 flushed), and its
    three parts run alone on the same inputs: readout loss forward +
    backward, skip-sum kernels K1 + K2, AdamW. What the step takes beyond
    those three is printed as a remainder: it is not timed alone. The profiler, which dropped
    kernels of later windows in earlier runs on this card, gives only the
    busy share of one cached and one populate step (device kernel time over
    profiled wall time); the populate step writes into a fresh cache."""
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.models.lm import lm_loss, model_dtype
    from repro_torch.optim.optimizers import adamw, apply_updates

    idx, vals = _batch_vals(run)
    dtype = model_dtype(run.cfg)
    opt = adamw(run.args.lr)
    step = SL.make_cached_step(run.cfg, run.sl, opt)
    h = (vals["y_base"].to(dtype)).requires_grad_(True)
    x = SL._decode_acts(vals, run.sl, dtype)
    x = x.reshape(x.shape[0], -1, x.shape[-1])
    g = torch.randn(x.shape[1:], device="cuda").to(dtype)
    grads = {k: torch.randn_like(v) for k, v in run.trainable.items()}

    def cached():
        step(run.params, run.trainable, run.static, run.opt_state, run.cache, idx)

    def readout():
        with torch.enable_grad():
            torch.autograd.grad(lm_loss(run.params, run.cfg, h, vals["labels"]), [h])

    def skip():
        K.skip_lora_fwd(x, run.trainable["A"], run.trainable["B"])
        K.skip_lora_bwd(x, run.trainable["A"], run.trainable["B"], g)

    def adam():
        updates, _ = opt.update(grads, run.opt_state, run.trainable)
        apply_updates(run.trainable, updates)

    pop_step = SL.make_populate_step(run.cfg, run.sl, opt)
    pop_cache = SL.init_lm_cache(run.args.samples, run.cfg, run.sl, run.args.seq, device=run.device)
    batch = {"tokens": run.tokens[idx], "labels": run.labels[idx]}

    def populate():
        pop_step(run.params, run.trainable, run.static, run.opt_state, pop_cache, batch, idx)

    ms = {name: time_ms(fn, reps=5, spin=STEP_SPIN) for name, fn in (
        ("step", cached), ("readout", readout), ("skip", skip), ("adamw", adam), ("populate", populate))}
    total = ms["step"]
    m, d, v = x.shape[1], x.shape[2], run.cfg.vocab_size
    tflops = 2 * 2 * m * d * v / (ms["readout"] * 1e-3) / 1e12
    rest = total - ms["readout"] - ms["skip"] - ms["adamw"]
    busy = {name: _busy(torch, fn) for name, fn in (("step", cached), ("populate", populate))}
    print(f"train steps, mode full, {ARCH} full width on {device_name}: populate step {ms['populate']:.3f} ms, "
          f"cached step {total:.3f} ms of device time (CUDA events, L2 flushed); busy share under the "
          f"profiler: populate {busy['populate'][0]:.3f} ms of device kernels in {busy['populate'][1]:.3f} ms "
          f"wall ({100 * busy['populate'][0] / busy['populate'][1]:.1f}%, {busy['populate'][2]} kernels), cached "
          f"{busy['step'][0]:.3f} ms in {busy['step'][1]:.3f} ms ({100 * busy['step'][0] / busy['step'][1]:.1f}%, "
          f"{busy['step'][2]} kernels)")
    print(f"train step split, mode full, {ARCH} full width on {device_name} (CUDA events, L2 flushed): cached "
          f"step {total:.3f} ms = readout loss {ms['readout']:.3f} ms ({100 * ms['readout'] / total:.1f}%, fp32 "
          f"vocab products at {tflops:.1f} TFLOP/s) + skip-sum kernels K1+K2 {ms['skip']:.3f} ms "
          f"({100 * ms['skip'] / total:.1f}%) + AdamW {ms['adamw']:.3f} ms ({100 * ms['adamw'] / total:.1f}%) "
          f"; remainder, not timed alone (cache gather, decode, casts): {rest:.3f} ms")


# ---------------------------------------------------------------------------
# Phase 7: card against CPU on a small config; flash against plain attention
# ---------------------------------------------------------------------------


def _run_to(run, device):
    """A launcher ``Run`` moved to ``device`` (same numbers)."""
    import dataclasses

    import torch

    st = run.opt_state
    cache = run.cache
    return dataclasses.replace(
        run, device=torch.device(device), params=_to(run.params, device), tokens=run.tokens.to(device),
        labels=run.labels.to(device), trainable=_to(run.trainable, device), static=_to(run.static, device),
        opt_state=dataclasses.replace(st, step=st.step.to(device), mu=_to(st.mu, device), nu=_to(st.nu, device)),
        cache=dataclasses.replace(cache, slots=_to(cache.slots, device), valid=cache.valid.to(device)))


def small_train_check(torch):
    """Reduced float32 stablelm-1.6b, 16 samples: the card (kernels) and the
    CPU (plain versions) give the same per-step losses (rtol 1e-4) and final
    adapters (atol 1e-4) after one populate and two cached epochs. The two
    sides sum in different orders; the int8 payload may round one count
    apart where an activation sits on a rounding boundary."""
    from repro_torch.launch import finetune as FT

    for mode in ("full", "int8"):
        args = FT.parse_args(["--arch", ARCH, "--device", "cpu", "--use-kernel", "--mode", mode,
                              "--samples", "16", "--batch", "4", "--seq", "32", "--epochs", "3"])
        cpu = FT.prepare(args)
        card = _run_to(FT.prepare(args), "cuda")
        loss_err = 0.0
        for epoch in range(args.epochs):
            lc, lg = FT.run_epoch(cpu, epoch), FT.run_epoch(card, epoch).cpu()
            check(bool(torch.isfinite(lg).all()), f"small {mode}: non-finite loss on the card")
            err = ((lg - lc).abs() / lc.abs()).max().item()
            check(err <= 1e-4, f"small {mode} epoch {epoch}: losses card {lg.tolist()} vs CPU {lc.tolist()}")
            loss_err = max(loss_err, err)
        ad_err = max((card.trainable[k].cpu() - cpu.trainable[k]).abs().max().item() for k in cpu.trainable)
        check(ad_err <= 1e-4, f"small {mode}: adapters differ by {ad_err:.3e} between card and CPU")
        print(f"train small: reduced {ARCH} float32 mode={mode} --use-kernel, populate + 2 cached epochs: "
              f"card (kernels) vs CPU (plain versions) max loss rel diff {loss_err:.3e}, "
              f"max adapter diff {ad_err:.3e}")


def attention_check(torch):
    """One full-width stablelm-1.6b attention layer (bf16, batch 8, seq 128):
    ``attn_train(use_flash=True)`` (K4) against ``use_flash=False``. Tolerance
    2^-5 of the largest output: the plain path rounds the scaled queries and
    the normalised probabilities to bf16, the kernel the unnormalised
    probabilities, and the output projection sums 2048 such values."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.models import attention as A

    cfg = get_config(ARCH)
    spec = A.AttnSpec.from_config(cfg, local=False)
    params = A.init_attn(torch.Generator(device="cuda").manual_seed(5), cfg, torch.bfloat16)
    x = torch.randn((8, 128, cfg.d_model), generator=torch.Generator(device="cuda").manual_seed(6),
                    device="cuda").to(torch.bfloat16)
    FK.reset_launches()
    got = A.attn_train(params, x, spec, use_flash=True)
    check(FK.LAUNCHES["flash_attn_fwd"] == 1, f"attn_train(use_flash=True) launched K4 {FK.LAUNCHES} times")
    want = A.attn_train(params, x, spec, use_flash=False)
    err, mag = _rel_err(got, want)
    check(err <= 2.0**-5 * mag, f"attention: flash vs plain {err:.3e} > {2.0**-5 * mag:.3e}")
    print(f"attention {ARCH} one full-width layer, bf16 8x128: attn_train use_flash=True vs False "
          f"max abs diff {err:.3e} (max |out| {mag:.3e}); K4 launched once")


# ---------------------------------------------------------------------------
# Phase 8: K7, K8, K9 against their plain versions
# ---------------------------------------------------------------------------


def _fleet_rows(torch, groups, seed):
    """Inputs at the fleet cached step's shape: x (L 24, M, D 2048) bf16, fp32
    pools of N = len(groups) slots, rank 8, (M,) slots tenant-contiguous as
    the fleet's batches are, and an upstream gradient g (M, D) bf16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lnum, d, r, n, m = 24, 2048, RANK, len(groups), sum(groups)
    x = torch.randn((lnum, m, d), generator=g, device="cuda").to(torch.bfloat16)
    a = torch.randn((n, lnum, d, r), generator=g, device="cuda") / d**0.5
    b = torch.randn((n, lnum, r, d), generator=g, device="cuda") * 0.02
    gr = torch.randn((m, d), generator=g, device="cuda").to(torch.bfloat16)
    idx = torch.cat([torch.full((c,), s, dtype=torch.int32, device="cuda") for s, c in enumerate(groups)])
    return x, a, b, gr, idx


def grouped_train_kernel_phase(torch):
    """K7 (packed 4-bit pool, int4 and nf4) at the serve shape (M 4, one row
    per slot, as each decode step has) and a ragged M 512, with the zero
    slot exact against K5 at M 4 x 128; K8 (int8 activations) and K9
    (grouped backward) at the fleet cached step's shape (L 24, M 1024 =
    4 tenants x 2 samples x 128, D 2048, R 8, N 4, bf16 rows, fp32 pools),
    K9 also with an empty slot and run twice for identical bits. No single
    PyTorch call computes any of them: no library time."""
    from repro_torch.core.lm_skiplora import quantize_int8
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops, quant as Q, ref as R

    results = {}
    for kind in Q.Q4_KINDS:
        code = Q.codebook(kind, "cuda")
        for label, m_rows, groups in (("serve", 4, (1, 1, 1, 1)), ("ragged", 512, (37, 300, 5, 170))):
            for dtype in (torch.bfloat16, torch.float32):
                x, (a, b), idx = _case(torch, dtype, m_rows, groups, seed=7, int8=False)
                pool = (*Q.quantize_q4(a, kind), *Q.quantize_q4(b, kind), code)   # qa, sa, qb, sb, code
                row_src, tile_slot = ops._plan(idx, 4, m_rows, ops.TM)
                run = lambda: K.grouped_skip_sum_fwd_q4(x, *pool, row_src, tile_slot, ops.TM)  # noqa: E731
                plain = lambda: R.skip_lora_grouped_q4_ref(x, *pool, idx)  # noqa: E731
                got, want = run(), plain()
                got_w = ops.skip_lora_grouped_q4(x[:, :, None], *pool, idx)[:, 0]
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), f"K7 {kind} {label} {dtype}: non-finite output")
                check(torch.equal(got, got_w), f"K7 {kind} {label} {dtype}: wrapper != kernel launch")
                err, mag = _rel_err(got, want)
                # bf16: z and out may round one ulp apart (sums in another order)
                tol = (2.0**-7 if dtype == torch.bfloat16 else 1e-5) * mag
                check(err <= tol, f"K7 {kind} {label} {dtype}: max |kernel - plain| {err:.3e} > {tol:.3e}")
                k_ms, p_ms = time_ms(run), time_ms(plain, reps=5)
                active = idx.unique().numel()
                nbytes = _nbytes(x, got, code) + _nbytes(*pool[:4]) * active // 4
                dname = str(dtype).split(".")[-1]
                bound = _bound_ms(nbytes, 2 * m_rows * 24 * RANK * 2 * 2048, dname)
                print(f"kernel grouped_skip_sum_fwd_q4 {kind} {label} M={m_rows} {dname}: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e}) kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, bound "
                      f"{bound[0] * 1e3:.2f} us ({bound[1]}, {nbytes} B)")
                if label == "serve" and dtype == torch.bfloat16 and kind == "int4":
                    results["grouped_skip_sum_fwd_q4"] = _entry(
                        "grouped_skip_sum_fwd_q4", f"{SKIP_SRC}/{K.SOURCES['grouped_skip_sum_fwd_q4']}",
                        f"{TPU_SKIP}:332", err, k_ms, p_ms, bound, nbytes, None,
                        f"L=24 M={m_rows} D=2048 R={RANK} N=4 int4 bf16")
    # The zero slot through a 4-bit pool: exact zeros, the same bits as K5's.
    x, (a, b), idx = _case(torch, torch.bfloat16, 512, (128, 128, 128, 128), seed=8, int8=False)
    k5 = ops.skip_lora_grouped(x[:, :, None], a, b, idx)[:, 0]
    zero = idx == 0
    for kind in Q.Q4_KINDS:
        k7 = ops.skip_lora_grouped_q4(x[:, :, None], *Q.quantize_q4(a, kind), *Q.quantize_q4(b, kind),
                                      Q.codebook(kind, "cuda"), idx)[:, 0]
        check(torch.equal(k7[zero], k5[zero]) and not k7[zero].any(),
              f"K7 {kind}: zero-slot rows are not K5's exact zeros")
    print("kernel grouped_skip_sum_fwd_q4 zero slot, M=4x128 bf16: int4 and nf4 rows of slot 0 are exact "
          "zeros, bitwise K5's")

    x, a, b, gr, idx = _fleet_rows(torch, (256, 256, 256, 256), seed=9)
    m, lnum, d = x.shape[1], x.shape[0], x.shape[2]
    mm = 2 * lnum * m * d * RANK     # operations of one (L, M, D) x (D, R) product
    q, s = quantize_int8(x)
    row_src, tile_slot = ops._plan(idx, 4, m, ops.TM)
    cases = {
        "grouped_skip_sum_fwd_actint8": dict(
            run=lambda: K.grouped_skip_sum_fwd_actint8(q, s, a, b, row_src, tile_slot, ops.TM),
            plain=lambda: R.skip_lora_grouped_actint8_ref(q, s, a, b, idx),
            nbytes=_nbytes(q, s, a, b) + m * d * 2, ops=2 * mm, tol=2.0**-7, replaces=f"{TPU_SKIP}:395"),
        "grouped_skip_sum_bwd": dict(
            run=lambda: K.grouped_skip_sum_bwd(x, a, b, gr, row_src, tile_slot, ops.TM),
            plain=lambda: R.skip_lora_grouped_bwd_ref(x, a, b, gr, idx),
            nbytes=_nbytes(x, gr, a, b) + _nbytes(a, b), ops=4 * mm, tol=2.0**-6,
            replaces=f"{TPU_SKIP}:471"),
    }
    for name, c in cases.items():
        got, want = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        errs = []
        for gt, wt in zip(gots, wants):
            check(bool(torch.isfinite(gt).all()), f"{name}: non-finite output")
            err, mag = _rel_err(gt, wt)
            check(err <= c["tol"] * mag, f"{name}: max |kernel - plain| {err:.3e} > {c['tol'] * mag:.3e}")
            errs.append(err)
        if name == "grouped_skip_sum_bwd":
            again = c["run"]()
            check(all(torch.equal(u, v) for u, v in zip(got, again)), "K9: not the same bits on a second run")
            passes = "; ".join(f"{k.split('<')[0].split('(')[0].split()[-1]} x{n} {t * 1e3:.1f} us"
                               for k, (t, n) in _profile(c["run"])[1].items())
            print(f"kernel {name} fleet passes (profiler): {passes}")
        k_ms, p_ms = time_ms(c["run"]), time_ms(c["plain"], reps=5)
        bound = _bound_ms(c["nbytes"], c["ops"], "bfloat16")
        print(f"kernel {name} fleet L={lnum} M={m} D={d} R={RANK} N=4 bf16 rows, fp32 pools: max_abs_err "
              f"{max(errs):.3e} (tol {c['tol']:.1e} x max) kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, "
              f"bound {bound[0] * 1e3:.2f} us ({bound[1]}, {c['nbytes']} B, {c['ops']} ops)")
        results[name] = _entry(name, f"{SKIP_SRC}/{K.SOURCES[name]}", c["replaces"], max(errs), k_ms, p_ms,
                               bound, c["nbytes"], None, f"L={lnum} M={m} D={d} R={RANK} N=4 bf16, fp32 pools")
    # K9 with an empty slot and ragged groups: the empty slot's grads are zeros
    x, a, b, gr, idx = _fleet_rows(torch, (300, 0, 200, 524), seed=10)
    row_src, tile_slot = ops._plan(idx, 4, x.shape[1], ops.TM)
    ga, gb = K.grouped_skip_sum_bwd(x, a, b, gr, row_src, tile_slot, ops.TM)
    wa, wb = R.skip_lora_grouped_bwd_ref(x, a, b, gr, idx)
    for gt, wt in ((ga, wa), (gb, wb)):
        err, mag = _rel_err(gt, wt)
        check(err <= 2.0**-6 * mag, f"K9 ragged: max |kernel - plain| {err:.3e} > {2.0**-6 * mag:.3e}")
    check(not ga[1].any() and not gb[1].any(), "K9: an empty slot got a nonzero gradient")
    print("kernel grouped_skip_sum_bwd ragged groups (300, 0, 200, 524): within 2^-6 of the plain version, "
          "the empty slot exactly zero")
    del x, q, gr, a, b
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 9: fleet fine-tuning at full width, write-back, serving from every pool
# ---------------------------------------------------------------------------


def fleet_phase(torch, device_name):
    """4 tenants x 16 samples x seq 128 through ``repro_torch.launch.fleet``'s
    own functions (batch per tenant 2, rank 8, AdamW lr 1e-3, fp32 cache,
    ``--use-kernel``), modes full and int8: one populate and two cached
    epochs, exact launch counts per epoch, every tenant's loss falling, one
    cached step's gradients against the einsum route, frozen and empty slots
    exactly zero. Returns each kernel's launches and the full-mode run (for
    write-back)."""
    from repro_torch.launch import fleet as FL

    totals = {k: 0 for k in ("grouped_skip_sum_fwd", "grouped_skip_sum_fwd_actint8", "grouped_skip_sum_bwd")}
    kept = None
    for mode, fwd in (("full", "grouped_skip_sum_fwd"), ("int8", "grouped_skip_sum_fwd_actint8")):
        args = FL.parse_args([*FLEET_ARGS, "--mode", mode])
        cfg, sl = FL.setup(args)
        dev = torch.device(args.device)
        check(dev.type == "cuda", f"the fleet launcher runs on {dev}, not the card")
        params, tokens, labels = FL.make_inputs(args, cfg, dev)

        def on_epoch(epoch, losses, seconds, fwd=fwd, mode=mode):
            torch.cuda.synchronize()
            counts = _launches()
            _reset_launches()
            want = {k: 0 for k in counts}
            want["grouped_skip_sum_fwd" if epoch == 0 else fwd] = FLEET_STEPS
            want["grouped_skip_sum_bwd"] = FLEET_STEPS
            check(counts == want, f"fleet {mode} epoch {epoch}: launches {counts} != {want}")
            for k in totals:
                totals[k] += counts[k]

        torch.cuda.synchronize()
        _reset_launches()
        out = FL.run(args, cfg, sl, params, tokens, labels, on_epoch=on_epoch)
        losses, times = out["losses"], out["epoch_times"]
        check(losses.shape == (3, FLEET_STEPS, FLEET_TENANTS), f"fleet losses shape {losses.shape}")
        check(bool(torch.isfinite(torch.as_tensor(losses)).all()), f"fleet {mode}: non-finite loss")
        means = losses.mean(axis=1)          # (epochs, tenants)
        check(bool((means[2] < means[1]).all() and (means[1] < means[0]).all()),
              f"fleet {mode}: a tenant's mean loss did not fall: {means.tolist()}")
        print(f"fleet {ARCH} full width mode={mode} --use-kernel on {device_name}: {FLEET_TENANTS} tenants x "
              f"{FLEET_SAMPLES} samples, batch/tenant {FLEET_BPT}, seq {FLEET_SEQ}, rank {RANK}: populate epoch "
              f"{times[0]:.3f} s, cached epochs {times[1]:.3f} / {times[2]:.3f} s, cached-epoch speedup "
              f"{times[0] / (sum(times[1:]) / 2):.2f}x; per-tenant mean losses by epoch "
              f"{[[round(float(v), 4) for v in row] for row in means]}; launches per epoch: populate "
              f"grouped_skip_sum_fwd {FLEET_STEPS} + grouped_skip_sum_bwd {FLEET_STEPS}, cached {fwd} "
              f"{FLEET_STEPS} + grouped_skip_sum_bwd {FLEET_STEPS}, no other kernel")
        res = out["result"]
        _fleet_grad_check(torch, cfg, sl, params, res, mode)
        if mode == "full":
            _fleet_step_split(torch, cfg, sl, params, res, device_name)
        res.cache = None
        if mode == "full":
            kept = (cfg, sl, params, res.adapters)
        del params, res, out
        torch.cuda.empty_cache()
    return totals, kept


def _fleet_grad_check(torch, cfg, sl, params, res, mode):
    """One cached fleet step's stacked gradients on the card: the kernels (K5
    or K8, and K9) against ``use_kernel=False``, the ``blocked_skip_sum``
    einsum that autograd differentiates in plain PyTorch, within 2^-6 of
    the largest gradient (z and gz round to bf16 in both, one ulp apart at
    most, and one such element moves a whole sum over a tenant's rows). Then
    a frozen slot and a slot with no rows get exactly zero gradient."""
    from repro_torch.core import fleet_finetune as FF
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.core.skip_cache import cache_read
    from repro_torch.models.lm import model_dtype

    dev = torch.device("cuda")
    dtype = model_dtype(cfg)
    idx = torch.as_tensor(FF.fleet_index_matrix(1, FLEET_TENANTS, FLEET_SAMPLES, FLEET_BPT), device=dev)[0]
    vals = cache_read(res.cache, idx)

    def grads(use_kernel, rows, freeze=None):
        return SL.value_and_grad(lambda t: FF.fleet_cached_loss(
            params, cfg, sl, t, vals, rows, FLEET_TENANTS, dtype, use_kernel=use_kernel, freeze_mask=freeze),
            res.adapters)

    rows = FF.fleet_row_tenant(FLEET_TENANTS, FLEET_BPT, device=dev)
    loss_k, _, got = grads(True, rows)
    loss_p, _, want = grads(False, rows)
    msg = []
    for k in want:
        err, mag = _rel_err(got[k], want[k])
        check(err <= 2.0**-6 * mag, f"fleet {mode}: grad {k} kernels vs einsum {err:.3e} > {2.0**-6 * mag:.3e}")
        msg.append(f"{k} {err:.3e} (max {mag:.3e})")
    # tenant 3's rows go to tenant 0, so slot 3 has none; slot 1 is frozen
    rows2 = torch.tensor([0, 0, 1, 1, 2, 2, 0, 0], dtype=torch.int32, device=dev)
    freeze = torch.tensor([False, True, False, False], device=dev)
    _, _, g2 = grads(True, rows2, freeze)
    for k, v in g2.items():
        check(not v[1].any() and not v[3].any() and bool(v[0].any() and v[2].any()),
              f"fleet {mode}: frozen / empty slot gradient {k} not exactly zero (or a live one zero)")
    print(f"fleet {mode}: one cached step on the card, kernels vs einsum route: loss {float(loss_k):.6f} vs "
          f"{float(loss_p):.6f}, max |grad diff| {', '.join(msg)}; frozen slot and empty slot: exact zeros")


def _fleet_step_split(torch, cfg, sl, params, res, device_name):
    """The fleet cached step's device time (CUDA events, L2 flushed) and
    three parts run alone on its inputs: the per-tenant readout loss forward
    + backward, the grouped kernels K5 + K9, AdamW. What the step takes
    beyond those is printed as a remainder, not timed alone."""
    from repro_torch.core import fleet_finetune as FF
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.core.skip_cache import cache_read
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops
    from repro_torch.models.lm import model_dtype
    from repro_torch.optim.optimizers import adamw, apply_updates

    dev = torch.device("cuda")
    dtype = model_dtype(cfg)
    idx = torch.as_tensor(FF.fleet_index_matrix(1, FLEET_TENANTS, FLEET_SAMPLES, FLEET_BPT), device=dev)[0]
    rows = FF.fleet_row_tenant(FLEET_TENANTS, FLEET_BPT, device=dev)
    opt = adamw(1e-3)
    state = opt.init(res.adapters)
    step = FF.make_fleet_cached_step_from_vals(cfg, sl, opt, FLEET_TENANTS)
    vals = cache_read(res.cache, idx)
    x = SL._swap01(vals["acts"], dtype)
    x = x.reshape(x.shape[0], -1, x.shape[-1])
    row_src, tile_slot = ops._plan(rows.repeat_interleave(FLEET_SEQ), FLEET_TENANTS, x.shape[1], ops.TM)
    g = torch.randn(x.shape[1:], device=dev).to(dtype)
    h = vals["y_base"].to(dtype).requires_grad_(True)
    grads = {k: torch.randn_like(v) for k, v in res.adapters.items()}
    a, b = res.adapters["A"], res.adapters["B"]

    def cached():
        step(params, res.adapters, state, cache_read(res.cache, idx), rows)

    def readout():
        with torch.enable_grad():
            per = FF.per_tenant_loss(params, cfg, h, vals["labels"], FLEET_TENANTS)
            torch.autograd.grad(per.sum(), [h])

    def skip():
        K.grouped_skip_sum_fwd(x, a, b, row_src, tile_slot, ops.TM)
        K.grouped_skip_sum_bwd(x, a, b, g, row_src, tile_slot, ops.TM)

    def adam():
        updates, _ = opt.update(grads, state, res.adapters)
        apply_updates(res.adapters, updates)

    ms = {name: time_ms(fn, reps=5, spin=STEP_SPIN) for name, fn in (
        ("step", cached), ("readout", readout), ("skip", skip), ("adamw", adam))}
    total = ms["step"]
    rest = total - ms["readout"] - ms["skip"] - ms["adamw"]
    print(f"fleet step split, mode full, {ARCH} full width on {device_name} (CUDA events, L2 flushed): cached "
          f"fleet step {total:.3f} ms = per-tenant readout loss {ms['readout']:.3f} ms "
          f"({100 * ms['readout'] / total:.1f}%) + grouped kernels K5+K9 {ms['skip']:.3f} ms "
          f"({100 * ms['skip'] / total:.1f}%) + AdamW {ms['adamw']:.3f} ms ({100 * ms['adamw'] / total:.1f}%); "
          f"remainder, not timed alone (cache gather, decode, grouping plan, casts): {rest:.3f} ms")


def fleet_serve_phase(torch, device_name, kept):
    """Write the 4 trained tenants back into float, int8, int4 and nf4 pools
    (``write_back_to_pool``: one ``register_many``) and serve them plus a
    base row with ``generate_grouped`` (prompt 128, 32 new tokens, greedy).
    Checks: the base row equals base ``generate``; the pool's kernel (K5, K6
    or K7) launches exactly 1 + 32 times a call and no other; the batched
    write equals sequential ``register``; ``rollback`` restores the previous
    payload bitwise. Returns each kernel's launches."""
    from repro_torch.core.adapter_pool import AdapterPool
    from repro_torch.core.fleet_finetune import init_fleet_adapters, write_back_to_pool
    from repro_torch.core.runtime import generate, generate_grouped

    cfg, sl, params, stacked = kept
    dev = torch.device("cuda")
    tenants = [f"tenant-{t}" for t in range(FLEET_TENANTS)]
    who = tenants + [None]
    prompts = torch.randint(0, cfg.vocab_size, (len(who), PROMPT),
                            generator=torch.Generator(device=dev).manual_seed(21), device=dev)
    base = generate(params, cfg, prompts, max_new=NEW, device=dev)
    # the adapters fleet_finetune started from (the CLI's seed 3)
    before = init_fleet_adapters(torch.Generator(device=dev).manual_seed(3), cfg, sl, FLEET_TENANTS)
    kernels = {None: "grouped_skip_sum_fwd", "int8": "grouped_skip_sum_fwd_int8",
               "int4": "grouped_skip_sum_fwd_q4", "nf4": "grouped_skip_sum_fwd_q4"}
    launches = {k: 0 for k in kernels.values()}
    for compress, kname in kernels.items():
        pool = AdapterPool(FLEET_TENANTS + 2, cfg, RANK, compress=compress, device=dev, history=1)
        pool.register_many(tenants, before)
        old = pool.slot_payload(tenants[0])
        slots = write_back_to_pool(pool, tenants, stacked)
        seq = AdapterPool(FLEET_TENANTS + 2, cfg, RANK, compress=compress, device=dev)
        seq_slots = [seq.register(t, {k: v[i] for k, v in stacked.items()}) for i, t in enumerate(tenants)]
        check(slots == seq_slots, f"pool {compress}: register_many slots {slots} != register {seq_slots}")
        for t in tenants:
            a, b = pool.slot_payload(t), seq.slot_payload(t)
            check(all(torch.equal(a[k], b[k]) for k in a), f"pool {compress}: register_many != register for {t}")
        idx = pool.lookup(who)
        generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, device=dev)   # warm-up
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        out = generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _launches()
        want = {k: 0 for k in counts}
        want[kname] = 1 + NEW
        check(counts == want, f"pool {compress}: launches {counts} != {want}")
        launches[kname] += counts[kname]
        check(tuple(out.shape) == (len(who), NEW), f"tokens shape {tuple(out.shape)}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids out of range")
        check(torch.equal(out[-1], base[-1]), f"pool {compress}: base row {out[-1].tolist()} != base generate "
              f"{base[-1].tolist()}")
        new = pool.slot_payload(tenants[0])
        pool.rollback(tenants[0])
        back = pool.slot_payload(tenants[0])
        check(all(torch.equal(back[k], old[k]) for k in old), f"pool {compress}: rollback is not bitwise")
        check(any(not torch.equal(new[k], old[k]) for k in old), f"pool {compress}: write-back changed nothing")
        print(f"fleet serve {ARCH} full width, pool={compress or 'float'} after write-back: "
              f"{len(who)}x{PROMPT} prompt + {NEW} new in {dt:.3f} s = {len(who) * NEW / dt:.1f} tok/s on "
              f"{device_name}; {kname} x{counts[kname]}; base row == base generate; register_many == register; "
              f"rollback bitwise")
        del pool, seq
    return launches


def small_fleet_check(torch):
    """Reduced float32 stablelm-1.6b, 3 tenants x 4 samples, seq 32: the card
    (kernels) and the CPU (plain versions) give the same per-tenant losses
    (rtol 1e-4) and final adapters (atol 1e-4) after one populate and two
    cached epochs, from the same initial adapters. The two sides sum in
    different orders; an int8 payload may round one count apart where an
    activation sits on a rounding boundary."""
    from repro_torch.core import fleet_finetune as FF
    from repro_torch.launch import fleet as FL

    for mode in ("full", "int8"):
        args = FL.parse_args(["--arch", ARCH, "--device", "cpu", "--use-kernel", "--mode", mode,
                              "--tenants", "3", "--samples", "4", "--batch-per-tenant", "2", "--seq", "32",
                              "--epochs", "3"])
        cfg, sl = FL.setup(args)
        params, tokens, labels = FL.make_inputs(args, cfg, torch.device("cpu"))
        init = FF.init_fleet_adapters(torch.Generator().manual_seed(3), cfg, sl, args.tenants)
        cpu = FL.run(args, cfg, sl, params, tokens, labels, adapters=init)
        card = FL.run(args, cfg, sl, _to(params, "cuda"), tokens.cuda(), labels.cuda(), adapters=_to(init, "cuda"))
        lc, lg = torch.as_tensor(cpu["losses"]), torch.as_tensor(card["losses"])
        loss_err = ((lg - lc).abs() / lc.abs()).max().item()
        check(loss_err <= 1e-4, f"small fleet {mode}: losses card {lg.tolist()} vs CPU {lc.tolist()}")
        ad = cpu["result"].adapters
        ad_err = max((card["result"].adapters[k].cpu() - ad[k]).abs().max().item() for k in ad)
        check(ad_err <= 1e-4, f"small fleet {mode}: adapters differ by {ad_err:.3e} between card and CPU")
        print(f"fleet small: reduced {ARCH} float32 mode={mode} --use-kernel, 3 tenants, populate + 2 cached "
              f"epochs: card (kernels) vs CPU (plain versions) max loss rel diff {loss_err:.3e}, max adapter "
              f"diff {ad_err:.3e}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda}, {name}, "
          f"{torch.cuda.device_count()} visible")

    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.skip_lora import kernel as K

    t0 = time.perf_counter()
    logs = build_all([(K.LIB, None), (FK.LIB, None)])
    regs = [int(v) for log in logs.values() for v in re.findall(r"Used (\d+) registers", log)]
    spills = [int(v) for log in logs.values() for v in re.findall(r"(\d+) bytes spill stores", log)]
    stack = [int(v) for log in logs.values() for v in re.findall(r"(\d+) bytes stack frame", log)]
    print(f"build: {len(logs)} kernels built with nvcc in {time.perf_counter() - t0:.1f} s; "
          f"max registers {max(regs, default=0)}, instantiations spilling {sum(s > 0 for s in spills)}, "
          f"with a stack frame {sum(s > 0 for s in stack)}")

    results = kernel_phase(torch)
    results.update(fused_kernel_phase(torch))
    results.update(flash_phase(torch))
    results.update(grouped_train_kernel_phase(torch))
    launches = serve_phase(torch, smi)
    launches.update(train_phase(torch, smi))
    small_train_check(torch)
    attention_check(torch)
    fleet_launches, kept = fleet_phase(torch, smi)
    serve_launches = fleet_serve_phase(torch, smi, kept)
    del kept
    small_fleet_check(torch)
    # each kernel's launches over every main path that runs it
    for counts in (fleet_launches, serve_launches):
        for kname, n in counts.items():
            launches[kname] = launches.get(kname, 0) + n
    for kname, n in launches.items():
        results[kname]["launches"] = n
    check(len(results) == 9, f"{len(results)} kernels in the kernels line, not 9")
    check(all(r["launches"] is not None for r in results.values()), "a kernel has no launch count")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
