#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (or a few) before the last line:
  1. device: the card's name and power limit from nvidia-smi.
  2. build: the hand-written kernels compiled with nvcc from csrc/.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the serve shapes and at one larger ragged shape, in bf16 and fp32;
     kernel / plain times and the bound; one JSON line {"kernels": [...]}.
  4. serve: full-width stablelm-1.6b (24 layers, seeded random weights)
     through ``generate_grouped`` with a float and an int8 adapter pool:
     3 demo tenants plus the zero slot, 4 prompts of 128 tokens, 32 greedy
     new tokens. Each kernel's launch count must rise by 1 + 32, and the
     zero-slot row must equal row 0 of base ``generate``. A reduced config
     must give the same tokens on the card as on the CPU.
  5. trace: one float-pool call under torch.profiler, device busy share and
     the grouped skip-sum kernels' share of device time.
The last line is {"ok": true, "device": {...}}. Any failure raises and the
exit code is nonzero; without CUDA, or without the repo's ``src`` next to
this file, it exits nonzero before printing any result.
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
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; fp32 (CUDA cores) and
# bf16 (dense tensor cores) operations/s.
HBM_BPS = 3.35e12
SPIN_CYCLES = 10_000_000   # ~5 ms at the H100's ~2 GHz: longer than any call's host time
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


def time_ms(fn, reps: int = 20) -> float:
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
        torch.cuda._sleep(SPIN_CYCLES)
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.runtime import generate_grouped

    dev = torch.device("cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:   # work on the card, not the host ops that launched it
            agg = per_kernel.setdefault(ev.name, [0.0, 0])
            agg[0] += ev.time_range.elapsed_us() / 1e3
            agg[1] += 1
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

    from repro_torch.kernels.skip_lora import kernel as K

    t0 = time.perf_counter()
    logs = K.build()
    regs = [int(v) for log in logs.values() for v in re.findall(r"Used (\d+) registers", log)]
    spills = [int(v) for log in logs.values() for v in re.findall(r"(\d+) bytes spill stores", log)]
    stack = [int(v) for log in logs.values() for v in re.findall(r"(\d+) bytes stack frame", log)]
    print(f"build: {len(logs)} kernels built with nvcc in {time.perf_counter() - t0:.1f} s; "
          f"max registers {max(regs, default=0)}, instantiations spilling {sum(s > 0 for s in spills)}, "
          f"with a stack frame {sum(s > 0 for s in stack)}")

    results = kernel_phase(torch)
    launches = serve_phase(torch, smi)
    for kname, n in launches.items():
        results[kname]["launches"] = n
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
