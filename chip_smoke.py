#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (or a few) before the last line:
  1. device: the card's name and power limit from nvidia-smi.
  2. build: the ten hand-written kernels compiled with nvcc from csrc/, one
     nvcc per source, all started together.
  3. kernels: each kernel against its plain PyTorch version on the card, with
     kernel / plain times (CUDA events, L2 flushed), the bound and, where one
     PyTorch call computes the same function, its time:
       - K5/K6 (grouped skip-sum) at the serve shape and a ragged shape, K6
         at 5 slots of 128 rows (every position of fleet serving's prompts,
         a measurement only), and K5 at the fleet step's shape
         (M 1024 in 4 slots) and ragged groups with an empty slot; K5's, K6's
         and K7's lines name the route and the geometry
         (``kernel.grouped_fwd_route``, ``kernel.grouped_fwd_geometry``), K6's
         its passes (profiler): bf16 rows on the tensor-core passes, fp32
         rows on the CUDA-core ones;
       - K1/K2/K3 (skip-sum forward, adapter backward, int8 forward) at the
         cached-step shape (L 24, M 1024, D 2048, R 8, bf16), a ragged
         M 1000 and fp32, K1 also at D 200; K1's bf16 rows and K3 on the
         tensor-core passes, K1's fp32 rows on the CUDA-core ones (profiler);
       - K4 (flash attention) at the populate shape (B 8 x H 32, S 128,
         hd 64, bf16) and a gemma-2-like shape (window 512, softcap 50,
         hd 256, GQA 2:1, S 1024);
       - K7/K8/K9 (phase 8 below) and K10 (paged KV block gather), bitwise,
         at the scheduler's reuse wave (pool (24, 128, 32, 32, 64) bf16,
         tables (2, 14)) and a ragged shape, beside ``index_select``.
  4. serve: full-width stablelm-1.6b (24 layers, seeded random weights)
     through ``generate_grouped`` (CUDA-graph replays of the decode steps,
     ``core.decode_graph``) and ``generate_loop`` (eager steps) with float,
     int8, int4 and nf4 adapter pools: 3 demo tenants plus the zero slot, 4
     prompts of 128 tokens, 32 greedy new tokens. The pool's kernel (K5, K6
     or K7) launches exactly 1 + 32 times a call either way, counted per
     launch executed (32 replays a call at unroll 1); graph tokens equal
     loop tokens; the zero-slot row equals row 0 of base ``generate``. From
     one prefill, the graph replays (``decode_scan`` at unroll 1, 3, 32)
     give the eager loop's (``decode_loop``) tokens, final caches and
     generator state bitwise, greedy and at temperature 0.8. Tokens/s both
     ways and at unroll 32 (one replay a call), and the host time a replay
     takes. A reduced config must give the same tokens on the card as on
     the CPU.
  5. trace: one float-pool graphed call and one eager-loop call under
     torch.profiler: device busy share and the grouped skip-sum kernels'
     share of device time.
  6. train: the paper's loop through ``repro_torch.launch.finetune`` at full
     width (stablelm-1.6b, bf16, 64 samples, batch 8, seq 128, rank 8,
     ``--use-kernel``), modes full and int8, one populate and two cached
     epochs. K1 or K3, and K2, must launch exactly 8 times per cached epoch
     and no kernel during populate; losses finite and the cached-epoch mean
     loss falling; one cached step's adapter gradients with the kernels equal
     to the same step through the plain versions on the card. Populate and
     cached epoch times; one populate and one cached step's device time
     (CUDA events) and busy share (torch.profiler), and the cached step's
     device time split into readout loss, K1 (K3 in mode int8), K2 and
     AdamW.
  7. checks: a reduced float32 config fine-tunes to the same losses and
     adapters on the card (kernels) as on the CPU (plain versions); one
     full-width attention layer gives the same output with and without K4.
  8. kernels, fleet slice: K7 (packed 4-bit pool, int4 and nf4) at fleet
     serving's launch shape (one row in each of 5 slots), at 5 slots of 128
     rows (every position of its prompts, a measurement) and a ragged M 512, its bf16 rows on
     the tensor-core passes (profiler), its zero slot bitwise K5's exact
     zeros; K8 (int8 activations, on the tensor-core passes) and K9 (grouped
     backward, run twice for identical bits, and with an empty slot) at the
     fleet cached step's shape (L 24, M 1024, D 2048, R 8, N 4); the device
     time of each pass of K5, K7, K8 and K9 (profiler). Then both block
     geometries of the tensor-core route timed, same bits, at the shapes the
     main paths give K5, K6, K7 and K8 and at 5 slots of 1 to 128 rows,
     beside the geometry ``kernel.grouped_fwd_geometry`` picks.
  9. fleet: 4 tenants x 16 samples x seq 128 through
     ``repro_torch.launch.fleet`` at full width (batch per tenant 2, rank 8,
     ``--use-kernel``), modes full and int8, one populate and two cached
     epochs: exactly 8 K5 + 8 K9 per populate epoch, 8 K5 (full) or K8 (int8)
     + 8 K9 per cached epoch, nothing else; every tenant's loss falling; one
     cached step's stacked gradients with the kernels equal to the einsum
     route's; frozen and empty slots exactly zero; each mode's cached step
     split into readout, K5 or K8, K9 and AdamW. Then write-back of the 4
     tenants into float, int8, int4 and nf4 pools and ``generate_grouped``
     over them plus a base row: 33 launches of the pool's kernel a call, the
     int8 and 4-bit pools' on the tensor-core passes (profiler), the
     base row equal to base ``generate``, ``register_many`` equal to
     ``register``, ``rollback`` bitwise; tokens/s per pool. A reduced float32
     fleet gives the same losses and adapters on the card as on the CPU.
 10. scheduler: full-width stablelm-1.6b in a ``SessionRuntime`` with 3
     demo tenants, the ``RequestScheduler`` on the reference's shared-prefix
     trace (8 requests, 448 shared + 64 tail tokens, 4 new, batch 4, bucket
     2, chunk 2, KV block 32), reuse on and off after a warm-up: reuse
     happens, K10 launches twice a reuse wave and K5 as the dispatch
     counters imply, no block leaks, the first reuse wave's gathered K/V
     bitwise the dense admission's live rows, temperature-0 tokens equal;
     the same replays with eager chunks (``loop=True``) give the graphed
     chunks' tokens, counters and launches bitwise;
     tokens/s both ways, the share of prefill tokens skipped, the device
     time of one reuse and one dense admission dispatch; mid-decode
     admission (3 x 128 tokens, bucket 1, 8 new) continuous vs sequential
     vs solo ``serve``. A reduced float32 scheduler with reuse gives the
     same tokens on the card as on the CPU.
 11. session: the session runtime (``SessionRuntime``) at full width on the
     fleet phase's inputs, ``use_kernel=True``: mode full over a resident
     engine (a base serve, 32 ingests of 2 rows, one K5 launch each over the
     last position; ``adapt(epochs=3)`` on the scan path, 24 K5 and 24 K9;
     a serve of the 4 tenants and a base row), whose adapters, per-step
     losses and pool slots equal the fleet phase's offline ``fleet_finetune``
     bitwise; mode full over a tiered engine holding half the rows (the
     stream path, spills, the resident run's numbers); mode int8 over an
     int8 pool (K6 at ingest and serve, K8 + K9 at adapt, every tenant's
     loss falling); one ``enqueue_ingest`` between decode dispatches equal
     to a direct ingest. Ingest rows/s and device ms, each path's adapt
     time, HBM hit rates. The checkpoint plane: the trained resident session
     saved (``save_runtime_session``: its 64 cache rows, ~1.7 GB, under
     build/), restored into a fresh runtime (``restore_runtime_session``),
     and both continuing one adapt epoch (8 K5 + 8 K9 each) and the serve
     (33 K5 each): losses, adapters, moments, pool, slot table and tokens
     bitwise; save and restore seconds and the bytes on disk. A reduced
     float32 session (a control plane, a disk host tier) gives the same
     losses, adapters, gate decisions and tokens on the card as on the CPU,
     and, saved after its first gated adapt and restored into a fresh
     runtime, bitwise the uninterrupted run's on the card; an int4 pool
     round-trips its bytes and serves the same tokens through K7. The
     session CLI's crash drill (``repro_torch.launch.run --device cuda
     --use-kernel --checkpoint-dir D --inject-failure 3``, reduced) restarts
     exactly once, at event 3, and ends bitwise the unsupervised run.
 12. paper: the source paper's own experiment (Section 5.1), which reaches
     no hand-written kernel (as in the reference; the launch counters stay
     at 0 through it): the damage1, damage2 and HAR twins
     (``data.synthetic``); Fan (256-96-96-3) and HAR (561-96-96-6)
     pre-trained 30 and 10 epochs; all eight methods fine-tuned 40 epochs
     (batch 20, lr 0.05), each epoch one CUDA-graph replay
     (``core.finetune``). Gates: damage1's accuracy below 0.5 before and
     Skip2-LoRA's above 0.8 after; every method's last loss below its
     first; Skip2-LoRA within 1e-4 of Skip-LoRA after 3 epochs; 47 of 47
     rows cached after epoch 0; graph replays bitwise the eager loop for
     every method and Skip2-LoRA's cache; a reduced 32-24-3 config equal on
     the card and the CPU within 1e-5 relative. Times (host clock,
     synchronised, medians): each method's epoch graphed and eager, a
     graphed epoch's busy share (torch.profiler), the per-batch forward /
     backward / update split, and Skip2-LoRA's time against LoRA-All's at
     the paper's epoch counts beside the cost model's FLOP reduction.
The grouped forwards' launches on these main paths are also counted by row
class where their wrappers launch them (``kernel.ROW_LAUNCHES``): a fleet
step's must take many rows, and each ``generate_grouped`` call's and each
ingest's a few (their skip-sums read each prompt's last position only).
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
# fleet serving (4 tenants and a base row in a 6-slot pool, slot 0 the zero
# slot) launches the grouped kernels at one row in each of 5 slots, in every
# decode step and in the prefill (whose skip-sum reads each prompt's last
# position only); 5 slots of 128 rows, every position of the 5 prompts, is a
# measurement of many rows that no main path launches
SERVE_PREFILL = (128, 128, 128, 128, 128, 0)
SERVE_DECODE = (1, 1, 1, 1, 1, 0)
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


def _passes(fn) -> str:
    """The device time of each kernel one call of ``fn`` launches
    (torch.profiler), namespace::name without template arguments. A
    profile that recorded no device activity at all (the profiler now and then
    misses a whole call) is taken again, up to three times."""
    for _ in range(3):
        per_kernel = _profile(fn)[1]
        if per_kernel:
            break
    return "; ".join(f"{k.split('<')[0].split('(')[0].split()[-1]} x{n} {t * 1e3:.1f} us"
                     for k, (t, n) in per_kernel.items())


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
    """Inputs at L=24, D=2048, R=8, N=len(groups): x (L, M, D), a pool whose
    slot 0 is zero and (M,) slots with the given group sizes, rows shuffled."""
    from repro_torch.core.lm_skiplora import quantize_int8

    g = torch.Generator(device="cuda").manual_seed(seed)
    lnum, d, r, n = 24, 2048, RANK, len(groups)
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
        shapes = [("serve", 4, (1, 1, 1, 1)), ("ragged", 512, (37, 300, 5, 170))]
        if int8:   # K6 at many rows, a measurement only
            shapes.append(("5x128", sum(SERVE_PREFILL), SERVE_PREFILL))
        for label, m_rows, groups in shapes:
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
                route = f", route {K.grouped_fwd_route(dtype)}"
                if route.endswith("tensor_cores"):
                    route += f", geometry {K.grouped_fwd_geometry(m_rows, row_src.numel())}"
                passes = ""
                if int8:   # K6's passes: the tensor-core ones for bf16 rows, the CUDA-core ones for fp32
                    passes = _passes(lambda: launch(x, *pool, row_src, tile_slot, ops.TM))
                    tc = "stc::project_tc" in passes and "stc::expand_tc" in passes
                    check(tc == (K.grouped_fwd_route(dtype) == "tensor_cores") and ("gss::" in passes) != tc,
                          f"{name} {label} {dtype}: passes {passes} are not its route's")
                print(f"kernel {name} {label} M={m_rows} {str(dtype)[6:]}{route}: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e}) kernel {k_ms * 1e3:.1f} us, wrapper {w_ms * 1e3:.1f} us, "
                      f"plain {p_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B)"
                      f"{f'; passes (profiler): {passes}' if passes else ''}")
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
                        "grouped_route": K.grouped_fwd_route(dtype),
                    }
                    if passes:
                        results[name]["passes"] = passes
                if label == "5x128" and dtype == torch.bfloat16:
                    results[name].update(many_rows_ms=k_ms, many_rows_plain_ms=p_ms, many_rows_bound_ms=bound_ms,
                                         many_rows_bound_by=bound_by, many_rows_bound_bytes=nbytes,
                                         many_rows_max_abs_err=err, many_rows_passes=passes,
                                         many_rows_shape=f"L=24 M={m_rows} in 5 slots of 128 D=2048 R={RANK} "
                                                         f"N=6 bf16")
    results["grouped_skip_sum_fwd"].update(k5_many_rows_phase(torch))
    return results


def k5_many_rows_phase(torch):
    """K5 at the fleet step's shape (L 24, M 1024 in 4 slots of 256 rows,
    D 2048, R 8, bf16 rows, fp32 pools), where the fleet's populate epochs
    and cached ``full`` epochs call it, and at ragged groups with an empty
    slot (300, 0, 200, 524): within 2^-7 of the largest output of the plain
    version, the route ``kernel.grouped_fwd_route`` gives, kernel and plain
    times, the byte bound and the device time of each pass (profiler).
    Returns the many-row fields of K5's entry in the kernels line."""
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops, ref as R

    fields = {}
    for label, groups in (("fleet", (256, 256, 256, 256)), ("fleet-ragged", (300, 0, 200, 524))):
        x, a, b, _, idx = _fleet_rows(torch, groups, seed=12)
        m = x.shape[1]
        row_src, tile_slot = ops._plan(idx, len(groups), m, ops.TM)
        route = K.grouped_fwd_route(x.dtype)
        run = lambda: K.grouped_skip_sum_fwd(x, a, b, row_src, tile_slot, ops.TM)  # noqa: E731
        plain = lambda: R.skip_lora_grouped_ref(x, a, b, idx)  # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K5 {label}: non-finite output")
        check(torch.equal(got, ops.skip_lora_grouped(x[:, :, None], a, b, idx)[:, 0]),
              f"K5 {label}: wrapper != kernel launch")
        err, mag = _rel_err(got, want)
        tol = 2.0**-7 * mag
        check(err <= tol, f"K5 {label}: max |kernel - plain| {err:.3e} > {tol:.3e}")
        k_ms, p_ms = time_ms(run), time_ms(plain, reps=5)
        bound_ms, bound_by, nbytes = _bound(x, (a, b), idx, got)
        passes = _passes(run)
        print(f"kernel grouped_skip_sum_fwd {label} L=24 M={m} groups {groups} D=2048 R={RANK} bf16 rows, fp32 "
              f"pools, route {route}: max_abs_err {err:.3e} (tol {tol:.3e}) kernel {k_ms * 1e3:.1f} us, plain "
              f"{p_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B); passes (profiler): "
              f"{passes}")
        if label == "fleet":
            fields = {"many_rows_ms": k_ms, "many_rows_plain_ms": p_ms, "many_rows_bound_ms": bound_ms,
                      "many_rows_bound_by": bound_by, "many_rows_bound_bytes": nbytes,
                      "many_rows_max_abs_err": err, "many_rows_route": route,
                      "many_rows_shape": f"L=24 M={m} in 4 slots D=2048 R={RANK} bf16 rows, fp32 pools"}
        del x, a, b, got, want
        torch.cuda.empty_cache()
    return fields


# ---------------------------------------------------------------------------
# Phase 4: the serve path
# ---------------------------------------------------------------------------


def serve_phase(torch, device_name):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import decode_graph as DG
    from repro_torch.core.runtime import generate, generate_grouped, generate_loop
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
    kernels = {None: "grouped_skip_sum_fwd", "int8": "grouped_skip_sum_fwd_int8",
               "int4": "grouped_skip_sum_fwd_q4", "nf4": "grouped_skip_sum_fwd_q4"}
    for compress, kname in kernels.items():
        pool = pools[compress] = demo_pool(cfg, TENANTS, RANK, compress, dev)
        idx = pool.lookup(tenants)
        generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, device=dev)  # warm-up
        timed = {}
        for path in ("graph", "loop"):
            run = generate_grouped if path == "graph" else generate_loop
            kw = {} if path == "graph" else {"pools": pool.pools(), "idx": idx}
            args = (params, cfg, prompts, pool.pools(), idx) if path == "graph" else (params, cfg, prompts)
            torch.cuda.synchronize()
            _reset_launches()
            stats0 = dict(DG.GRAPHS.stats)
            t0 = time.perf_counter()
            out = run(*args, max_new=NEW, device=dev, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            replays = DG.GRAPHS.stats["replays"] - stats0.get("replays", 0)
            replay_us = 1e6 * (DG.GRAPHS.stats["replay_s"] - stats0.get("replay_s", 0.0)) / max(replays, 1)
            counts = _launches()
            want = {k: 0 for k in counts}
            want[kname] = 1 + NEW
            check(counts == want, f"pool {compress} {path}: launches {counts} != {want}")
            check(replays == (NEW if path == "graph" else 0), f"pool {compress} {path}: {replays} replays")
            if path == "graph":
                # the prefill's skip-sum reads each prompt's last position: one row a slot, as a decode step's
                _tally_rows(kname, {"few_rows": counts[kname]})
                launches[kname] = launches.get(kname, 0) + counts[kname]
            timed[path] = (out, dt, replays, replay_us)
        out, dt, replays, replay_us = timed["graph"]
        check(tuple(out.shape) == (BATCH, NEW), f"tokens shape {tuple(out.shape)}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids out of range")
        check(torch.equal(out, timed["loop"][0]), f"pool {compress}: graph tokens {out.tolist()} != loop tokens "
              f"{timed['loop'][0].tolist()}")
        check(torch.equal(out[0], base[0]), f"pool {compress}: zero-slot row {out[0].tolist()} "
              f"!= base row {base[0].tolist()}")
        check(not torch.equal(out[1:], base[1:]), f"pool {compress}: adapters changed no token")
        bits = _graph_vs_loop(torch, cfg, params, prompts, pool, idx)
        # one replay a call: the unroll-32 graph, warm (captured by _graph_vs_loop's decode_scan at unroll 32)
        generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, unroll=NEW, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, unroll=NEW, device=dev)
        torch.cuda.synchronize()
        dt32 = time.perf_counter() - t0
        loop_dt = timed["loop"][1]
        print(f"serve {ARCH} full width, pool={compress or 'float'}: {BATCH}x{PROMPT} prompt + {NEW} new on "
              f"{device_name}: graph {dt:.3f} s = {BATCH * NEW / dt:.1f} tok/s ({replays} replays a call, "
              f"unroll 1, {replay_us:.1f} us of host time a replay), unroll {NEW} {dt32:.3f} s = "
              f"{BATCH * NEW / dt32:.1f} tok/s (1 replay a call), loop {loop_dt:.3f} s = "
              f"{BATCH * NEW / loop_dt:.1f} tok/s ({loop_dt / dt:.2f}x); "
              f"{kname} x{1 + NEW} a call both ways; graph tokens == loop tokens; zero-slot row == base "
              f"generate; {bits}")
    trace_phase(torch, device_name, cfg, params, prompts, pools[None], pools[None].lookup(tenants))
    return launches


def _graph_vs_loop(torch, cfg, params, prompts, pool, idx):
    """From one prefill: the eager loop (``decode_loop``) against graph
    replays (``decode_scan``) at unroll 1, 3 and 32, greedy and at
    temperature 0.8 with one generator seed: tokens, final caches and the
    generator's state bitwise. Returns the line's summary."""
    from repro_torch.models import lm as LM

    b, s = prompts.shape
    caches = LM.init_serve_caches(cfg, b, s + NEW, device=prompts.device)
    logits, caches = LM.serve_prefill_grouped(params, cfg, prompts, caches, pool.pools(), idx)
    tok0 = LM.sample_token(logits, 0.0)

    def fresh():
        return [{n: t.clone() for n, t in c.items()} for c in caches]

    for temp in (0.0, 0.8):
        g = torch.Generator(device=prompts.device).manual_seed(17)
        want, want_c = LM.decode_loop(params, cfg, tok0, s, fresh(), max_new=NEW, temperature=temp, generator=g,
                                      pools=pool.pools(), idx=idx)
        want_g = g.get_state()
        for unroll in (1, 3, NEW):
            g = torch.Generator(device=prompts.device).manual_seed(17)
            got, got_c = LM.decode_scan(params, cfg, tok0, s, fresh(), max_new=NEW, temperature=temp,
                                        generator=g, pools=pool.pools(), idx=idx, unroll=unroll)
            what = f"temperature {temp}, unroll {unroll}"
            check(torch.equal(got, want), f"{what}: graph tokens {got.tolist()} != loop tokens {want.tolist()}")
            check(all(torch.equal(x[n], y[n]) for x, y in zip(got_c, want_c) for n in x),
                  f"{what}: graph caches != loop caches")
            check(torch.equal(g.get_state(), want_g), f"{what}: generator state differs")
    return "graph == loop bitwise (tokens, caches, generator) at temperature 0 and 0.8, unroll 1, 3, 32"


def trace_phase(torch, device_name, cfg, params, prompts, pool, idx):
    """One float-pool ``generate_grouped`` call (graph replays) and one
    ``generate_loop`` call (eager steps) under ``torch.profiler``: device
    kernel time against the host clock, the grouped skip-sum kernels'
    share, and the host time a replay takes. Reports "not
    measured" where the profiler saw no device time."""
    from repro_torch.core import decode_graph as DG
    from repro_torch.core.runtime import generate_grouped, generate_loop

    dev = torch.device("cuda")
    calls = {
        "graph": lambda: generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, device=dev),
        "loop": lambda: generate_loop(params, cfg, prompts, pools=pool.pools(), idx=idx, max_new=NEW, device=dev),
    }
    parts = []
    for path, fn in calls.items():
        fn()   # warm: the graph call replays a cached graph
        torch.cuda.synchronize()
        stats0 = dict(DG.GRAPHS.stats)
        wall_ms, per_kernel = _profile(fn)
        replays = DG.GRAPHS.stats["replays"] - stats0.get("replays", 0)
        host_us = 1e6 * (DG.GRAPHS.stats["replay_s"] - stats0.get("replay_s", 0.0)) / max(replays, 1)
        busy = sum(t for t, _ in per_kernel.values())
        spent = (f"{replays} replays at {host_us:.1f} us of host time each under the profiler" if path == "graph"
                 else f"{NEW} eager steps, {wall_ms / NEW:.2f} ms of wall time each")
        if not busy:
            parts.append(f"{path}: wall {wall_ms:.1f} ms (profiled), device time not measured (the profiler "
                         f"recorded no device activity), {spent}")
            continue
        # K5's two passes on its bf16 (tensor-core) route
        phase = {p: sum(t for k, (t, _) in per_kernel.items() if p in k) for p in ("project_tc", "expand_tc")}
        skip = sum(phase.values())
        top = "; ".join(f"{k[:50]} x{c} {t:.2f} ms"
                        for k, (t, c) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6])
        parts.append(
            f"{path}: wall {wall_ms:.1f} ms (profiled), device kernels {busy:.1f} ms = {100 * busy / wall_ms:.1f}% "
            f"busy, {spent}; grouped skip-sum kernels {skip:.2f} ms = {100 * skip / busy:.2f}% of device time "
            f"(project_tc {phase['project_tc']:.2f} ms, expand_tc {phase['expand_tc']:.2f} ms over {1 + NEW} "
            f"calls); top: {top}")
    print(f"trace {ARCH} float pool, one call each way on {device_name}: " + " || ".join(parts))


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
    and K2: K3's input is an int8 payload in every case), and K1 at D 200
    (the plain loads). The
    plain versions are two (K1, K3) or four (K2) cuBLAS products through
    einsum: no single PyTorch call computes these functions, so there is no
    library time. K1's bf16 rows and K3 must run the tensor-core passes
    (``stc::``), K1's fp32 rows the CUDA-core ones (``ssk::``)."""
    from repro_torch.core.lm_skiplora import quantize_int8
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops, ref as R

    lnum, r = 24, RANK
    results = {}
    for label, m, d, dtype in (("cached-step", 1024, 2048, torch.bfloat16), ("ragged", 1000, 2048, torch.bfloat16),
                               ("fp32", 1024, 2048, torch.float32), ("d200", 1024, 200, torch.bfloat16)):
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
        if label == "d200":   # K1's plain loads (D not a multiple of 128 columns)
            cases = {"skip_lora_fwd": cases["skip_lora_fwd"]}
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
            passes = ""
            if label in ("cached-step", "fp32"):   # device time of each pass of the kernel
                c["run"]()
                torch.cuda.synchronize()
                passes = _passes(c["run"])
                check(passes != "", f"{name} {label}: the profiler saw no pass in three tries")
                print(f"kernel {name} {label} passes (profiler): {passes}")
            route = ""
            if name in ("skip_lora_fwd", "skip_lora_fwd_int8"):   # K5's and K8's one-slot forms
                rows = q.dtype if name == "skip_lora_fwd_int8" else x.dtype
                tc = K.grouped_fwd_route(rows) == "tensor_cores"
                route = f", route {K.grouped_fwd_route(rows)}"
                route += f", geometry {K.grouped_fwd_geometry(m, m)}" if tc else ""
                if passes:   # stc::project_tc + stc::expand_tc, or ssk::project + ssk::expand
                    ns, other = ("stc::", "ssk::") if tc else ("ssk::", "stc::")
                    check(f"{ns}project" in passes and f"{ns}expand" in passes and other not in passes,
                          f"{name} {label}: not the {K.grouped_fwd_route(rows)} passes: {passes}")
            print(f"kernel {name} {label} L={lnum} M={m} D={d} R={r} {dname}{route}: max_abs_err {err:.3e} "
                  f"(tol {c['tol']:.1e} x max) kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us "
                  f"(cuBLAS products via einsum), bound {bound[0] * 1e3:.2f} us ({bound[1]}, "
                  f"{c['nbytes']} B, {c['ops']} ops)")
            if label == "cached-step":
                results[name] = _entry(name, f"{SKIP_SRC}/{K.SOURCES[name]}", c["replaces"], err, k_ms, p_ms,
                                       bound, c["nbytes"], None, f"L={lnum} M={m} D={d} R={r} {dname}",
                                       passes=passes)
                if name in ("skip_lora_fwd", "skip_lora_fwd_int8"):
                    results[name]["grouped_route"] = K.grouped_fwd_route(q.dtype if "int8" in name else x.dtype)
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
    shape. The library yardstick is ``F.scaled_dot_product_attention``, on
    the shape without softcap or window (it has neither), called two ways:
    with a boolean causal mask (a mask keeps PyTorch off its flash backend)
    and with ``is_causal=True``; ``library_ms`` is the faster."""
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
        sdpa = {}
        has_gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
        if not cap and not window and (h == hkv or has_gqa):
            gqa = {} if h == hkv else {"enable_gqa": True}
            if h == hkv:
                idx = torch.arange(s, device="cuda")
                mask = idx[None, :] <= idx[:, None]
                sdpa["mask"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale))
            sdpa["is_causal"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale,
                                                                               **gqa))
        lib_ms = min(sdpa.values()) if sdpa else None
        nbytes = _nbytes(q, k, v, got)
        ops = 4 * hd * _attn_pairs(s, window) * b * h
        dname = str(dtype).split(".")[-1]
        bound = _bound_ms(nbytes, ops, dname)
        lib = ", ".join(f"{how} {t * 1e3:.1f} us" for how, t in sdpa.items()) or "none (softcap / window)"
        print(f"kernel flash_attn_fwd {label} B={b} H={h} Hkv={hkv} S={s} hd={hd} window={window} "
              f"softcap={cap} {dname}: max_abs_err {err:.3e} (tol {tol:.3e}) kernel {k_ms * 1e3:.1f} us, "
              f"plain {p_ms * 1e3:.1f} us, library sdpa {lib}, bound {bound[0] * 1e3:.2f} us "
              f"({bound[1]}, {nbytes} B, {ops} ops)")
        if label == "populate" and dtype == torch.bfloat16:
            results["flash_attn_fwd"] = _entry(
                "flash_attn_fwd", "src/repro_torch/kernels/flash_attn/csrc/flash_attn_fwd.cu",
                "src/repro/kernels/flash_attn/kernel.py:96", err, k_ms, p_ms, bound, nbytes, lib_ms,
                f"B={b} H={h} S={s} hd={hd} {dname} causal",
                sdpa_ms=dict(sdpa))
    return results


# ---------------------------------------------------------------------------
# Phase 6: the training loop at full width
# ---------------------------------------------------------------------------


def _launches():
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import paged as PG
    from repro_torch.kernels.skip_lora import kernel as K

    return {**K.LAUNCHES, **FK.LAUNCHES, **PG.LAUNCHES}


#: the grouped forwards' launches on the main paths by (kernel, row class),
#: as their wrappers counted them (``kernel.ROW_LAUNCHES``)
MAIN_ROWS: dict[tuple[str, str], int] = {}


def _tally_rows(kname, want):
    """Hold the launches that the grouped forwards' wrappers counted by row
    class in this main-path run against ``want`` (row class -> launches of
    ``kname``; no other grouped forward) and add them to ``MAIN_ROWS``."""
    from repro_torch.kernels.skip_lora import kernel as K

    rows = dict(K.ROW_LAUNCHES)
    want = {(kname, g): n for g, n in want.items() if n}
    check(rows == want, f"{kname}: launches by row class {rows} != {want}")
    for key, n in rows.items():
        MAIN_ROWS[key] = MAIN_ROWS.get(key, 0) + n


def _reset_launches():
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import paged as PG
    from repro_torch.kernels.skip_lora import kernel as K

    K.reset_launches()
    FK.reset_launches()
    PG.reset_launches()


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
    parts run alone on the same inputs: readout loss forward + backward,
    K1 (K3 on the int8 payload in mode int8) and K2 each, AdamW. What the
    step takes beyond those parts is
    printed as a remainder: it is not timed alone. The profiler, which dropped
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
    mode = run.args.mode
    x = SL._decode_acts(vals, run.sl, dtype)
    x = x.reshape(x.shape[0], -1, x.shape[-1])
    if mode == "int8":
        q = SL._swap01(vals["acts_q"], torch.int8).reshape(x.shape)
        s = SL._swap01(vals["acts_scale"], torch.float32).reshape(x.shape[:2])
    g = torch.randn(x.shape[1:], device="cuda").to(dtype)
    grads = {k: torch.randn_like(v) for k, v in run.trainable.items()}

    def cached():
        step(run.params, run.trainable, run.static, run.opt_state, run.cache, idx)

    def readout():
        with torch.enable_grad():
            torch.autograd.grad(lm_loss(run.params, run.cfg, h, vals["labels"]), [h])

    def k1():
        if mode == "int8":
            K.skip_lora_fwd_int8(q, s, run.trainable["A"], run.trainable["B"])
        else:
            K.skip_lora_fwd(x, run.trainable["A"], run.trainable["B"])

    def k2():
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
        ("step", cached), ("readout", readout), ("k1", k1), ("k2", k2), ("adamw", adam), ("populate", populate))}
    total = ms["step"]
    m, d, v = x.shape[1], x.shape[2], run.cfg.vocab_size
    tflops = 2 * 2 * m * d * v / (ms["readout"] * 1e-3) / 1e12
    rest = total - ms["readout"] - ms["k1"] - ms["k2"] - ms["adamw"]
    busy = {name: _busy(torch, fn) for name, fn in (("step", cached), ("populate", populate))}
    fwd = "K3" if mode == "int8" else "K1"
    print(f"train steps, mode {mode}, {ARCH} full width on {device_name}: populate step {ms['populate']:.3f} ms, "
          f"cached step {total:.3f} ms of device time (CUDA events, L2 flushed); busy share under the "
          f"profiler: populate {busy['populate'][0]:.3f} ms of device kernels in {busy['populate'][1]:.3f} ms "
          f"wall ({100 * busy['populate'][0] / busy['populate'][1]:.1f}%, {busy['populate'][2]} kernels), cached "
          f"{busy['step'][0]:.3f} ms in {busy['step'][1]:.3f} ms ({100 * busy['step'][0] / busy['step'][1]:.1f}%, "
          f"{busy['step'][2]} kernels)")
    print(f"train step split, mode {mode}, {ARCH} full width on {device_name} (CUDA events, L2 flushed): cached "
          f"step {total:.3f} ms = readout loss {ms['readout']:.3f} ms ({100 * ms['readout'] / total:.1f}%, fp32 "
          f"vocab products at {tflops:.1f} TFLOP/s) + {fwd} {ms['k1']:.3f} ms ({100 * ms['k1'] / total:.1f}%) + K2 "
          f"{ms['k2']:.3f} ms ({100 * ms['k2'] / total:.1f}%) + AdamW {ms['adamw']:.3f} ms "
          f"({100 * ms['adamw'] / total:.1f}%); remainder, not timed alone (cache gather, decode, casts): "
          f"{rest:.3f} ms")


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
    q4_times = {}
    for kind in Q.Q4_KINDS:
        code = Q.codebook(kind, "cuda")
        for label, groups in (("decode", SERVE_DECODE), ("5x128", SERVE_PREFILL),
                              ("ragged", (37, 300, 5, 170))):
            m_rows, n = sum(groups), len(groups)
            for dtype in (torch.bfloat16, torch.float32):
                x, (a, b), idx = _case(torch, dtype, m_rows, groups, seed=7, int8=False)
                pool = (*Q.quantize_q4(a, kind), *Q.quantize_q4(b, kind), code)   # qa, sa, qb, sb, code
                row_src, tile_slot = ops._plan(idx, n, m_rows, ops.TM)
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
                nbytes = _nbytes(x, got, code) + _nbytes(*pool[:4]) * active // n
                dname = str(dtype).split(".")[-1]
                bound = _bound_ms(nbytes, 2 * m_rows * 24 * RANK * 2 * 2048, dname)
                route, passes = K.grouped_fwd_route(dtype), ""
                if route == "tensor_cores":
                    passes = _passes(run)
                    check("stc::project_tc" in passes and "stc::expand_tc" in passes,
                          f"K7 {kind} {label}: not the tensor-core passes: {passes}")
                    passes = f"; passes (profiler): {passes}"
                    route += f", geometry {K.grouped_fwd_geometry(m_rows, row_src.numel())}"
                print(f"kernel grouped_skip_sum_fwd_q4 {kind} {label} M={m_rows} N={n} {dname}, route {route}"
                      f": max_abs_err {err:.3e} (tol {tol:.3e}) kernel {k_ms * 1e3:.1f} us, "
                      f"plain {p_ms * 1e3:.1f} us, bound {bound[0] * 1e3:.2f} us ({bound[1]}, {nbytes} B){passes}")
                if dtype == torch.bfloat16:
                    q4_times[kind, label] = (err, k_ms, p_ms, bound, nbytes)
    err, k_ms, p_ms, bound, nbytes = q4_times["int4", "decode"]
    many = q4_times["int4", "5x128"]
    results["grouped_skip_sum_fwd_q4"] = _entry(
        "grouped_skip_sum_fwd_q4", f"{SKIP_SRC}/{K.SOURCES['grouped_skip_sum_fwd_q4']}", f"{TPU_SKIP}:332",
        err, k_ms, p_ms, bound, nbytes, None, f"L=24 M=5 one row in each of 5 slots D=2048 R={RANK} N=6 int4 bf16",
        nf4_ms=q4_times["nf4", "decode"][1], many_rows_ms=many[1], many_rows_plain_ms=many[2],
        many_rows_bound_ms=many[3][0], many_rows_bound_by=many[3][1], many_rows_bound_bytes=many[4],
        many_rows_max_abs_err=many[0], many_rows_nf4_ms=q4_times["nf4", "5x128"][1],
        many_rows_shape=f"L=24 M=640 in 5 slots of 128 D=2048 R={RANK} N=6 int4 bf16",
        grouped_route=K.grouped_fwd_route(torch.bfloat16))
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
        passes = _passes(c["run"])
        if name == "grouped_skip_sum_fwd_actint8":
            check(K.grouped_fwd_route(q.dtype) == "tensor_cores" and "stc::project_tc" in passes
                  and "stc::expand_tc" in passes, f"K8: not the tensor-core passes: {passes}")
        print(f"kernel {name} fleet passes (profiler): {passes}")
        k_ms, p_ms = time_ms(c["run"]), time_ms(c["plain"], reps=5)
        bound = _bound_ms(c["nbytes"], c["ops"], "bfloat16")
        print(f"kernel {name} fleet L={lnum} M={m} D={d} R={RANK} N=4 bf16 rows, fp32 pools: max_abs_err "
              f"{max(errs):.3e} (tol {c['tol']:.1e} x max) kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, "
              f"bound {bound[0] * 1e3:.2f} us ({bound[1]}, {c['nbytes']} B, {c['ops']} ops)")
        results[name] = _entry(name, f"{SKIP_SRC}/{K.SOURCES[name]}", c["replaces"], max(errs), k_ms, p_ms,
                               bound, c["nbytes"], None, f"L={lnum} M={m} D={d} R={RANK} N=4 bf16, fp32 pools")
        if name == "grouped_skip_sum_fwd_actint8":
            results[name]["grouped_route"] = K.grouped_fwd_route(q.dtype)
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


def geometry_phase(torch):
    """Both block geometries of the tensor-core route, as a measurement of
    the rule ``kernel.grouped_fwd_geometry`` picks them by: K5 at the serve
    cell's decode step, at the fleet step (M 1024 in 4 slots) and over 1, 5
    and 20 slots of a few to many rows each; K8 at 4 slots of 32 to 256 rows
    (256: the fleet step); K7 int4 at fleet serving's decode step and at 5
    slots of 32 to 128 rows; K6 at the serve cell's and fleet serving's
    decode steps and at 5 slots of 128 rows. The rule is replaced for the
    measurement only.
    Each shape must give the same bits in both. Returns {kernel: {shape: {m,
    m_pad, rule, few_rows_ms, many_rows_ms}}} for the kernels line."""
    from repro_torch.core.lm_skiplora import quantize_int8
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops, quant as Q

    def k5(groups):
        x, (a, b), idx = _case(torch, torch.bfloat16, sum(groups), groups, seed=13, int8=False)
        return x, idx, lambda rs, ts: K.grouped_skip_sum_fwd(x, a, b, rs, ts, ops.TM)

    def k8(groups):
        x, a, b, _, idx = _fleet_rows(torch, groups, seed=12)
        q, s = quantize_int8(x)
        return q, idx, lambda rs, ts: K.grouped_skip_sum_fwd_actint8(q, s, a, b, rs, ts, ops.TM)

    def k7(groups):
        x, (a, b), idx = _case(torch, torch.bfloat16, sum(groups), groups, seed=7, int8=False)
        pool = (*Q.quantize_q4(a, "int4"), *Q.quantize_q4(b, "int4"), Q.codebook("int4", "cuda"))
        return x, idx, lambda rs, ts: K.grouped_skip_sum_fwd_q4(x, *pool, rs, ts, ops.TM)

    def k6(groups):
        x, pool, idx = _case(torch, torch.bfloat16, sum(groups), groups, seed=7, int8=True)
        return x, idx, lambda rs, ts: K.grouped_skip_sum_fwd_int8(x, *pool, rs, ts, ops.TM)

    # slot 0 is the zero slot: the live slots come after it
    shapes = [(k5, "grouped_skip_sum_fwd", "serve decode", (1, 1, 1, 1)),
              (k5, "grouped_skip_sum_fwd", "fleet", None)]
    shapes += [(k5, "grouped_skip_sum_fwd", f"1 slot x {m}", (0, m)) for m in (64, 128, 256, 384, 512, 768)]
    shapes += [(k5, "grouped_skip_sum_fwd", f"5 slots x {per}", (0,) + (per,) * 5)
               for per in (1, 4, 8, 16, 32, 48, 64, 96, 128)]
    shapes += [(k5, "grouped_skip_sum_fwd", f"20 slots x {per}", (0,) + (per,) * 20) for per in (4, 8, 16, 32)]
    shapes += [(k8, "grouped_skip_sum_fwd_actint8", f"4 slots x {per}", (per,) * 4) for per in (32, 64, 128, 256)]
    shapes += [(k7, "grouped_skip_sum_fwd_q4", "int4 decode", SERVE_DECODE)]
    shapes += [(k7, "grouped_skip_sum_fwd_q4", f"int4 5 slots x {per}", (0,) + (per,) * 5) for per in (32, 64, 128)]
    shapes += [(k6, "grouped_skip_sum_fwd_int8", "serve decode", (1, 1, 1, 1)),
               (k6, "grouped_skip_sum_fwd_int8", "decode", SERVE_DECODE),
               (k6, "grouped_skip_sum_fwd_int8", "5 slots x 128", SERVE_PREFILL)]
    rule = K.grouped_fwd_geometry
    times = {}
    for make, kname, label, groups in shapes:
        if groups is None:            # K5 at the fleet step: its rows, as K8's
            x, a, b, _, idx = _fleet_rows(torch, (256, 256, 256, 256), seed=12)
            groups, launch = (256,) * 4, lambda rs, ts, x=x, a=a, b=b: K.grouped_skip_sum_fwd(x, a, b, rs, ts, ops.TM)
        else:
            x, idx, launch = make(groups)
        m = x.shape[1]
        row_src, tile_slot = ops._plan(idx, len(groups), m, ops.TM)
        run = lambda: launch(row_src, tile_slot)  # noqa: E731
        outs, ms = {}, {}
        for geometry in ("few_rows", "many_rows"):
            K.grouped_fwd_geometry = lambda m, m_pad, geometry=geometry: geometry
            try:
                outs[geometry], ms[geometry] = run(), time_ms(run)
            finally:
                K.grouped_fwd_geometry = rule
        check(torch.equal(outs["few_rows"], outs["many_rows"]), f"{kname} {label}: the geometries' bits differ")
        picked = rule(m, row_src.numel())
        faster = min(ms, key=ms.get)
        print(f"geometry {kname} {label} M={m} M_pad={row_src.numel()}: few_rows {ms['few_rows'] * 1e3:.1f} us, "
              f"many_rows {ms['many_rows'] * 1e3:.1f} us; the rule picks {picked}"
              f"{'' if picked == faster else f' (the faster is {faster})'}; same bits")
        times.setdefault(kname, {})[label] = {"m": m, "m_pad": row_src.numel(), "rule": picked,
                                              "few_rows_ms": ms["few_rows"], "many_rows_ms": ms["many_rows"]}
        del x, idx, launch, run, outs
    torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------------------
# Phase 9: fleet fine-tuning at full width, write-back, serving from every pool
# ---------------------------------------------------------------------------


def fleet_phase(torch, device_name):
    """4 tenants x 16 samples x seq 128 through ``repro_torch.launch.fleet``'s
    own functions (batch per tenant 2, rank 8, AdamW lr 1e-3, fp32 cache,
    ``--use-kernel``), modes full and int8: one populate and two cached
    epochs, exact launch counts per epoch, every tenant's loss falling, one
    cached step's gradients against the einsum route, frozen and empty slots
    exactly zero. Returns each kernel's launches and the full-mode run's
    inputs and results (for write-back and the session phase)."""
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
            # every forward of a fleet step takes M 1024 in 4 slots: many rows
            _tally_rows("grouped_skip_sum_fwd" if epoch == 0 else fwd, {"many_rows": FLEET_STEPS})
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
        _fleet_step_split(torch, cfg, sl, params, res, device_name, mode)
        res.cache = None
        if mode == "full":
            kept = dict(cfg=cfg, sl=sl, params=params, tokens=tokens, labels=labels, adapters=res.adapters,
                        losses=losses, times=times)
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


def _fleet_step_split(torch, cfg, sl, params, res, device_name, mode):
    """The fleet cached step's device time (CUDA events, L2 flushed) and
    its parts run alone on its inputs: the per-tenant readout loss forward
    + backward, the grouped forward (K5; K8 on the int8 cache in mode
    ``int8``) and K9 each, AdamW. What the step takes beyond those is
    printed as a remainder, not timed alone."""
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
    if mode == "int8":
        q = SL._swap01(vals["acts_q"], torch.int8)
        q = q.reshape(q.shape[0], -1, q.shape[-1])
        s = SL._swap01(vals["acts_scale"], torch.float32).reshape(q.shape[:2])
        x = (q.float() * s[..., None]).to(dtype)
    else:
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

    def fwd():
        if mode == "int8":
            K.grouped_skip_sum_fwd_actint8(q, s, a, b, row_src, tile_slot, ops.TM)
        else:
            K.grouped_skip_sum_fwd(x, a, b, row_src, tile_slot, ops.TM)

    def k9():
        K.grouped_skip_sum_bwd(x, a, b, g, row_src, tile_slot, ops.TM)

    def adam():
        updates, _ = opt.update(grads, state, res.adapters)
        apply_updates(res.adapters, updates)

    ms = {name: time_ms(fn, reps=5, spin=STEP_SPIN) for name, fn in (
        ("step", cached), ("readout", readout), ("fwd", fwd), ("k9", k9), ("adamw", adam))}
    total = ms["step"]
    rest = total - ms["readout"] - ms["fwd"] - ms["k9"] - ms["adamw"]
    print(f"fleet step split, mode {mode}, {ARCH} full width on {device_name} (CUDA events, L2 flushed): cached "
          f"fleet step {total:.3f} ms = per-tenant readout loss {ms['readout']:.3f} ms "
          f"({100 * ms['readout'] / total:.1f}%) + {'K8' if mode == 'int8' else 'K5'} {ms['fwd']:.3f} ms "
          f"({100 * ms['fwd'] / total:.1f}%) + K9 "
          f"{ms['k9']:.3f} ms ({100 * ms['k9'] / total:.1f}%) + AdamW {ms['adamw']:.3f} ms "
          f"({100 * ms['adamw'] / total:.1f}%); remainder, not timed alone (cache gather, decode, grouping plan, "
          f"casts): {rest:.3f} ms")


def fleet_serve_phase(torch, device_name, kept):
    """Write the 4 trained tenants back into float, int8, int4 and nf4 pools
    (``write_back_to_pool``: one ``register_many``) and serve them plus a
    base row with ``generate_grouped`` (prompt 128, 32 new tokens, greedy).
    Checks: the base row equals base ``generate``; the pool's kernel (K5, K6
    or K7) launches exactly 1 + 32 times a call and no other; over the int8
    and 4-bit pools (K6, K7: bf16 rows) one more call, under the profiler,
    runs the tensor-core passes and no CUDA-core pass; the batched write
    equals sequential ``register``; ``rollback`` restores the previous
    payload bitwise. Returns each kernel's launches."""
    from repro_torch.core.adapter_pool import AdapterPool
    from repro_torch.core.fleet_finetune import init_fleet_adapters, write_back_to_pool
    from repro_torch.core.runtime import generate, generate_grouped, generate_loop
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.models.lm import model_dtype

    cfg, sl, params, stacked = (kept[k] for k in ("cfg", "sl", "params", "adapters"))
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
        _tally_rows(kname, {"few_rows": 1 + NEW})     # prefill (last positions) and decode steps
        launches[kname] += counts[kname]
        check(tuple(out.shape) == (len(who), NEW), f"tokens shape {tuple(out.shape)}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token ids out of range")
        check(torch.equal(out[-1], base[-1]), f"pool {compress}: base row {out[-1].tolist()} != base generate "
              f"{base[-1].tolist()}")
        passes = ""
        if compress:   # K6 or K7 with the model's bf16 rows: the tensor-core passes only
            check(K.grouped_fwd_route(model_dtype(cfg)) == "tensor_cores", f"pool {compress}: not bf16 rows")
            # the eager loop: the same launches, each traced on its own
            every = _passes(lambda: generate_loop(params, cfg, prompts, pools=pool.pools(), idx=idx, max_new=NEW,
                                                  device=dev))
            passes = "; ".join(k for k in every.split("; ") if k.startswith(("stc::", "gss::")))
            check("stc::project_tc" in passes and "stc::expand_tc" in passes and "gss::" not in passes,
                  f"pool {compress}: {kname} not on the tensor-core passes: {passes}")
            passes = f"; passes (profiler): {passes}"
        new = pool.slot_payload(tenants[0])
        pool.rollback(tenants[0])
        back = pool.slot_payload(tenants[0])
        check(all(torch.equal(back[k], old[k]) for k in old), f"pool {compress}: rollback is not bitwise")
        check(any(not torch.equal(new[k], old[k]) for k in old), f"pool {compress}: write-back changed nothing")
        print(f"fleet serve {ARCH} full width, pool={compress or 'float'} after write-back: "
              f"{len(who)}x{PROMPT} prompt + {NEW} new in {dt:.3f} s = {len(who) * NEW / dt:.1f} tok/s on "
              f"{device_name}; {kname} x{counts[kname]}{passes}; base row == base generate; register_many == "
              f"register; rollback bitwise")
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


# ---------------------------------------------------------------------------
# Phase 11: the session runtime (serve -> ingest -> adapt -> serve)
# ---------------------------------------------------------------------------


def _window(torch, want, rows=None):
    """Hold the launches since the last reset to ``want`` (kernel -> count,
    every other kernel 0) and the grouped forwards' launches by row class to
    ``rows`` ((kernel, {row class: count}), or none at all); reset the counts
    and return the launches."""
    from repro_torch.kernels.skip_lora import kernel as K

    torch.cuda.synchronize()
    counts = _launches()
    full = {k: 0 for k in counts}
    full.update(want)
    check(counts == full, f"session: launches {counts} != {full}")
    if rows is None:
        check(not K.ROW_LAUNCHES, f"session: grouped forwards {dict(K.ROW_LAUNCHES)} where none was wanted")
    else:
        _tally_rows(*rows)
    _reset_launches()
    return counts


def session_phase(torch, device_name, kept):
    """The session runtime at full width on the fleet phase's inputs (4
    tenants x 16 samples x seq 128, seed-0 weights, batch per tenant 2, rank
    8, AdamW lr 1e-3, fp32 cache, ``use_kernel=True``):
      - mode full, resident engine: a base serve (no grouped launch), 32
        ingests of 2 rows (one K5 launch each, few rows; logits against the
        same forward with ``use_kernel=False``), ``adapt(epochs=3)`` on the
        scan path (exactly 24 K5, many rows, and 24 K9), a serve of the 4
        tenants and a base row (33 K5, few rows; the base row equal to the
        base serve's). The adapters and every per-step loss equal, bitwise,
        the offline ``fleet_finetune`` of the fleet phase, and the pool
        slots ``write_back_to_pool``'s. Then the session is saved under
        build/ (``save_runtime_session``), restored into a fresh runtime,
        and both run one more epoch (8 K5 + 8 K9 each) and the serve:
        losses, adapters, moments, pool, slot table and tokens bitwise;
      - mode full, tiered engine (half of the 64 rows on the card, the host
        tier in memory): the stream path, spills, and the resident run's
        losses and adapters (the reference's bar 1e-6; bitwise or not is
        printed);
      - mode int8 over an int8 pool: K6 at ingest and serve, K8 + K9 at
        adapt, exact counts, every tenant's loss falling;
      - one ``enqueue_ingest`` between decode dispatches lands as a direct
        ``ingest`` does (logits and cached rows bitwise).
    Prints ingest rows/s and one ingest's device time (profiler), each
    path's adapt time beside the offline cached epoch, the HBM hit rates.
    Returns each kernel's launches."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.checkpoint import restore_runtime_session, save_runtime_session
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.core.adapter_pool import AdapterPool
    from repro_torch.core.fleet_finetune import write_back_to_pool
    from repro_torch.core.runtime import SessionRuntime
    from repro_torch.launch import fleet as FL
    from repro_torch.models.lm import ingest_prefill
    from repro_torch.optim.optimizers import adamw

    dev = torch.device("cuda")
    cfg, params, tokens, labels = (kept[k] for k in ("cfg", "params", "tokens", "labels"))
    who = list(range(FLEET_TENANTS)) + [None]
    prompts = torch.randint(0, cfg.vocab_size, (len(who), PROMPT),
                            generator=torch.Generator(device=dev).manual_seed(21), device=dev)
    n_ingests = FLEET_TENANTS * FLEET_SAMPLES // FLEET_BPT
    n_steps = 3 * FLEET_STEPS
    totals: dict[str, int] = {}

    def window(want, rows=None):
        for k, n in _window(torch, want, rows).items():
            totals[k] = totals.get(k, 0) + n

    def runtime(mode, **kw):
        sl = FL.setup(FL.parse_args([*FLEET_ARGS, "--mode", mode]))[1]
        return SessionRuntime(cfg, sl, params, max_tenants=FLEET_TENANTS, samples_per_tenant=FLEET_SAMPLES,
                              seq=FLEET_SEQ, optimizer=adamw(1e-3), use_kernel=True, device=dev, **kw)

    def ingest_all(rt, fwd, compare):
        """The 32 ingests; the last under the profiler. Returns (rows/s over
        the first 31, device ms of the last, logits error vs use_kernel=False
        or None)."""
        batches = [(t, lo) for t in range(FLEET_TENANTS) for lo in range(0, FLEET_SAMPLES, FLEET_BPT)]
        logits = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t, lo in batches[:-1]:
            logits.append(rt.ingest(t, tokens[t, lo:lo + FLEET_BPT], labels[t, lo:lo + FLEET_BPT]))
        torch.cuda.synchronize()
        rate = (len(batches) - 1) * FLEET_BPT / (time.perf_counter() - t0)
        t, lo = batches[-1]
        box = []
        _, per_kernel = _profile(lambda: box.append(rt.ingest(t, tokens[t, lo:lo + FLEET_BPT],
                                                               labels[t, lo:lo + FLEET_BPT])))
        logits += box
        dev_ms = sum(ms for ms, _ in per_kernel.values())
        window({fwd: n_ingests}, (fwd, {"few_rows": n_ingests}))
        err = None
        if compare:   # every row in the zero slot: the same forward through the plain versions
            idx = rt.pool.lookup([None] * FLEET_BPT)
            errs = []
            for (t, lo), got in zip(batches, logits):
                want = ingest_prefill(params, cfg, tokens[t, lo:lo + FLEET_BPT], rt.pool.pools(), idx,
                                      use_kernel=False)[0]
                e, mag = _rel_err(got, want)
                check(e <= 2.0**-7 * mag, f"session ingest {t}/{lo}: logits differ by {e:.3e} (max {mag:.3e})")
                errs.append(e)
            window({})
            err = max(errs)
        return rate, dev_ms, err

    def adapt(rt, fwd, path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rt.adapt(epochs=3, batch_per_tenant=FLEET_BPT, generator=torch.Generator(device=dev).manual_seed(3))
        dt = time.perf_counter() - t0                     # the losses are on the host: the epochs have ended
        window({fwd: n_steps, "grouped_skip_sum_bwd": n_steps}, (fwd, {"many_rows": n_steps}))
        check(out["path"] == path and out["groups"] == [list(range(FLEET_TENANTS))],
              f"session adapt: path {out['path']} groups {out['groups']}, not one group on the {path} path")
        losses = np.stack([out["losses"][t] for t in range(FLEET_TENANTS)], axis=-1)   # (3, steps, N)
        check(losses.shape == (3, FLEET_STEPS, FLEET_TENANTS) and np.isfinite(losses).all(),
              f"session adapt: losses {losses.shape} not finite")
        return losses, dt

    def serve(rt, fwd, base):
        out = rt.serve(who, prompts, max_new=NEW)
        window({fwd: 1 + NEW}, (fwd, {"few_rows": 1 + NEW}))
        check(torch.equal(out[-1], base[-1]), f"session serve: base row {out[-1].tolist()} != {base[-1].tolist()}")
        return out

    def checkpoint_round_trip(rt):
        """Save the trained session under build/, restore it into a fresh
        runtime, and run one more adapt epoch (8 K5 at many rows + 8 K9 each)
        and the serve (33 K5 at few rows each) on both: losses, adapters,
        optimizer moments, pool, slot table and tokens bitwise. Returns
        ({"save", "capture", "restore", "load"}: seconds, checkpoint bytes,
        cache rows, bytes a row)."""
        spans = {}

        def timed(name, fn):
            """``fn`` timed into ``spans`` (synchronised on both sides)."""
            def run(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                spans[name] = time.perf_counter() - t0
                return out
            return run

        (ROOT / "build").mkdir(exist_ok=True)
        directory = tempfile.mkdtemp(prefix="session_ckpt_", dir=ROOT / "build")
        twin = runtime("full")
        # the capture and the load inside the two calls, timed on their own
        rt.session_state = timed("capture", rt.session_state)
        twin.load_session_state = timed("load", twin.load_session_state)
        try:
            path = timed("save", save_runtime_session)(directory, 1, rt)
            nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
            timed("restore", restore_runtime_session)(path, twin)
        finally:
            shutil.rmtree(directory, ignore_errors=True)
            del rt.session_state, twin.load_session_state
        window({})
        rows = len(twin.engine._present)
        check(rows == FLEET_TENANTS * FLEET_SAMPLES and twin.pool.slot_table() == rt.pool.slot_table(),
              f"session checkpoint: {rows} cache rows restored, slot tables equal: "
              f"{twin.pool.slot_table() == rt.pool.slot_table()}")
        outs, toks = [], []
        for r in (rt, twin):
            outs.append(r.adapt(epochs=1, batch_per_tenant=FLEET_BPT))
            window({"grouped_skip_sum_fwd": FLEET_STEPS, "grouped_skip_sum_bwd": FLEET_STEPS},
                   ("grouped_skip_sum_fwd", {"many_rows": FLEET_STEPS}))
            toks.append(serve(r, "grouped_skip_sum_fwd", base))
        for t in range(FLEET_TENANTS):
            check(np.array_equal(outs[0]["losses"][t], outs[1]["losses"][t]),
                  f"session checkpoint: tenant {t} continued losses differ")
            for name in ("adapters", "opt_mu", "opt_nu"):
                for k in ("A", "B"):
                    check(torch.equal(getattr(rt.tenant(t), name)[k], getattr(twin.tenant(t), name)[k]),
                          f"session checkpoint: tenant {t} {name} {k} differ after the continued epoch")
        check(all(torch.equal(v, twin.pool.pools()[k]) for k, v in rt.pool.pools().items())
              and rt.pool.slot_table() == twin.pool.slot_table(), "session checkpoint: pools differ")
        check(torch.equal(toks[0], toks[1]), "session checkpoint: temperature-0 tokens differ")
        return spans, nbytes, rows, twin.engine.row_nbytes()

    _reset_launches()
    # -- mode full, resident engine --------------------------------------------
    rt = runtime("full")
    base = rt.serve([None] * len(who), prompts, max_new=NEW)
    window({})
    rate, ingest_ms, logit_err = ingest_all(rt, "grouped_skip_sum_fwd", compare=True)
    losses, scan_s = adapt(rt, "grouped_skip_sum_fwd", "scan")
    scan_hit = rt.engine.stats.hbm_hit_rate()
    check(np.array_equal(losses, kept["losses"]), "session: per-step losses != the offline fleet_finetune's "
          f"(max diff {np.abs(losses - kept['losses']).max():.3e})")
    for k in ("A", "B"):
        for t in range(FLEET_TENANTS):
            check(torch.equal(rt.tenant(t).adapters[k], kept["adapters"][k][t]),
                  f"session: tenant {t} adapters {k} != the offline fleet_finetune's")
    pool = AdapterPool(FLEET_TENANTS + 1, cfg, RANK, device=dev)
    write_back_to_pool(pool, list(range(FLEET_TENANTS)), kept["adapters"])
    check(all(torch.equal(v, pool.pools()[k]) for k, v in rt.pool.pools().items()),
          "session: pool slots != write_back_to_pool's")
    resident = {t: dict(rt.tenant(t).adapters) for t in range(FLEET_TENANTS)}
    trained0 = resident[0]
    del pool
    ckpt = checkpoint_round_trip(rt)
    del rt
    torch.cuda.empty_cache()

    # -- mode full, tiered engine: half the rows on the card ---------------------
    sl_full = FL.setup(FL.parse_args([*FLEET_ARGS, "--mode", "full"]))[1]
    half = FLEET_TENANTS * FLEET_SAMPLES // 2
    rt = runtime("full", hbm_budget_bytes=half * SL.cache_nbytes_per_sample(cfg, sl_full, FLEET_SEQ))
    check(rt.engine.capacity == half, f"tiered engine holds {rt.engine.capacity} rows, not {half}")
    ingest_all(rt, "grouped_skip_sum_fwd", compare=False)
    t_losses, stream_s = adapt(rt, "grouped_skip_sum_fwd", "stream")
    st = rt.engine.stats
    check(st.spills > 0, "tiered session: no spills")
    loss_diff = float(np.abs(t_losses - losses).max())
    ad_diff = max(float((rt.tenant(t).adapters[k] - resident[t][k]).abs().max())
                  for t in range(FLEET_TENANTS) for k in ("A", "B"))
    check(loss_diff <= 1e-6 and ad_diff <= 1e-6,
          f"tiered session: stream vs scan losses {loss_diff:.3e}, adapters {ad_diff:.3e} > 1e-6")
    stream_stats = (st.hbm_hit_rate(), st.spills, st.host_hits, st.staged_hits)
    del rt
    torch.cuda.empty_cache()

    # -- mode int8 over an int8 pool -------------------------------------------
    rt = runtime("int8", pool_compress="int8")
    i_rate, i_ms, i_err = ingest_all(rt, "grouped_skip_sum_fwd_int8", compare=True)
    i_losses, int8_s = adapt(rt, "grouped_skip_sum_fwd_actint8", "scan")
    means = i_losses.mean(axis=1)                  # (epochs, tenants)
    check(bool((means[-1] < means[0]).all()), f"int8 session: a tenant's mean loss did not fall: {means.tolist()}")
    serve(rt, "grouped_skip_sum_fwd_int8", base)
    del rt
    torch.cuda.empty_cache()

    # -- one enqueue_ingest between decode dispatches == a direct ingest --------
    twins = []
    for _ in range(2):
        rt = SessionRuntime(cfg, sl_full, params, max_tenants=1, samples_per_tenant=FLEET_BPT, seq=FLEET_SEQ,
                            device=dev)
        rt.pool.register(0, trained0)
        twins.append(rt)
    queued, direct = twins
    sched = queued.attach_scheduler(max_batch=2, max_prompt=PROMPT, max_new_cap=4, chunk=1)
    req = queued.enqueue_serve(0, prompts[0].cpu().numpy(), max_new=4)
    ing = queued.enqueue_ingest(0, tokens[0, :FLEET_BPT], labels[0, :FLEET_BPT])
    check(sched.step() == 1 and ing.done and not req.done, "enqueue_ingest did not run at the first step boundary")
    queued.drain()
    want = direct.ingest(0, tokens[0, :FLEET_BPT], labels[0, :FLEET_BPT])
    check(req.done and torch.equal(ing.logits, want), "enqueue_ingest logits != a direct ingest's")
    rows = np.arange(FLEET_BPT)
    a, b = queued.engine.read(rows), direct.engine.read(rows)
    check(all(torch.equal(a[k], b[k]) for k in b), "enqueue_ingest cached rows != a direct ingest's")
    del twins, queued, direct, rt
    _reset_launches()
    torch.cuda.empty_cache()

    off = kept["times"]
    print(f"session {ARCH} full width on {device_name}: {FLEET_TENANTS} tenants x {FLEET_SAMPLES} samples x seq "
          f"{FLEET_SEQ}, batch/tenant {FLEET_BPT}, rank {RANK}, fp32 cache, use_kernel=True; ingest "
          f"{rate:.1f} rows/s (2 rows a call, engine write included), one ingest {ingest_ms:.3f} ms on the device "
          f"(profiler), logits vs use_kernel=False max diff {logit_err:.3e}; adapt 3 epochs: scan path "
          f"{scan_s:.3f} s ({scan_s / 3:.3f} s/epoch, the cache's export included; hbm hit rate {scan_hit:.2f}), "
          f"stream path {stream_s:.3f} s ({stream_s / 3:.3f} s/epoch; half the rows on the card, host tier in "
          f"memory, spills and promotions wait for the device; hbm hit rate {stream_stats[0]:.2f}, spills "
          f"{stream_stats[1]}, host hits {stream_stats[2]}, staged hits {stream_stats[3]}); the offline cached "
          f"epochs {off[1]:.3f} / {off[2]:.3f} s; session == offline fleet_finetune bitwise (losses, adapters, "
          f"pool slots); stream vs scan: losses {loss_diff:.3e}, adapters {ad_diff:.3e} "
          f"({'bitwise' if loss_diff == ad_diff == 0.0 else 'not bitwise'}); launches: ingest "
          f"grouped_skip_sum_fwd x{n_ingests} (few rows), adapt grouped_skip_sum_fwd x{n_steps} (many rows) + "
          f"grouped_skip_sum_bwd x{n_steps}, serve grouped_skip_sum_fwd x{1 + NEW} (few rows)")
    spans, ck_bytes, ck_rows, row_bytes = ckpt
    print(f"session checkpoint {ARCH} full width on {device_name}: save_runtime_session {spans['save']:.3f} s "
          f"= capture {spans['capture']:.3f} s (session_state: the rows read through the engine, copied to the "
          f"host) + write {spans['save'] - spans['capture']:.3f} s (np.savez, manifest, rename); "
          f"restore_runtime_session into a fresh runtime {spans['restore']:.3f} s = read "
          f"{spans['restore'] - spans['load']:.3f} s (np.load of every leaf) + load {spans['load']:.3f} s "
          f"(load_session_state: to the card, engine write; synchronised); "
          f"{ck_bytes} bytes on disk ({ck_bytes / 1e9:.3f} GB: {ck_rows} cache rows of {row_bytes / 1e6:.1f} MB = "
          f"{ck_rows * row_bytes / 1e9:.3f} GB, then pool, adapters and moments); both continued adapt(epochs=1) "
          f"({FLEET_STEPS} K5 many rows + {FLEET_STEPS} K9 each) and the serve ({1 + NEW} K5 few rows each): "
          f"losses, adapters, moments, pool, slot table and temperature-0 tokens bitwise")
    print(f"session int8 (int8 pool) on {device_name}: ingest {i_rate:.1f} rows/s, one ingest {i_ms:.3f} ms on the "
          f"device, logits vs use_kernel=False max diff {i_err:.3e}; adapt 3 epochs {int8_s:.3f} s; per-tenant "
          f"mean losses by epoch {[[round(float(v), 4) for v in row] for row in means]}; launches: ingest "
          f"grouped_skip_sum_fwd_int8 x{n_ingests}, adapt grouped_skip_sum_fwd_actint8 x{n_steps} + "
          f"grouped_skip_sum_bwd x{n_steps}, serve grouped_skip_sum_fwd_int8 x{1 + NEW}; enqueue_ingest between "
          f"decode dispatches == direct ingest (logits, cached rows bitwise)")
    return totals


def small_session_check(torch):
    """Reduced float32 stablelm-1.6b, 2 tenants x 8 samples x seq 16, a
    control plane (every 4th row held out, threshold 0) and a disk host tier
    holding half the rows (``cache_dir``, stream path): serve -> ingest ->
    gated adapt (twice) -> serve -> rollback -> serve on the card (kernels)
    and on the CPU (plain versions), from the same initial adapters (a CPU
    generator). The labels are one token, so the held-out loss falls and the
    gate accepts by a margin. Same per-step losses (rtol 1e-4), adapters
    (atol 1e-4), held-out losses (rtol 1e-4), gate decisions and
    temperature-0 tokens.

    On the card the session runs a second time, saved after the first gated
    adapt (``save_runtime_session``) and restored into a fresh runtime with
    its own disk tier, which continues: losses, adapters, ledger, gate
    decisions and tokens bitwise the uninterrupted run's. An int4-pool
    session round-trips its pool bytes and codebook and serves the same
    tokens through K7 after the restore."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.checkpoint import restore_runtime_session, save_runtime_session
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.core.control_plane import ControlConfig
    from repro_torch.core.runtime import SessionRuntime
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.models.lm import init_lm

    cfg = reduce_config(get_config(ARCH))
    sl = SL.SkipLoRAConfig(rank=RANK, mode="full", cache_dtype="float32", use_fused_kernel=True)
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8, 16), generator=g)
    labels = torch.full((2, 8, 16), 7)
    prompts = torch.randint(0, cfg.vocab_size, (3, 8), generator=g)
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="session_small_", dir=ROOT / "build")

    def runtime(where, tag, **kw):
        cache_dir = tempfile.mkdtemp(prefix=f"cache_{tag}_", dir=scratch)
        return SessionRuntime(cfg, sl, _to(params, where), max_tenants=2, samples_per_tenant=8, seq=16,
                              lr=1e-2, cache_capacity=8, cache_dir=cache_dir, use_kernel=True, device=where,
                              control=ControlConfig(holdout_every=4, threshold=0.0), **kw), cache_dir

    def session(where, tag, restore=False):
        rt, cache_dir = runtime(where, tag)
        toks = [rt.serve([None, None, None], prompts, max_new=4).cpu()]
        for t in range(2):
            for lo in range(0, 8, 2):
                rt.ingest(t, tokens[t, lo:lo + 2], labels[t, lo:lo + 2])
        losses = []
        for i in range(2):
            out = rt.adapt(epochs=2, batch_per_tenant=2, generator=torch.Generator().manual_seed(3))
            check(out["path"] == "stream", f"small session {where}: path {out['path']}")
            losses.append(np.stack([out["losses"][t] for t in range(2)], axis=-1))
            if restore and i == 0:
                path = save_runtime_session(tempfile.mkdtemp(prefix="ckpt_", dir=scratch), 1, rt)
                rt, cache_dir = runtime(where, tag + "_restored")
                restore_runtime_session(path, rt)
        toks.append(rt.serve([0, 1, None], prompts, max_new=4).cpu())
        ledger = dict(rt.control_metrics()["tenants"])
        rt.rollback(0)
        toks.append(rt.serve([0, 1, None], prompts, max_new=4).cpu())
        check(any(f.endswith(".bin") for f in os.listdir(cache_dir)),
              f"small session {where}: nothing spilled to the disk tier")
        return (np.stack(losses), {k: np.stack([rt.tenant(t).adapters[k].cpu().numpy() for t in range(2)])
                                   for k in ("A", "B")}, ledger, toks)

    try:
        res = {where: session(where, where) for where in ("cpu", "cuda")}
        (lc, ac, gc, tc), (lg, ag, gg, tg) = res["cpu"], res["cuda"]
        loss_err = float((np.abs(lg - lc) / np.abs(lc)).max())
        ad_err = max(float(np.abs(ag[k] - ac[k]).max()) for k in ac)
        check(loss_err <= 1e-4 and ad_err <= 1e-4,
              f"small session: card vs CPU losses {loss_err:.3e}, adapters {ad_err:.3e}")
        check({t: r["decision"] for t, r in gc.items()} == {t: r["decision"] for t, r in gg.items()} ==
              {0: "accept", 1: "accept"}, f"small session: gate decisions card {gg} vs CPU {gc}")
        ev_err = max(abs(gg[t][k] - gc[t][k]) / abs(gc[t][k]) for t in gc for k in ("pre", "post"))
        check(ev_err <= 1e-4 and all(gc[t]["post"] < gc[t]["pre"] for t in gc),
              f"small session: held-out losses card {gg} vs CPU {gc}")
        check(all(torch.equal(a, b) for a, b in zip(tc, tg)), f"small session: tokens card {tg} vs CPU {tc}")

        # the card, saved after the first gated adapt and restored: bitwise
        lr_, ar, gr, tr = session("cuda", "cuda_ck", restore=True)
        check(np.array_equal(lr_, lg) and all(np.array_equal(ar[k], ag[k]) for k in ag),
              "small session: the restored run's losses or adapters != the uninterrupted run's")
        check(gr == gg and all(torch.equal(a, b) for a, b in zip(tr, tg)),
              f"small session: the restored run's ledger {gr} or tokens != the uninterrupted run's {gg}")

        # an int4 pool: bytes and codebook round-trip, K7 serves the same tokens
        q4 = []
        for restore in (False, True):
            rt, _ = runtime("cuda", f"q4_{restore}", pool_compress="int4")
            if restore:
                restore_runtime_session(path, rt)
            else:
                for t in range(2):
                    rt.ingest(t, tokens[t, :4], labels[t, :4])
                rt.adapt(epochs=1, batch_per_tenant=2, generator=torch.Generator().manual_seed(3))
                path = save_runtime_session(tempfile.mkdtemp(prefix="ckpt_q4_", dir=scratch), 1, rt)
            before = K.LAUNCHES.get("grouped_skip_sum_fwd_q4", 0)
            q4.append((rt.serve([0, 1, None], prompts, max_new=4).cpu(), rt.pool.pools()))
            check(K.LAUNCHES.get("grouped_skip_sum_fwd_q4", 0) - before == 1 + 4,
                  "small session int4: the serve did not launch K7 once a step")
        (tok_a, pool_a), (tok_b, pool_b) = q4
        check(set(pool_a) == {"qa4", "sa", "qb4", "sb", "code"} and pool_a["qa4"].dtype == torch.uint8
              and all(torch.equal(pool_a[k], pool_b[k]) for k in pool_a),
              "small session int4: pool bytes or codebook differ after the restore")
        check(torch.equal(tok_a, tok_b), "small session int4: tokens differ after the restore")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(f"session small: reduced {ARCH} float32, 2 tenants x 8 samples, control plane + disk host tier (stream "
          f"path), serve -> ingest -> gated adapt x2 -> serve -> rollback -> serve: card (kernels) vs CPU (plain "
          f"versions) max loss rel diff {loss_err:.3e}, max adapter diff {ad_err:.3e}, held-out loss rel diff "
          f"{ev_err:.3e}, gate decisions and temperature-0 tokens equal; saved after the first gated adapt and "
          f"restored into a fresh runtime on the card: losses, adapters, ledger, gate decisions and tokens bitwise "
          f"the uninterrupted run's; an int4 pool round-trips its bytes and codebook, K7 serves the same tokens")


def cli_drill_check(torch):
    """The session CLI's crash drill on the card, in process, reduced:
    ``python -m repro_torch.launch.run --device cuda --use-kernel
    --checkpoint-dir D --inject-failure 3`` restarts exactly once, resumes at
    event 3, runs each completed event once and the failed one twice, and
    ends with the adapters, moments, pool and slot table of the same CLI
    without ``--checkpoint-dir``, bitwise. Any other exception (a kernel
    raising, say) fails the run: one restart, not more, is accepted."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.launch import run

    args = ["--device", "cuda", "--use-kernel", "--tenants", "2", "--rounds", "2", "--samples-per-round", "4",
            "--seq", "16", "--prompt-len", "8", "--gen", "4", "--rank", str(RANK)]
    (ROOT / "build").mkdir(exist_ok=True)
    directory = tempfile.mkdtemp(prefix="session_drill_", dir=ROOT / "build")
    log = io.StringIO()   # the CLI's own per-event lines
    try:
        with contextlib.redirect_stdout(log):
            plain = run.main(args)["runtime"]
            t0 = time.perf_counter()
            sup = run.main([*args, "--checkpoint-dir", directory, "--inject-failure", "3"])
            drill_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    check("1 restarts, resumed at event 3" in log.getvalue(), "cli drill: the CLI did not report its restart")
    info, rt = sup["supervisor"], sup["runtime"]
    n_events = 1 + 2 * (2 + 2)
    check(info["restarts"] == 1 and info["resumed_at"] == 3,
          f"cli drill: {info['restarts']} restarts, resumed at {info['resumed_at']} (want 1 and 3)")
    check(info["executions"] == [2 if i == 3 else 1 for i in range(n_events)],
          f"cli drill: event executions {info['executions']}")
    for t in ("tenant-0", "tenant-1"):
        for name in ("adapters", "opt_mu", "opt_nu"):
            for k in ("A", "B"):
                check(torch.equal(getattr(rt.tenant(t), name)[k], getattr(plain.tenant(t), name)[k]),
                      f"cli drill: {t} {name} {k} != the unsupervised run's")
    check(rt.pool.slot_table() == plain.pool.slot_table()
          and all(torch.equal(v, plain.pool.pools()[k]) for k, v in rt.pool.pools().items()),
          "cli drill: pool or slot table != the unsupervised run's")
    print(f"session cli drill: reduced {ARCH}, --device cuda --use-kernel --checkpoint-dir D --inject-failure 3: "
          f"{info['restarts']} restart, resumed at event {info['resumed_at']}, executions {info['executions']}, "
          f"{drill_s:.2f} s with a checkpoint at each of {n_events} event boundaries; adapters, moments, pool and "
          f"slot table bitwise the run without --checkpoint-dir")


# ---------------------------------------------------------------------------
# Phase 10: K10 (paged KV block gather)
# ---------------------------------------------------------------------------

PAGED_SRC = "src/repro_torch/kernels/flash_attn/csrc/paged_gather.cu"
# the scheduler phase: the reference's shared-prefix trace (benchmarks/serving_bench.py:153)
SCHED_SHARE, SCHED_TAIL, SCHED_NEW, SCHED_REQS = 448, 64, 4, 8
SCHED_ARGS = dict(max_batch=4, max_prompt=SCHED_SHARE + SCHED_TAIL, max_new_cap=SCHED_NEW,
                  admit_bucket=2, inflight_per_tenant=SCHED_REQS, chunk=2, kv_block=32)
# A temperature-0 token that differs between reuse on and off, or between the
# scheduler and a solo ``serve``, is accepted only where the dense path's two
# top logits lie within 2^-5 of the largest |logit| (4 bf16 ulps): the tail
# prefill's products, and a batch of one's, have other shapes than the dense
# batched prefill's, so cuBLAS may round them differently.
TOP2_REL_TOL = 2.0**-5


def paged_kernel_phase(torch):
    """K10 against its plain version, bitwise: at the scheduler's reuse wave
    (one gather of K at full width: pool (24, 128, 32, 32, 64) bf16, tables
    (2, 14)) and a ragged shape (no layer axis, block 8, n_kv 4, hd 96, fp32,
    tables (3, 5) with repeats). The library yardstick is one
    ``index_select`` over the flattened pool's block axis."""
    from repro_torch.kernels.flash_attn import paged as PG

    results = {}
    cases = [("reuse-wave", (24,), 128, 32, 32, 64, torch.bfloat16, 2, 14),
             ("ragged", (), 16, 8, 4, 96, torch.float32, 3, 5)]
    for label, lead, nb, blk, nkv, hd, dtype, rows, slots in cases:
        g = torch.Generator(device="cuda").manual_seed(17)
        pool = torch.randn(lead + (nb, blk, nkv, hd), generator=g, device="cuda").to(dtype)
        tables = torch.randint(0, nb, (rows, slots), generator=g, device="cuda", dtype=torch.int32)
        tables[-1, -2:] = tables[0, :2]                  # repeated ids
        flat = pool.reshape(lead + (nb, -1))
        run = lambda: PG.paged_gather(pool, tables)  # noqa: E731
        plain = lambda: PG.paged_gather_ref(pool, tables)  # noqa: E731
        library = lambda: flat.index_select(len(lead), tables.reshape(-1))  # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want), f"K10 {label}: kernel != plain version (max diff {err:.3e})")
        check(torch.equal(got, PG.gather(pool, tables)), f"K10 {label}: wrapper != kernel")
        check(torch.equal(got.reshape(library().shape), library()), f"K10 {label}: != index_select")
        k_ms, p_ms, l_ms = time_ms(run), time_ms(plain), time_ms(library)
        nbytes = 2 * _nbytes(got) + _nbytes(tables)    # gathered blocks read once, output written once
        dname = str(dtype).split(".")[-1]
        bound = _bound_ms(nbytes, 0, dname)
        shape = f"pool {tuple(pool.shape)} {dname}, tables ({rows}, {slots})"
        print(f"kernel paged_gather {label} {shape}: bitwise equal to the plain version and index_select; "
              f"kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, library index_select {l_ms * 1e3:.1f} us, "
              f"bound {bound[0] * 1e3:.2f} us ({bound[1]}, {nbytes} B), "
              f"{nbytes / (k_ms * 1e-3) / 1e12:.2f} TB/s achieved")
        if label == "reuse-wave":
            results["paged_gather"] = _entry("paged_gather", PAGED_SRC, "src/repro/kernels/flash_attn/paged.py:58",
                                             err, k_ms, p_ms, bound, nbytes, l_ms, shape)
        del pool, flat, got, want
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 11: the request scheduler with paged-KV prefix reuse at full width
# ---------------------------------------------------------------------------


def _shared_prefix_trace(vocab, seed, n):
    """``n`` prompts: one shared 448-token prefix, a distinct 64-token tail each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=SCHED_SHARE, dtype=np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, size=SCHED_TAIL, dtype=np.int32)])
            for _ in range(n)]


def _near_tie_flips(torch, rt, what, prompts, tenants, toks_a, toks_b):
    """Temperature-0 tokens of two runs of the same requests: where request
    i first differs (token d), the dense path's logits for prompt i + the
    first d tokens of run b must have their top two within ``TOP2_REL_TOL``
    of the largest |logit|, else the check fails. Returns one line per flip."""
    import numpy as np

    from repro_torch.models.lm import sched_prefill

    dev, flips = rt.device, []
    for i, (a, b) in enumerate(zip(toks_a, toks_b)):
        a, b = np.asarray(a), np.asarray(b)
        if np.array_equal(a, b):
            continue
        d = int(np.flatnonzero(a != b)[0])
        ctx = torch.as_tensor(np.concatenate([prompts[i], b[:d]])[None], device=dev)
        with torch.no_grad():
            logits, _ = sched_prefill(rt.params, rt.cfg, ctx, torch.tensor([ctx.shape[1]], device=dev),
                                      rt.pool.pools(), rt.pool.lookup([tenants[i]]))
        top = torch.topk(logits[0, 0].float(), 2).values
        gap, mag = (top[0] - top[1]).item(), logits.float().abs().max().item()
        check(gap <= TOP2_REL_TOL * mag, f"scheduler: request {i} token {d} differs, {what} "
              f"({a.tolist()} vs {b.tolist()}) at a top-2 logit gap {gap:.3e} > {TOP2_REL_TOL * mag:.3e}")
        flips.append(f"request {i} token {d}: top-2 gap {gap:.3e} (max |logit| {mag:.3e})")
    return flips


def scheduler_phase(torch, device_name):
    """Full-width stablelm-1.6b (bf16, seeded weights) in a ``SessionRuntime``
    with the serve phase's 3 demo tenants (float pool), through the
    ``RequestScheduler`` on the reference's shared-prefix trace: 8 requests
    of one tenant, a shared 448-token prefix + a distinct 64-token tail each
    (numpy seed 13), 4 new tokens, batch 4, admission bucket 2, chunk 2, KV
    block 32, temperature 0. Warmed once (reuse on and off, 4 other
    prompts), then replayed with reuse on and with reuse off. Checks: reuse
    admissions and prefix hits happen; K10 launches exactly twice a reuse
    wave and K5 as often as the dispatch counters imply, no other kernel;
    no block leaks after the drain; the first reuse wave's gathered K/V equal
    bitwise the live rows the dense admission wrote for the same prefix;
    temperature-0 tokens equal with reuse on and off (or a flip within
    ``TOP2_REL_TOL``). Then the device time of one reuse and one dense
    admission dispatch, and mid-decode admission at full width (3 requests
    of 128 tokens, bucket 1, 8 new tokens): continuous equal to sequential,
    and to solo ``serve`` (or a flip within ``TOP2_REL_TOL``). Returns each kernel's launches over the two replays."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import kv_pool as KV
    from repro_torch.core import scheduler as S
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.launch.serve import demo_runtime
    from repro_torch.models.lm import init_lm

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    rt = demo_runtime(cfg, TENANTS, RANK, None, params, dev)
    tenant = "tenant-0"
    captured = {}

    class Traced(S.RequestScheduler):
        def _publish_rows(self, pool, pidx, lb, admits, rows):
            # the live rows the first dense admission wrote, before they decode on
            captured.setdefault("dense", (list(rows), {
                n: lb.caches[n][:, rows, :SCHED_SHARE].clone() for n in ("k", "v")}))
            super()._publish_rows(pool, pidx, lb, admits, rows)

    real_gather = KV.gather_blocks

    def gather(data, tables, **kw):
        out = real_gather(data, tables, **kw)
        captured.setdefault("gathered", {n: v.clone() for n, v in out.items()})
        return out

    def first_call(name, fn):
        def wrapper(*a, **kw):
            captured.setdefault(name, (fn, a, kw))
            return fn(*a, **kw)
        return wrapper

    def replay(prompts, reuse, cls=S.RequestScheduler, loop=False):
        rt.reset_prefix_cache()
        sched = cls(rt, prefix_reuse=reuse, loop=loop, **SCHED_ARGS)
        reqs = [sched.submit(tenant, p, max_new=SCHED_NEW) for p in prompts]
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        sched.drain()
        torch.cuda.synchronize()
        return sched, [r.result() for r in reqs], time.perf_counter() - t0, (_launches(), dict(K.ROW_LAUNCHES))

    for reuse in (True, False):
        replay(_shared_prefix_trace(cfg.vocab_size, 17, 4), reuse)
    prompts = _shared_prefix_trace(cfg.vocab_size, 13, SCHED_REQS)
    saved = (KV.gather_blocks, S._sched_admit, S._sched_admit_reuse)
    KV.gather_blocks = gather
    S._sched_admit = first_call("admit", S._sched_admit)
    S._sched_admit_reuse = first_call("admit_reuse", S._sched_admit_reuse)
    try:
        on, on_toks, on_dt, on_counts = replay(prompts, True, cls=Traced)
        rt.check_prefix_no_leaks()
        off, off_toks, off_dt, off_counts = replay(prompts, False)
    finally:
        KV.gather_blocks, S._sched_admit, S._sched_admit_reuse = saved
    # the same replays with every chunk as eager steps: the graphed chunks' tokens and counters, bitwise
    eager = {}
    for reuse, (sched, toks, dt, counts) in ((True, (on, on_toks, on_dt, on_counts)),
                                              (False, (off, off_toks, off_dt, off_counts))):
        e_sched, e_toks, e_dt, e_counts = replay(prompts, reuse, loop=True)
        check(all(np.array_equal(a, b) for a, b in zip(toks, e_toks)),
              f"scheduler reuse={reuse}: graphed chunks' tokens {[t.tolist() for t in toks]} != eager chunks' "
              f"{[t.tolist() for t in e_toks]}")
        check(e_sched.counters == sched.counters and e_counts == counts,
              f"scheduler reuse={reuse}: eager chunks' counters or launches differ: {dict(e_sched.counters)} "
              f"{e_counts} != {dict(sched.counters)} {counts}")
        eager[reuse] = e_dt
    c, chunk = on.counters, SCHED_ARGS["chunk"]
    check(c["dispatch/admit_reuse"] >= 1 and c["prefix/hits"] >= 1,
          f"scheduler: no prefix reuse on the shared-prefix trace: {dict(c)}")
    launches = {}
    for sched, (counts, rows), reuse in ((on, on_counts, True), (off, off_counts, False)):
        for (kname, geometry), n in rows.items():
            MAIN_ROWS[kname, geometry] = MAIN_ROWS.get((kname, geometry), 0) + n
        sc = sched.counters
        want = {k: 0 for k in counts}
        admits = sc["dispatch/admit"] + sc["dispatch/admit_reuse"]
        want["grouped_skip_sum_fwd"] = admits * (1 + chunk) + sc["dispatch/step"] * chunk
        want["paged_gather"] = 2 * sc["dispatch/admit_reuse"]
        check(counts == want, f"scheduler reuse={reuse}: launches {counts} != {want} (counters {dict(sc)})")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    check(off.counters["dispatch/admit_reuse"] == 0, "reuse off still reused")
    rows, dense = captured["dense"]
    gathered = captured["gathered"]
    check(tuple(gathered["k"].shape[2:3]) == (SCHED_SHARE,), f"gathered span {tuple(gathered['k'].shape)}")
    for n in ("k", "v"):
        for j in range(gathered[n].shape[1]):
            check(torch.equal(gathered[n][:, j], dense[n][:, 0]),
                  f"scheduler: reuse wave row {j} gathered {n} != the dense admission's live row {rows[0]}")
    same_rows = all(torch.equal(dense[n][:, 0], dense[n][:, 1]) for n in ("k", "v"))
    # temperature 0: reuse on and off give the same tokens, or a flip at a near tie
    flips = _near_tie_flips(torch, rt, "reuse on vs off", prompts, [tenant] * SCHED_REQS, on_toks, off_toks)
    total = SCHED_REQS * SCHED_NEW
    skipped = c["prefix/tokens_reused"] / (SCHED_REQS * (SCHED_SHARE + SCHED_TAIL))
    print(f"scheduler {ARCH} full width on {device_name}: {SCHED_REQS} requests x ({SCHED_SHARE} shared + "
          f"{SCHED_TAIL} tail) prompt + {SCHED_NEW} new, batch 4, bucket 2, chunk 2, kv block 32: reuse on "
          f"{on_dt:.3f} s = {total / on_dt:.1f} tok/s, reuse off {off_dt:.3f} s = {total / off_dt:.1f} tok/s "
          f"({off_dt / on_dt:.2f}x); prefill tokens skipped {100 * skipped:.1f}%; counters on "
          f"{dict(sorted(c.items()))}; off {dict(sorted(off.counters.items()))}")
    print(f"scheduler graphed chunks vs eager chunks on {device_name}: tokens, counters and launches bitwise "
          f"equal with reuse on and off; reuse on {on_dt:.3f} s graphed vs {eager[True]:.3f} s eager "
          f"({total / on_dt:.1f} vs {total / eager[True]:.1f} tok/s), reuse off {off_dt:.3f} s vs "
          f"{eager[False]:.3f} s ({total / off_dt:.1f} vs {total / eager[False]:.1f} tok/s)")
    print(f"scheduler checks: launches per replay exact (K5 = admissions x 3 + steps x 2, K10 = 2 x reuse "
          f"waves); no block leaks after the reuse-on drain; first reuse wave's gathered K/V bitwise the "
          f"dense admission's live row (the two dense rows' prefixes {'equal' if same_rows else 'differ'}); "
          f"temperature-0 tokens reuse on vs off: "
          f"{'all equal' if not flips else '; '.join(flips)}")
    timed = {}
    for name in ("admit", "admit_reuse"):
        fn, a, kw = captured[name]
        run = lambda: fn(*a, **kw)  # noqa: E731
        timed[name] = (time_ms(run, reps=5, spin=STEP_SPIN), *_busy(torch, run))
    (d_ms, d_busy, d_wall, d_n), (r_ms, r_busy, r_wall, r_n) = timed["admit"], timed["admit_reuse"]
    print(f"scheduler dispatch on {device_name}: device kernel time (profiler) of a dense admission of 2 x "
          f"{SCHED_SHARE + SCHED_TAIL} tokens + 2 decode steps {d_busy:.3f} ms ({d_n} kernels, profiled wall "
          f"{d_wall:.1f} ms), of a reuse admission (K10 gather of {SCHED_SHARE} tokens a row + {SCHED_TAIL}-token "
          f"tail prefill) + 2 decode steps {r_busy:.3f} ms ({r_n} kernels, wall {r_wall:.1f} ms): "
          f"{d_busy / r_busy:.2f}x; CUDA events from first to last kernel (L2 flushed, stream held by a spin "
          f"kernel) {d_ms:.3f} / {r_ms:.3f} ms, which the host sets: once the card's launch queue is full the host "
          f"waits on each launch, so the card idles between kernels")
    captured.clear()

    # Mid-decode admission at full width: continuous, sequential, solo serve.
    rng = np.random.default_rng(5)
    mid = [rng.integers(0, cfg.vocab_size, size=128, dtype=np.int32) for _ in range(3)]
    who = ["tenant-0", "tenant-1", "tenant-0"]
    kw = dict(max_batch=3, max_prompt=128, max_new_cap=8, admit_bucket=1, inflight_per_tenant=3, chunk=2,
              prefix_reuse=False)
    runs = {}
    for mode in ("continuous", "sequential"):
        rt.reset_prefix_cache()
        sched = S.RequestScheduler(rt, mode=mode, **kw)
        reqs = [sched.submit(t, p, max_new=8) for t, p in zip(who, mid)]
        sched.drain()
        check(sched.counters["dispatch/admit"] == 3, f"mid-decode {mode}: {dict(sched.counters)}")
        runs[mode] = np.stack([r.result() for r in reqs])
    runs["solo"] = np.stack([rt.serve([t], p[None], max_new=8)[0].cpu().numpy() for t, p in zip(who, mid)])
    check(all(((v >= 0) & (v < cfg.vocab_size)).all() for v in runs.values()), "mid-decode: token ids out of range")
    # one batch geometry (3 rows, the same dispatch shapes) in both modes: the same tokens, bitwise
    check(np.array_equal(runs["continuous"], runs["sequential"]),
          f"mid-decode: continuous {runs['continuous'].tolist()} != sequential {runs['sequential'].tolist()}")
    # a solo serve is a batch of one: equal tokens, or a flip at a near tie
    solo_flips = _near_tie_flips(torch, rt, "scheduler vs solo serve", mid, who, runs["continuous"], runs["solo"])
    n = runs["solo"].size
    print(f"scheduler mid-decode admission {ARCH} full width: 3 requests x 128 tokens, bucket 1, 8 new: equal tokens "
          f"continuous vs sequential {(runs['continuous'] == runs['sequential']).sum()}/{n} (checked equal), "
          f"continuous vs solo serve {(runs['continuous'] == runs['solo']).sum()}/{n} "
          f"({'all equal' if not solo_flips else '; '.join(solo_flips)})")
    del rt, params, on, off
    torch.cuda.empty_cache()
    return launches


def small_scheduler_check(torch):
    """Reduced float32 stablelm-1.6b through the scheduler with prefix reuse
    (6 prompts of two tenants sharing 12 of 16 tokens, KV block 4, batch 2,
    so rows recycle): the same temperature-0 tokens on the card (kernels,
    K10 included) as on the CPU (plain versions), and with reuse off. Both
    sessions hold the same adapters, drawn on the CPU."""
    import numpy as np

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.core.runtime import SessionRuntime
    from repro_torch.core.scheduler import RequestScheduler
    from repro_torch.kernels.flash_attn import paged as PG
    from repro_torch.models.lm import init_lm

    cfg = reduce_config(get_config(ARCH))
    sl = SL.SkipLoRAConfig(rank=RANK)
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    adapters = []
    for t in range(2):
        ad = SL.init_adapters(torch.Generator().manual_seed(100 + t), cfg, sl)
        ad["B"] = torch.randn(ad["B"].shape, generator=torch.Generator().manual_seed(200 + t)) * 0.02
        adapters.append(ad)
    rng = np.random.default_rng(13)
    shared = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 4).astype(np.int32)]) for _ in range(6)]
    toks = {}
    for where in ("cpu", "cuda"):
        rt = SessionRuntime(cfg, sl, _to(params, where), max_tenants=2, samples_per_tenant=1, seq=8, device=where)
        for t, ad in enumerate(adapters):
            rt.pool.register(f"tenant-{t}", ad)
        for reuse in (True, False):
            rt.reset_prefix_cache()
            sched = RequestScheduler(rt, max_batch=2, max_prompt=16, max_new_cap=4, admit_bucket=2,
                                     inflight_per_tenant=6, chunk=2, prefix_reuse=reuse, kv_block=4)
            PG.reset_launches()
            reqs = [sched.submit(f"tenant-{i % 2}", p, max_new=4) for i, p in enumerate(prompts)]
            sched.drain()
            toks[where, reuse] = [r.result().tolist() for r in reqs]
            if reuse:
                rt.check_prefix_no_leaks()
                check(sched.counters["dispatch/admit_reuse"] >= 1, f"small scheduler {where}: no reuse")
                if where == "cuda":
                    check(PG.LAUNCHES["paged_gather"] == 2 * sched.counters["dispatch/admit_reuse"],
                          f"small scheduler: K10 launches {PG.LAUNCHES}")
    check(toks["cpu", True] == toks["cuda", True] == toks["cpu", False] == toks["cuda", False],
          f"small scheduler: tokens differ {toks}")
    print(f"scheduler small: reduced {ARCH} float32, 6 prompts of 2 tenants sharing 12 of 16 tokens, kv block 4, "
          f"batch 2: temperature-0 tokens equal on the card (K5 + K10) and the CPU (plain versions), reuse on "
          f"and off")


# ---------------------------------------------------------------------------
# Phase 12: the paper's own experiment (the 3-layer MLP; no hand-written kernel)
# ---------------------------------------------------------------------------

#: the quickstart's settings: 40 epochs, batch 20, lr 0.05, rank 4
PAPER_EPOCHS, PAPER_BATCH, PAPER_LR = 40, 20, 0.05
#: the paper's epoch counts (the reference's benchmarks/paper_tables.py setup)
PAPER_RUN_EPOCHS = {"fan": 300, "har": 600}


def _host_ms(torch, fn, reps: int = 5) -> float:
    """Median host ms of ``fn`` over ``reps`` calls, each synchronised, after
    one warm-up call."""
    import statistics

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _bitwise(torch, a, b) -> bool:
    from repro_torch.optim.optimizers import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def paper_phase(torch, device_name):
    """The paper's experiment on the card (Section 5.1, Tables 3/4/6/7):
    damage1, damage2 and HAR twins; Fan (256-96-96-3) and HAR (561-96-96-6)
    pre-trained, then all eight methods fine-tuned, each epoch one CUDA-graph
    replay (``core.finetune``). Gates: the drift collapses and Skip2-LoRA
    recovers it; every loss falls; Skip2-LoRA == Skip-LoRA; the cache full
    after epoch 0 with a remainder batch; graph == eager loop bitwise; a
    reduced config as on the CPU; no hand-written kernel launched. Then the
    times: per-method epochs graphed and eager, Skip2-LoRA's populate and
    cached epochs, the per-batch phase split, the cached batch against
    LoRA-All's, the reduction beside the cost model, and a graphed epoch's
    device busy share."""
    from repro_torch.core import compute_model as CM
    from repro_torch.core import finetune as F
    from repro_torch.core import methods as M
    from repro_torch.core import skip_cache as C
    from repro_torch.data.synthetic import make_drifted_dataset
    from repro_torch.models.mlp import MLPConfig, accuracy, mlp_forward, pretrain
    from repro_torch.optim.optimizers import tree_leaves

    t_phase = time.perf_counter()
    _reset_launches()
    dev = torch.device("cuda")
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    cfgs = {"fan": MLPConfig(256, 96, 3, lora_rank=4), "har": MLPConfig(561, 96, 6, lora_rank=4)}
    data = {name: make_drifted_dataset(gen(0), name, device=dev) for name in ("damage1", "damage2", "har")}
    print("paper data: " + "; ".join(
        f"{n} {ds.x_pre.shape[0]}/{ds.x_ft.shape[0]}/{ds.x_test.shape[0]} x {ds.n_features}, {ds.n_classes} classes"
        for n, ds in data.items()) + " (pre-train/fine-tune/test rows)")

    # pre-train, then the drifted accuracy before fine-tuning (Table 3 "Before")
    backbones, before = {}, {}
    for name, ds in data.items():
        arch = "har" if name == "har" else "fan"
        t0 = time.perf_counter()
        bb = backbones[name] = pretrain(gen(1), cfgs[arch], ds.x_pre, ds.y_pre, epochs=10 if arch == "har" else 30)
        with torch.no_grad():
            before[name] = float(accuracy(mlp_forward(bb, ds.x_test, cfgs[arch])[0], ds.y_test))
        print(f"paper pretrain {name}: {arch} {'-'.join(map(str, cfgs[arch].dims))}, "
              f"{10 if arch == 'har' else 30} epochs (eager SGD) in {time.perf_counter() - t0:.2f} s; drifted test "
              f"accuracy before fine-tuning {before[name]:.3f}")

    # all eight methods, 40 epochs each, every epoch one graph replay
    after = {}
    for name, ds in data.items():
        cfg = cfgs["har" if name == "har" else "fan"]
        accs = []
        for method in M.METHODS:
            res = F.finetune(gen(2), method, cfg, backbones[name], ds.x_ft, ds.y_ft, epochs=PAPER_EPOCHS,
                             batch_size=PAPER_BATCH, lr=PAPER_LR)
            check(all(abs(v) < float("inf") for v in res.losses), f"paper {name} {method}: non-finite losses")
            check(res.losses[-1] < res.losses[0], f"paper {name} {method}: loss {res.losses[0]:.4f} -> "
                  f"{res.losses[-1]:.4f} did not fall")
            after[name, method] = F.evaluate(method, cfg, res, ds.x_test, ds.y_test)
            accs.append(f"{method} {after[name, method]:.3f} (loss {res.losses[0]:.3f} -> {res.losses[-1]:.4f})")
        print(f"paper finetune {name}: {PAPER_EPOCHS} epochs, batch {PAPER_BATCH}, lr {PAPER_LR}, graph replays, "
              f"test accuracy before {before[name]:.3f}, after: " + ", ".join(accs))
    check(before["damage1"] < 0.5 and after["damage1", "skip2_lora"] > 0.8,
          f"paper damage1: before {before['damage1']:.3f} (bar < 0.5), Skip2-LoRA after "
          f"{after['damage1', 'skip2_lora']:.3f} (bar > 0.8)")

    # the bars of Algorithm 1, and graph replays == the eager loop, bitwise
    cfg, ds, bb = cfgs["fan"], data["damage1"], backbones["damage1"]
    skip = F.finetune(gen(9), "skip_lora", cfg, bb, ds.x_ft, ds.y_ft, epochs=3)
    skip2 = F.finetune(gen(9), "skip2_lora", cfg, bb, ds.x_ft, ds.y_ft, epochs=3)
    diff = max((a - b).abs().max().item() for a, b in zip(tree_leaves(skip.trainable), tree_leaves(skip2.trainable)))
    check(diff <= 1e-4, f"paper: Skip2-LoRA vs Skip-LoRA after 3 epochs differ by {diff:.3e} > 1e-4")
    rem = F.finetune(gen(11), "skip2_lora", cfg, bb, ds.x_ft[:47], ds.y_ft[:47], epochs=1)
    check(int(rem.cache.hit_count()) == 47, f"paper: {int(rem.cache.hit_count())} of 47 rows cached after epoch 0")
    for method in M.METHODS:
        runs = [F.finetune(gen(5), method, cfg, bb, ds.x_ft, ds.y_ft, epochs=3, loop=loop) for loop in (False, True)]
        check(runs[0].losses == runs[1].losses and _bitwise(torch, runs[0].trainable, runs[1].trainable),
              f"paper {method}: graph replays differ from the eager loop")
        if method == "skip2_lora":
            check(_bitwise(torch, runs[0].cache.slots, runs[1].cache.slots)
                  and torch.equal(runs[0].cache.valid, runs[1].cache.valid),
                  "paper skip2_lora: the graphed populate epoch's cache differs from the eager loop's")
    print(f"paper algorithm 1: Skip2-LoRA vs Skip-LoRA after 3 epochs max |diff| {diff:.3e} (bar 1e-4); "
          f"47 of 47 rows cached after epoch 0 (batch 20, a wrapped remainder); graph replays == eager loop "
          f"bitwise (losses, trainable leaves) for all 8 methods x 3 epochs, and Skip2-LoRA's populate + "
          f"cached epochs with their cache slots and validity")

    # a reduced config on the card as on the CPU
    small = MLPConfig(32, 24, 3, lora_rank=4)
    g = gen(20)
    x_s, y_s = torch.randn((40, 32), generator=g), torch.randint(0, 3, (40,), generator=g)
    bb_s = pretrain(gen(21), small, x_s, y_s, epochs=2)
    loss_err = leaf_err = 0.0
    for method in M.METHODS:
        cpu = F.finetune(gen(22), method, small, bb_s, x_s, y_s, epochs=3)
        card = F.finetune(gen(22), method, small, _to(bb_s, dev), x_s.to(dev), y_s.to(dev), epochs=3)
        for a, b in zip(card.losses, cpu.losses):
            loss_err = max(loss_err, abs(a - b) / abs(b))
        for a, b in zip(tree_leaves(card.trainable), tree_leaves(cpu.trainable)):
            leaf_err = max(leaf_err, (a.cpu() - b).abs().max().item() / b.abs().max().item())
    check(loss_err <= 1e-5 and leaf_err <= 1e-5,
          f"paper small: card vs CPU losses {loss_err:.3e}, trainable leaves {leaf_err:.3e} (bar 1e-5 relative)")
    print(f"paper small: 32-24-3 float32, 40 samples, 3 epochs, all 8 methods: card (graph replays, TF32 off) vs "
          f"CPU (eager) max rel diff losses {loss_err:.3e}, trainable leaves {leaf_err:.3e} (of each leaf's "
          f"largest value)")

    # times: each method's epoch graphed and eager (host clock, synchronised, median of 5)
    reduction, times = {}, {}
    for arch, name in (("fan", "damage1"), ("har", "har")):
        cfg, ds, bb = cfgs[arch], data[name], backbones[name]
        n = ds.x_ft.shape[0]
        idx = F.epoch_index_matrix(gen(30), n, PAPER_BATCH, device=dev)
        steps = idx.shape[0]
        ms = times[arch] = {}
        busy = {}
        for method in M.METHODS:
            t, f = M.init_method(gen(31), cfg, bb, method)
            if method == "skip2_lora":
                c0 = C.cache_for_mlp(n, cfg.dims, device=dev)
                for loop in (False, True):
                    pop, cached = F.make_skip2_epoch_fns(cfg, loop=loop)
                    t1, cache, _ = pop(t, f, c0, ds.x_ft, ds.y_ft, idx, PAPER_LR)
                    ms["populate", loop] = _host_ms(torch, lambda: pop(t, f, c0, ds.x_ft, ds.y_ft, idx, PAPER_LR))
                    ms[method, loop] = _host_ms(torch, lambda: cached(t1, cache, ds.x_ft, ds.y_ft, idx, PAPER_LR))
                pop, cached = F.make_skip2_epoch_fns(cfg)
                busy["populate"] = _busy(torch, lambda: pop(t, f, c0, ds.x_ft, ds.y_ft, idx, PAPER_LR))
                busy[method] = _busy(torch, lambda: cached(t1, cache, ds.x_ft, ds.y_ft, idx, PAPER_LR))
                continue
            for loop in (False, True):
                epoch = F.make_epoch_fn(method, cfg, loop=loop)
                ms[method, loop] = _host_ms(torch, lambda: epoch(t, f, ds.x_ft, ds.y_ft, idx, PAPER_LR))
            epoch = F.make_epoch_fn(method, cfg)
            busy[method] = _busy(torch, lambda: epoch(t, f, ds.x_ft, ds.y_ft, idx, PAPER_LR))
        rows = list(M.METHODS[:-1]) + ["populate", "skip2_lora"]
        print(f"paper epoch {arch} ({name}, {steps} steps of batch {PAPER_BATCH}) on {device_name}, host ms, median "
              f"of 5, graph replay / eager loop: " + ", ".join(
                  f"{m if m != 'skip2_lora' else 'skip2_lora cached'} {ms[m, False]:.3f} / {ms[m, True]:.3f} "
                  f"({ms[m, True] / ms[m, False]:.1f}x)" for m in rows))
        print(f"paper trace {arch}: a graphed epoch's device time (torch.profiler) over its profiled wall time "
              f"and over its unprofiled median above, and its device ops a step: " + ", ".join(
                  f"{m if m != 'skip2_lora' else 'skip2_lora cached'} {busy[m][0]:.3f} ms, "
                  f"{100 * busy[m][0] / busy[m][1]:.1f}% of {busy[m][1]:.3f} / {100 * busy[m][0] / ms[m, False]:.1f}% "
                  f"of {ms[m, False]:.3f}, {busy[m][2] / steps:.1f}" for m in rows))
        epochs = PAPER_RUN_EPOCHS[arch]
        model = 1 - (CM.method_cost("skip2_lora", PAPER_BATCH, cfg.dims, 4,
                                    cache_hit_rate=CM.expected_hit_rate(epochs)).total
                     / CM.method_cost("lora_all", PAPER_BATCH, cfg.dims, 4).total)
        for loop in (False, True):
            t_skip2 = ms["populate", loop] + (epochs - 1) * ms["skip2_lora", loop]
            reduction[arch, loop] = 1 - t_skip2 / (epochs * ms["lora_all", loop])
        print(f"paper reduction {arch}: {epochs} epochs of Skip2-LoRA (populate + {epochs - 1} cached) against "
              f"LoRA-All, from the epoch times above: graph replays {100 * reduction[arch, False]:.1f}%, eager loop "
              f"{100 * reduction[arch, True]:.1f}%; cost model (FLOPs) {100 * model:.1f}%")

    # per batch (eager): the forward / backward / update split, and the cached batch against LoRA-All's
    cfg, ds, bb = cfgs["fan"], data["damage1"], backbones["damage1"]
    xb, yb = ds.x_ft[:PAPER_BATCH], ds.y_ft[:PAPER_BATCH]
    split = []
    for method in M.METHODS:
        fwd_m = "skip_lora" if method == "skip2_lora" else method
        t, f = M.init_method(gen(31), cfg, bb, method)
        ph = M.make_phase_fns(fwd_m, cfg)
        grads = ph["backward"](t, f, xb, yb)
        split.append(f"{method} {_host_ms(torch, lambda: ph['forward'](t, f, xb), 20):.3f} / "
                     f"{_host_ms(torch, lambda: ph['backward'](t, f, xb, yb), 20):.3f} / "
                     f"{_host_ms(torch, lambda: ph['update'](t, grads, 0.0), 20):.3f}")
    print(f"paper phases fan on {device_name}, one batch of {PAPER_BATCH} eager, host ms (median of 20), forward / "
          f"backward / update: " + ", ".join(split))
    t, f = M.init_method(gen(31), cfg, bb, "lora_all")
    lora_ms = _host_ms(torch, lambda: M.train_step("lora_all", cfg, t, f, xb, yb, PAPER_LR), 20)
    t, f = M.init_method(gen(31), cfg, bb, "skip2_lora")
    cache = C.cache_for_mlp(ds.x_ft.shape[0], cfg.dims, device=dev)
    bidx = torch.arange(PAPER_BATCH, device=dev)
    F._populate_step(cfg)(t, f, cache, bidx, xb, yb, PAPER_LR)
    cached_ms = _host_ms(torch, lambda: F._cached_step(cfg)(t, cache, bidx, xb, yb, PAPER_LR), 20)
    graphed = times["fan"]["skip2_lora", False] / times["fan"]["lora_all", False]
    print(f"paper batch fan: Skip2-LoRA cached step {cached_ms:.3f} ms against LoRA-All's {lora_ms:.3f} ms (eager, "
          f"host ms, median of 20): {100 * (1 - cached_ms / lora_ms):.1f}% less; a graphed cached epoch against a "
          f"graphed LoRA-All epoch: {100 * (1 - graphed):.1f}% less")

    counts = {k: v for k, v in _launches().items() if v}
    from repro_torch.kernels.skip_lora import kernel as K

    check(not counts and not K.ROW_LAUNCHES, f"paper: hand-written kernels launched on the MLP path: {counts}")
    print(f"paper phase: {time.perf_counter() - t_phase:.1f} s, no hand-written kernel launched (the MLP path "
          f"reaches none, as in the reference)")


def _tensor_core_ptxas(logs):
    """One line per instantiation of the tensor-core kernels from nvcc's
    ``-Xptxas -v`` output (registers, shared memory, spills): K4's bf16
    route and the passes of ``skip_sum_tc.cuh`` (``project_tc``,
    ``expand_tc``, ``outer_tc``), which the bf16 routes of K2, K5, K6, K7
    and K9, and K3 and K8, run. Each source that includes the header
    builds its own copy, so an instantiation shared by two kernels (K3's
    and K8's, say) prints once for each."""
    out, fn = [], None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1) if re.search(r"flash_fwd_bf16|project_tc|expand_tc|outer_tc", m.group(1)) else None
                spill = "0 bytes spill stores"
            elif fn and "spill" in line:
                spill = line.split(",")[1].strip()
            elif fn and "Used" in line:
                out.append(f"ptxas {fn}: {line.split(':', 1)[1].strip()}, {spill}")
                fn = None
    return out


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
    from repro_torch.kernels.flash_attn import paged as PG
    from repro_torch.kernels.skip_lora import kernel as K

    t0 = time.perf_counter()
    logs = build_all([(K.LIB, None), (FK.LIB, None), (PG.LIB, None)])
    regs = [int(v) for log in logs.values() for v in re.findall(r"Used (\d+) registers", log)]
    spills = [int(v) for log in logs.values() for v in re.findall(r"(\d+) bytes spill stores", log)]
    stack = [int(v) for log in logs.values() for v in re.findall(r"(\d+) bytes stack frame", log)]
    print(f"build: {len(logs)} kernels built with nvcc in {time.perf_counter() - t0:.1f} s; "
          f"max registers {max(regs, default=0)}, instantiations spilling {sum(s > 0 for s in spills)}, "
          f"with a stack frame {sum(s > 0 for s in stack)}")
    for line in _tensor_core_ptxas(logs):
        print(line)

    results = kernel_phase(torch)
    results.update(fused_kernel_phase(torch))
    results.update(flash_phase(torch))
    results.update(grouped_train_kernel_phase(torch))
    for kname, shapes in geometry_phase(torch).items():
        results[kname]["geometry_ms"] = shapes
    results.update(paged_kernel_phase(torch))
    launches = serve_phase(torch, smi)
    launches.update(train_phase(torch, smi))
    small_train_check(torch)
    attention_check(torch)
    fleet_launches, kept = fleet_phase(torch, smi)
    serve_launches = fleet_serve_phase(torch, smi, kept)
    session_launches = session_phase(torch, smi, kept)
    del kept
    torch.cuda.empty_cache()
    small_fleet_check(torch)
    small_session_check(torch)
    cli_drill_check(torch)
    sched_launches = scheduler_phase(torch, smi)
    small_scheduler_check(torch)
    paper_phase(torch, smi)
    # each kernel's launches over every main path that runs it
    for counts in (fleet_launches, serve_launches, session_launches, sched_launches):
        for kname, n in counts.items():
            launches[kname] = launches.get(kname, 0) + n
    for kname, n in launches.items():
        results[kname]["launches"] = n
    # the grouped forwards' launches on the main paths by row class, as the
    # wrappers counted them (on the tensor-core route, the geometry taken)
    for kname in ("grouped_skip_sum_fwd", "grouped_skip_sum_fwd_int8", "grouped_skip_sum_fwd_q4",
                  "grouped_skip_sum_fwd_actint8"):
        many, few = (MAIN_ROWS.get((kname, g), 0) for g in ("many_rows", "few_rows"))
        check(many + few == launches[kname], f"{kname}: {many} + {few} launches by row class != "
              f"{launches[kname]} launches")
        results[kname].update(launches_many_rows=many, launches_few_rows=few)
    check(len(results) == 10, f"{len(results)} kernels in the kernels line, not 10")
    check(all(r["launches"] is not None for r in results.values()), "a kernel has no launch count")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
