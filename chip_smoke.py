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
     ``--use-kernel``), modes full, int8 and freeze_a, one populate and two
     cached epochs, each CUDA-graph replays of one captured step
     (``core.lm_skiplora``) held bitwise against the eager loop
     (``loop=True``) run first from the same state (losses, adapters,
     moments, step count, cache rows), with its first-call, eager first
     step, capture and replay seconds beside the eager epoch's, and the
     caching allocator's device allocations and frees during the first
     call. K1 or K3, and K2, must launch exactly 8 times per cached epoch
     (the eager first step's launches counted as they run, each replayed
     step's by the launch tape; the eager comparisons' launches apart) and
     no kernel during populate or in
     mode freeze_a; losses finite and the cached-epoch mean loss falling; one cached step's adapter gradients with the kernels equal
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
     epochs, graph replays bitwise the same run as the eager loop
     (``fleet_finetune(loop=True)``; losses, adapters, moments, cache),
     seconds both ways: exactly 8 K5 + 8 K9 per populate epoch, 8 K5 (full) or K8 (int8)
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
     last position; ``adapt(epochs=3)`` on the scan path, 24 replays of one
     graph captured on the shard's device, 24 K5 and 24 K9, bitwise the
     fleet phase's graphed and eager runs;
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
     bitwise, the trained session's epoch replays only, the restored one
     capturing its own; save and restore seconds and the bytes on disk. A reduced
     float32 session (a control plane, a disk host tier) gives the same
     losses, adapters, gate decisions and tokens on the card as on the CPU,
     and, saved after its first gated adapt and restored into a fresh
     runtime, bitwise the uninterrupted run's on the card; an int4 pool
     round-trips its bytes and serves the same tokens through K7. The
     session CLI's crash drill (``repro_torch.launch.run --device cuda
     --use-kernel --checkpoint-dir D --inject-failure 3``, reduced) restarts
     exactly once, at event 3, and ends bitwise the unsupervised run.
 11b. shard: the session's data axis at full width on the session phase's
     inputs, ``placement_shards=2`` over [cuda:0] (``shard_phase``):
     round-robin placement and adapt groups [[0, 2], [1, 3]], each shard's
     adapt one graph of its own replayed 24 times, issued back to back
     before any write-back; exact launches a shard (ingest 16 K5 at few rows, ``adapt(epochs=3)`` 24 K5 at many
     rows + 24 K9, each 2-tenant group 8 steps an epoch; a continued epoch 8
     + 8; a serve one dispatch and 33 K5 at few rows); the adapters, moments
     and temperature-0 tokens bitwise the one-shard session's, the loss
     difference in float32 ulps printed; the session saved and restored
     into a fresh 2-shard runtime, both continuing bitwise, a 1-shard
     runtime refusing it; the scheduler on the shared-prefix trace with a
     live batch, a KV pool and K10 a shard, no leaks, tokens bitwise a
     one-shard scheduler's; over [cuda:0, cuda:1] when there are two cards
     (then 3 more adapt epochs of replays only, two cards against one;
     else one line says it did not run); a reduced 2-shard session card vs
     CPU. Adapt s an epoch with 1 and 2 shards, serve and scheduler tok/s,
     save and restore s, decode-graph captures and replays.
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
 12b. twins (``twins_phase``): ``repro_torch.examples.finetune_lm`` at its
     ~100M config (14 layers, d 576, vocab 50304, float32, 64 x 256, 4
     epochs: graph replays, losses falling, the cached-epoch speedup) and
     ``repro_torch.examples.serve_adapted`` (reduced gemma2-9b: every row of
     the mixed batch equal to single-tenant serving, 4/4), no hand-written
     kernel; ``launch.train``'s scan chunk with two reduced states of equal
     shapes alternated, each bitwise its own eager trajectory, tokens and
     labels unwritten.
 13. tooling (``kernels.autotune``, ``launch.roofline``, ``launch.train``),
     with the launch counters reset before and after it, so the kernels line
     counts the main paths only: ``tune_grouped`` of K5, K6 and K7 (int4,
     nf4) at the serve cell's decode step (4 rows in 4 slots) and fleet
     serving's (one row in each of 5 slots), and of K5 at the fleet step
     (M 1024 in 4 slots), every (tile, geometry) candidate timed beside its
     roofline prediction and holding the default's bits, from a cold cache
     under build/, then a warm pass that is all cache hits with the same
     choices; one winner installed (``apply_choice``) and reset;
     ``tune_decode_unroll`` (graph replays of 1, 2 or 4 dispatches) and
     ``tune_kv_block`` (K10) at full width. The full-backprop trainer
     (``launch.train --full --steps 4 --batch 8 --seq 128``) per step and
     with ``--scan-chunk 2`` (one CUDA-graph replay a chunk): losses finite
     and falling, the chunked losses and final parameters bitwise the
     per-step ones, step ms and peak memory. Then ``model_flops``, device ms
     and MFU_model against the card's bf16 peak for the cached and populate
     steps, a graphed decode step and the trainer's step, and the cached
     step's readout against the fp32 peak. The tuned defaults are the
     untuned ones afterwards.
 14. families (``families_phase``): the other model families, after the
     earlier phases' graphs and cached device memory are freed. K1, K2, K5
     and K9 against their plain versions at D 1024 and 1536 (the vector
     branches of the new widths). qwen2-moe-a2.7b at full width (24 layers,
     d 2048, 60 experts top-4 and a 5632-wide shared FFN, vocab 151936,
     seeded bf16 weights drawn on the card, RMSNorm scales 1): grouped
     serving of 3 tenants and a base row (exactly 33 K5 a call, graph ==
     eager loop, the base row equal to base ``generate``'s or apart at a
     near tie, from one prefill the replays bitwise the eager loop); the
     finetune launcher's loop in modes full and int8 (32 samples, batch 8,
     seq 128, a populate and two cached epochs, graph replays bitwise the
     eager loop, the populate again replays only, K1 or K3 and K2 exactly 4
     times a cached epoch, none during populate, the mean loss falling);
     one ``SessionRuntime`` round in mode int8 (2 K5 ingests, one adapt
     epoch of 2 K8 + 2 K9 steps, a serve of 33 K5). xlstm-350m (grouped
     serving, a populate and a cached epoch), paligemma-3b and
     musicgen-medium (``serve_prefill(prefix_embeds=)`` of seeded prefix
     embeddings, 256 and 64, then a graphed decode bitwise the eager loop;
     a populate and a cached epoch), each at full width. Reduced float32
     phi3.5-moe and jamba-1.5-large on the card and the CPU within 1e-5 of
     each output's largest value. Each family's epoch times, serve tok/s
     and peak GiB.
 15. model axis (``model_axis_phase``; ``models.tp``,
     ``runtime.pipeline_par``): qwen2-moe-a2.7b at full width (bf16, seeded,
     RMSNorm scales 1), its unsplit outputs first (prefill logits, the
     grouped serve's eager loop, which the graphed serve equals, the
     admission prefill, one cached-loss step), then split two ways over
     the group ``[cuda:0, cuda:0]`` (``sharding.shard_backbone``; the
     one-card form ``make_mesh`` refuses) and the unsplit params freed.
     Each member's bytes equal ``per_device_bytes`` of the spec tree, the
     whole over a member above 1.5; with the MoE routing pinned to the
     unsplit run's (``_routing``: a one-ulp change of a router input near
     a tie picks another expert), prefill logits within ``TP_LOGIT_BAR``
     of their largest value and the grouped serve's greedy tokens equal
     (float pool, ``use_kernel=False``, 3 tenants and a base row, 32 new,
     the caches split by the heads each member reads: ``tp.HeadSplit``),
     a flip allowed only where the unsplit run ranks the split's pick
     within ``TOP2_REL_TOL`` of its largest |logit| below its argmax (the
     near-tie rule of ``_near_tie_flips``) and the two tokens' own
     differences, within the bar, cover that gap; the
     routing flips and the unpinned differences printed beside them; the
     cached-loss step's loss and adapter gradients within ``TP_LOSS_BAR``
     / ``TP_GRAD_BAR``; the split's own routing unpinned in float32 at
     reduced width (``_model_axis_fp32``: hidden and logits within
     ``TP_FP32_BAR``, greedy serve tokens equal); ``lm.pipeline_sched_prefill``
     with 2 stages on ``[cuda:0, cuda:0]`` against ``sched_prefill`` a
     microbatch at a time within ``PIPE_LOGIT_BAR`` and within
     ``PIPE_SKIP_SHARE`` of what the adapters' skip terms move the logits
     by, tokens equal. Host seconds of each, the peak. No hand-written
     kernel launches (a model axis refuses them, as in the reference).
     With two cards: the reduced float32 (1 x 2) session over
     ``[cuda:0, cuda:1]`` (``make_mesh``), with ``pipeline_stages=2`` and
     without, against the same over ``["cpu", "cpu"]``, and
     phi3.5-moe-42b-a6.6b at full width over them, drawn a part at a time
     and split as it comes (``tp.init_group_params``; each card at most
     0.55 of its 83.75 GB), one ingest / adapt / serve round with its
     tok/s; on one card a line says that part did not run.
 16. dryrun (``dryrun_phase``; ``launch.steps``, ``launch.op_analysis``,
     ``launch.dryrun``, ``optim.quantized``, the recurrent mixers of
     ``models.tp``): ``dryrun.run_cell`` on the 16 x 16 meta mesh for one
     cell of each step kind (stablelm-1.6b's six, xlstm-350m x long_500k,
     jamba-1.5-large-398b x decode_32k), in ``DRY_WORKERS`` worker
     processes that touch no card, each record's line printed. Meanwhile
     stablelm-1.6b cells a card holds (``DRY_CARD``) on a 1 x 1 mesh of
     ``[cuda:0]`` and a 1 x 2 group ``[cuda:0, cuda:0]``, each counted on
     meta and for real under the same ``OpCounter``: dot FLOPs and
     collective bytes equal exactly, the argument bytes equal the
     allocator's (each storage rounded to its 512-B block; on 1 x 1 also
     the spec trees' count), ``max_memory_allocated`` over the step within
     ``DRY_PEAK_BAND`` of argument + new storages' peak (all members); each
     step's device time (CUDA events after a warm-up), its MFU
     (``roofline.mfu``) and counted dot FLOPs against ``model_flops``.
     xlstm-350m at full width split two ways over ``[cuda:0, cuda:0]``
     against the unsplit run: member bytes == ``per_device_bytes``; in
     float32 a 4 x 128 prefill's logits within ``XLSTM_FP32_LOGIT_BAR``,
     greedy grouped serve tokens equal but near ties (``_split_flips``), a
     cached-loss step within ``XLSTM_FP32_LOSS_BAR`` / ``XLSTM_FP32_GRAD_BAR``;
     in bf16 the split's and the unsplit run's prefill logits are printed, not
     held to a bar (random full-width weights put the bf16 model itself 0.3
     of the largest logit from its float32 twin). ``int8_adamw``:
     three steps on a full-width stablelm block's parameters on the card
     against the CPU (updates within ``QUANT_UPDATE_BAR``, moment codes at
     most one step apart, the count printed, the moments' bytes against
     fp32); ``compress_grads`` / ``decompress_grads`` /
     ``error_feedback_residual`` bitwise the CPU's. No hand-written kernel
     launches. The phase's time is printed.
 17. remat / context parallel (``remat_cp_phase``; ``models.remat``, the
     sequence split of ``models.tp``): each rematerialised measurement of
     the earlier phases against the same one with ``remat.region`` a plain
     call (the un-rematerialised parent) in this process: the dry-run's
     train 8 x 512 card cells on 1 x 1 and 1 x 2 (meta == card counts,
     peak / counted within ``DRY_PEAK_BAND``, step ms, peak), the
     full-backprop trainer (4 steps, losses bitwise, step ms, peak) and a
     populate epoch of the train phase's launcher (losses bitwise, seconds).
     paligemma-3b at full width (bf16, one KV head) split two ways over
     ``[cuda:0, cuda:0]``, its K/V caches split by sequence: the dry-run's
     decode 32 x 2048 card cell on the 1 x 2 group (meta == card, the
     arguments the allocator's, each member's part 1024 positions, member
     bytes == ``per_device_bytes``); greedy grouped serving from a 4 x 128
     prefill, 32 new tokens, equal to the unsplit run's but near ties
     (``_split_flips``); a reduced float32 copy's decode logits within
     ``CP_LOGIT_BAR`` of the same group with whole caches. Host seconds, no
     hand-written kernel launches, the phase's time.
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

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from collections import Counter
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
        if compress is None:
            STEP_MS["decode"] = _decode_step_ms(torch, cfg, params, prompts, pool, idx)
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


#: device ms of the steps the main paths run at full width (CUDA events,
#: L2 flushed), for the roofline lines of the tooling phase
STEP_MS: dict = {}


def _decode_step_ms(torch, cfg, params, prompts, pool, idx):
    """Device ms of one graphed decode step of the serve cell: one replay of
    a graph of all NEW steps (``decode_scan`` at unroll NEW) over one
    prefill's caches, divided by NEW. The steps write K/V at positions
    PROMPT to PROMPT + NEW - 1 and read only the positions before their own,
    so every call does the same work over the same caches."""
    from repro_torch.models import lm as LM

    b, s = prompts.shape
    caches = LM.init_serve_caches(cfg, b, s + NEW, device=prompts.device)
    logits, caches = LM.serve_prefill_grouped(params, cfg, prompts, caches, pool.pools(), idx)
    tok0 = LM.sample_token(logits, 0.0)
    run = lambda: LM.decode_scan(params, cfg, tok0, s, caches, max_new=NEW, pools=pool.pools(),  # noqa: E731
                                 idx=idx, unroll=NEW)
    return time_ms(run, reps=5, spin=STEP_SPIN) / NEW


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


def _graph_gain(stats, since) -> dict:
    """What a ``GraphCache``'s stats gained since the copy ``since``:
    captures, eager first steps, replays and their host seconds."""
    got = stats.copy()
    got.subtract(since)
    return {k: got[k] for k in ("captures", "first_steps", "replays", "capture_s", "first_step_s", "replay_s",
                                "warmup_launches")}


def _allocs(torch, since: dict) -> dict:
    """What the caching allocator did since the copy ``since`` of
    ``torch.cuda.memory_stats()``: device allocations (``cudaMalloc``),
    their bytes, device frees and retries after a failed allocation."""
    now = torch.cuda.memory_stats()
    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries", "reserved_bytes.all.allocated")
    return {k: now.get(k, 0) - since.get(k, 0) for k in keys}


def _same(torch, a, b) -> bool:
    """Two lists of tensors, equal bit for bit."""
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _state_leaves(trainable, opt_state, cache=None):
    from repro_torch.optim.optimizers import tree_leaves

    out = tree_leaves(trainable) + [opt_state.step] + tree_leaves(opt_state.mu) + tree_leaves(opt_state.nu)
    if cache is not None:
        out += list(cache.slots.values()) + [cache.valid]
    return out


#: the launches of the eager comparisons, by phase (not main-path launches:
#: they run the same wrappers to hold the graphs against)
EAGER_LAUNCHES: dict[str, int] = {}


def _eager_epoch(torch, run, epoch):
    """The launcher run's next epoch as the eager loop (``loop=True``) from
    the run's state, into a fresh cache copy when it populates: (losses,
    trainable, opt_state, cache or None, seconds, ``_allocs`` of the
    epoch). Its launches go to ``EAGER_LAUNCHES``, not the counters."""
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.launch import finetune as FT
    from repro_torch.optim.optimizers import adamw

    opt = adamw(run.args.lr)
    idx_mat = FT.epoch_index_matrix(epoch, run.args.samples, run.args.batch, run.device)
    cache = None
    if epoch == 0:
        cache = SL.SkipCache(slots={k: v.clone() for k, v in run.cache.slots.items()}, valid=run.cache.valid.clone())
    torch.cuda.synchronize()
    _reset_launches()
    mem = torch.cuda.memory_stats()
    t0 = time.perf_counter()
    if epoch == 0:
        t, o, cache, ls = SL.make_populate_epoch(run.cfg, run.sl, opt, loop=True)(
            run.params, run.trainable, run.static, run.opt_state, cache, run.tokens, run.labels, idx_mat)
    else:
        t, o, ls = SL.make_cached_epoch(run.cfg, run.sl, opt, loop=True)(
            run.params, run.trainable, run.static, run.opt_state, run.cache, idx_mat)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    EAGER_LAUNCHES["train"] = EAGER_LAUNCHES.get("train", 0) + sum(_launches().values())
    _reset_launches()
    return ls, t, o, cache, dt, _allocs(torch, mem)


def _train_epochs(torch, run, what, steps):
    """Every epoch of ``run`` through the finetune launcher's own
    ``run_epoch`` (CUDA-graph replays, ``core.lm_skiplora``), each first
    run as the eager loop from the same state: losses, adapters, moments,
    step count and (populating) cache rows bitwise the eager epoch's; no
    kernel during populate, K1 (K3 in mode int8) and K2 exactly ``steps``
    times each cached epoch (none in mode freeze_a), the eager first
    step's launches counted as they run and the replayed steps' by the
    launch tape; ``steps`` finite losses an epoch, and the
    mean loss falling over the cached epochs (from populate when there is
    one cached epoch). Returns (launches of K1 or K3 and K2, graphed epoch
    seconds, mean losses, [(graph stats gained, eager seconds)] an epoch)."""
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.launch import finetune as FT

    check(run.device.type == "cuda", f"{what}: the launcher runs on {run.device}, not the card")
    fwd = {"int8": "skip_lora_fwd_int8", "full": "skip_lora_fwd"}.get(run.args.mode)
    totals = {k: 0 for k in (fwd, "skip_lora_bwd") if k}
    times, means, graphs = [], [], []
    for epoch in range(run.args.epochs):
        e_ls, e_t, e_o, e_cache, e_s, e_mem = _eager_epoch(torch, run, epoch)
        since, mem = SL.GRAPHS.stats.copy(), torch.cuda.memory_stats()
        t0 = time.perf_counter()
        losses = FT.run_epoch(run, epoch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        gain = _graph_gain(SL.GRAPHS.stats, since)
        gain["allocs"], gain["eager_allocs"] = _allocs(torch, mem), e_mem
        # an epoch that captures runs its first step eagerly and replays the rest
        first = epoch < 2
        check(gain["captures"] == first and gain["first_steps"] == first and gain["replays"] == steps - first,
              f"{what} epoch {epoch}: graph stats {gain}, not {steps - first} replays")
        graphs.append((gain, e_s))
        counts = _launches()
        want = {k: 0 for k in counts}
        if epoch > 0 and fwd:
            want[fwd] = want["skip_lora_bwd"] = steps
        check(counts == want, f"{what} epoch {epoch}: launches {counts} != {want}")
        for k in totals:
            totals[k] += counts[k]
        check(tuple(losses.shape) == (steps,) and bool(torch.isfinite(losses).all()),
              f"{what} epoch {epoch}: losses {losses.tolist()}")
        check(torch.equal(losses, e_ls), f"{what} epoch {epoch}: graphed losses {losses.tolist()} != the eager "
              f"loop's {e_ls.tolist()}")
        check(_same(torch, _state_leaves(run.trainable, run.opt_state, run.cache if epoch == 0 else None),
                    _state_leaves(e_t, e_o, e_cache)),
              f"{what} epoch {epoch}: adapters, moments or cache rows differ from the eager loop's")
        del e_ls, e_t, e_o, e_cache
        if epoch == 0:
            REMAT_SEEN[what] = (times[0], losses.cpu())
        means.append(float(losses.mean()))
    falling = means[1:] if len(means) > 2 else means
    check(all(b < a for a, b in zip(falling, falling[1:])), f"{what}: mean losses {means} do not fall")
    return totals, times, means, graphs


def _graph_line(times, graphs) -> str:
    """Each epoch's graphed seconds split into the eager first step,
    capture and the host time of issuing the replays, beside the eager
    loop's seconds."""
    parts = []
    for e, (t, (g, eager_s)) in enumerate(zip(times, graphs)):
        kind = "populate" if e == 0 else "cached"
        first = f"first step {g['first_step_s']:.3f} + capture {g['capture_s']:.3f} + " if g["captures"] else ""
        a = g.get("allocs")
        mallocs = (f"; {a['num_device_alloc']} cudaMalloc ({a['reserved_bytes.all.allocated'] / 2**30:.2f} GiB), "
                   f"{a['num_device_free']} cudaFree, {a['num_alloc_retries']} retries" if a and g["captures"] else "")
        ea = g.get("eager_allocs")
        eager = f" ({ea['num_device_alloc']} cudaMalloc)" if ea and g["captures"] else ""
        parts.append(f"{kind} {t:.3f} s ({first}replays issued {g['replay_s']:.3f}{mallocs}) vs eager {eager_s:.3f} s"
                     f"{eager}")
    return "; ".join(parts)


def train_phase(torch, device_name):
    """Populate + 2 cached epochs per mode through the launcher's own
    functions, each epoch graphed and held against the eager loop; returns
    each kernel's launches over the phase's epochs."""
    from repro_torch.launch import finetune as FT

    totals = {"skip_lora_fwd": 0, "skip_lora_bwd": 0, "skip_lora_fwd_int8": 0, "flash_attn_fwd": 0}
    for mode, fwd in (("full", "skip_lora_fwd"), ("int8", "skip_lora_fwd_int8"), ("freeze_a", None)):
        run = FT.prepare(FT.parse_args([*TRAIN_ARGS, "--mode", mode]))
        counts, times, means, graphs = _train_epochs(torch, run, f"train {mode}", TRAIN_STEPS)
        for k, n in counts.items():
            totals[k] += n
        speedup = times[0] / (sum(times[1:]) / 2)
        kernels = (f"launches per cached epoch: {fwd} {TRAIN_STEPS}, skip_lora_bwd {TRAIN_STEPS}; during "
                   "populate: none") if fwd else "no hand-written kernel (freeze_a)"
        print(f"train {ARCH} full width mode={mode} --use-kernel on {device_name}: 64 samples, batch 8, "
              f"seq 128, rank {RANK}: populate epoch {times[0]:.3f} s, cached epochs {times[1]:.3f} / "
              f"{times[2]:.3f} s, cached-epoch speedup {speedup:.2f}x; mean losses "
              f"{' / '.join(f'{v:.4f}' for v in means)}; {kernels}")
        print(f"train graphs mode={mode} on {device_name}: every epoch CUDA-graph replays, bitwise the eager loop "
              f"from the same state (losses, adapters, moments, step, cache rows): {_graph_line(times, graphs)}")
        if fwd:
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
    STEP_MS[f"finetune_cached {mode}"] = total
    STEP_MS[f"finetune_populate {mode}"] = ms["populate"]
    STEP_MS[f"readout {mode}"] = ms["readout"]
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
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.launch import fleet as FL

    totals = {k: 0 for k in ("grouped_skip_sum_fwd", "grouped_skip_sum_fwd_actint8", "grouped_skip_sum_bwd")}
    kept = None
    for mode, fwd in (("full", "grouped_skip_sum_fwd"), ("int8", "grouped_skip_sum_fwd_actint8")):
        args = FL.parse_args([*FLEET_ARGS, "--mode", mode])
        cfg, sl = FL.setup(args)
        dev = torch.device(args.device)
        check(dev.type == "cuda", f"the fleet launcher runs on {dev}, not the card")
        params, tokens, labels = FL.make_inputs(args, cfg, dev)

        gains, since = [], [SL.GRAPHS.stats.copy()]

        def on_epoch(epoch, losses, seconds, fwd=fwd, mode=mode):
            torch.cuda.synchronize()
            gains.append(_graph_gain(SL.GRAPHS.stats, since[0]))
            since[0] = SL.GRAPHS.stats.copy()
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
        check([g["replays"] for g in gains] == [FLEET_STEPS - 1, FLEET_STEPS - 1, FLEET_STEPS]
              and [g["captures"] for g in gains] == [1, 1, 0],
              f"fleet {mode}: graph stats by epoch {gains}")
        eager = _fleet_eager(torch, args, cfg, sl, params, tokens, labels, res, mode)
        split = _graph_line(times, list(zip(gains, eager.epoch_times_s)))
        print(f"fleet graphs mode={mode} on {device_name}: every epoch CUDA-graph replays, bitwise the eager loop "
              f"(losses, adapters, moments, step, cache rows): {split}")
        _fleet_grad_check(torch, cfg, sl, params, res, mode)
        _fleet_step_split(torch, cfg, sl, params, res, device_name, mode)
        res.cache = None
        if mode == "full":
            kept = dict(cfg=cfg, sl=sl, params=params, tokens=tokens, labels=labels, adapters=res.adapters,
                        losses=losses, times=times, eager_adapters=eager.adapters, eager_losses=eager.losses)
        del params, res, out, eager
        torch.cuda.empty_cache()
    return totals, kept


def _fleet_eager(torch, args, cfg, sl, params, tokens, labels, res, mode):
    """The fleet launcher's offline run again as the eager loop
    (``fleet_finetune(loop=True)``) on the same inputs and seed: its
    losses, adapters, moments, step count and cache bitwise the graphed
    run's ``res``. Its launches go to ``EAGER_LAUNCHES``. Returns the eager
    run's ``FleetResult`` (its cache dropped)."""
    from repro_torch.core import fleet_finetune as FF
    from repro_torch.optim.optimizers import adamw

    import numpy as np

    dev = params["embed"]["table"].device
    torch.cuda.synchronize()
    _reset_launches()
    ref = FF.fleet_finetune(torch.Generator(device=dev).manual_seed(3), cfg, sl, params, tokens, labels,
                            epochs=args.epochs, batch_per_tenant=min(args.batch_per_tenant, args.samples),
                            optimizer=adamw(args.lr), use_kernel=args.use_kernel, loop=True)
    torch.cuda.synchronize()
    EAGER_LAUNCHES["fleet"] = EAGER_LAUNCHES.get("fleet", 0) + sum(_launches().values())
    _reset_launches()
    check(np.array_equal(ref.losses, res.losses), f"fleet {mode}: graphed losses differ from the eager loop's "
          f"(max {np.abs(ref.losses - res.losses).max():.3e})")
    check(_same(torch, _state_leaves(res.adapters, res.opt_state, res.cache),
                _state_leaves(ref.adapters, ref.opt_state, ref.cache)),
          f"fleet {mode}: adapters, moments or cache rows differ from the eager loop's")
    ref.cache = None
    return ref


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

    graph_gains = {}

    def adapt(rt, fwd, path):
        torch.cuda.synchronize()
        since = rt.epoch_graph_stats()
        t0 = time.perf_counter()
        out = rt.adapt(epochs=3, batch_per_tenant=FLEET_BPT, generator=torch.Generator(device=dev).manual_seed(3))
        dt = time.perf_counter() - t0                     # the losses are on the host: the epochs have ended
        gain = graph_gains[fwd, path] = _graph_gain(rt.epoch_graph_stats(), since)
        # the resident path replays one captured step a step after the first,
        # which runs eagerly; the stream path stays eager
        want = (1, n_steps - 1) if path == "scan" else (0, 0)
        check((gain["captures"], gain["replays"]) == want, f"session adapt {path}: graph stats {gain}")
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
            since = r.epoch_graph_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(r.adapt(epochs=1, batch_per_tenant=FLEET_BPT))
            graph_gains["continued", r is rt] = (_graph_gain(r.epoch_graph_stats(), since), time.perf_counter() - t0)
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
        # the one-shard session after its 4th epoch and serve: the shard phase's bar
        kept["one_shard"] = dict(
            losses=outs[0]["losses"], tokens=toks[0],
            tenants={t: {name: dict(getattr(rt.tenant(t), name)) for name in ("adapters", "opt_mu", "opt_nu")}
                     for t in range(FLEET_TENANTS)},
        )
        return spans, nbytes, rows, twin.engine.row_nbytes()

    _reset_launches()
    # -- mode full, resident engine --------------------------------------------
    rt = runtime("full")
    base = rt.serve([None] * len(who), prompts, max_new=NEW)
    window({})
    rate, ingest_ms, logit_err = ingest_all(rt, "grouped_skip_sum_fwd", compare=True)
    losses, scan_s = adapt(rt, "grouped_skip_sum_fwd", "scan")
    kept.update(session_prompts=prompts, session_base=base, session_scan_s=scan_s)
    scan_hit = rt.engine.stats.hbm_hit_rate()
    check(np.array_equal(losses, kept["losses"]), "session: per-step losses != the offline fleet_finetune's "
          f"(max diff {np.abs(losses - kept['losses']).max():.3e})")
    check(np.array_equal(losses, kept["eager_losses"]), "session: per-step losses != the offline eager loop's")
    for k in ("A", "B"):
        for t in range(FLEET_TENANTS):
            check(torch.equal(rt.tenant(t).adapters[k], kept["adapters"][k][t])
                  and torch.equal(rt.tenant(t).adapters[k], kept["eager_adapters"][k][t]),
                  f"session: tenant {t} adapters {k} != the offline fleet_finetune's (graphed and eager)")
    g = graph_gains["grouped_skip_sum_fwd", "scan"]
    print(f"session graphs {ARCH} full width mode=full on {device_name}: adapt(epochs=3) on the scan path is "
          f"{g['replays']} step replays of {g['captures']} graph captured on the shard's device, {scan_s:.3f} s "
          f"(eager first step {g['first_step_s']:.3f} + capture {g['capture_s']:.3f} + replays issued "
          f"{g['replay_s']:.3f} s); losses and adapters bitwise the offline "
          f"fleet_finetune's, graphed and eager loop")
    pool = AdapterPool(FLEET_TENANTS + 1, cfg, RANK, device=dev)
    write_back_to_pool(pool, list(range(FLEET_TENANTS)), kept["adapters"])
    check(all(torch.equal(v, pool.pools()[k]) for k, v in rt.pool.pools().items()),
          "session: pool slots != write_back_to_pool's")
    resident = {t: dict(rt.tenant(t).adapters) for t in range(FLEET_TENANTS)}
    trained0 = resident[0]
    del pool
    ckpt = checkpoint_round_trip(rt)
    (g_rt, s_rt), (g_tw, s_tw) = graph_gains["continued", True], graph_gains["continued", False]
    check(g_rt["captures"] == 0 and g_rt["replays"] == FLEET_STEPS and g_tw["captures"] == 1
          and g_tw["replays"] == FLEET_STEPS - 1, f"session continued epoch: graph stats {g_rt} / restored {g_tw}")
    print(f"session graphs, one continued adapt epoch on {device_name}: the trained session {s_rt:.3f} s, replays "
          f"only ({g_rt['replays']} issued in {g_rt['replay_s']:.3f} s); the restored session {s_tw:.3f} s, its own "
          f"graph (eager first step {g_tw['first_step_s']:.3f} + capture {g_tw['capture_s']:.3f} s); ingest frees "
          "a shard's "
          "graphs with its export")
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
# Phase 11b: the session's data axis (logical shards)
# ---------------------------------------------------------------------------

SHARDS = 2


def _ulps(a, b) -> int:
    """Largest distance in float32 ulps between two arrays of one sign each."""
    import numpy as np

    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


class _PerShard:
    """Each call of the wrapped runtime or scheduler methods, synchronised on
    both sides, adds its launches (and the grouped forwards' launches by row
    class, and the scheduler's dispatch counters) to its shard's tally."""

    def __init__(self, torch):
        self.torch = torch
        self.launches: dict[int, dict] = {}
        self.rows: dict[int, dict] = {}
        self.counters: dict[int, dict] = {}
        self._wrapped: list = []

    def wrap(self, obj, name, shard_of, counters=None):
        from repro_torch.kernels.skip_lora import kernel as K

        real = getattr(obj, name)
        torch = self.torch

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            l0, r0 = _launches(), dict(K.ROW_LAUNCHES)
            c0 = dict(counters) if counters is not None else {}
            out = real(*a, **kw)
            torch.cuda.synchronize()
            s = shard_of(*a, **kw)
            for tally, now, then in ((self.launches, _launches(), l0), (self.rows, dict(K.ROW_LAUNCHES), r0),
                                     (self.counters, dict(counters) if counters is not None else {}, c0)):
                mine = tally.setdefault(s, {})
                for k, v in now.items():
                    if v - then.get(k, 0):
                        mine[k] = mine.get(k, 0) + v - then.get(k, 0)
            return out

        setattr(obj, name, wrapper)
        self._wrapped.append((obj, name))

    def take(self) -> tuple[dict, dict, dict]:
        """(launches, row launches, counters) by shard since the last take."""
        out = (self.launches, self.rows, self.counters)
        self.launches, self.rows, self.counters = {}, {}, {}
        return out

    def unwrap(self):
        for obj, name in self._wrapped:
            delattr(obj, name)
        self._wrapped.clear()


def shard_phase(torch, device_name, kept):
    """The session's data axis at full width on the session phase's inputs
    (stablelm-1.6b, 24 layers, d 2048; 4 tenants x 16 samples x seq 128,
    batch per tenant 2, rank 8, fp32 cache, ``use_kernel=True``), with
    ``placement_shards=2`` over ``[cuda:0]``:
      - placement: tenants and partitions round robin (tenant t on shard
        t % 2, partition t), adapt groups [[0, 2], [1, 3]];
      - the base serve equals the one-shard session's; 32 ingests, 16 a
        shard, one K5 each at few rows; ``adapt(epochs=3)``: each shard's
        2-tenant group runs 8 steps an epoch, so 24 K5 at many rows and 24 K9
        a shard; the adapters equal the one-shard session's (the offline
        fleet's) bitwise, and the largest loss difference in float32 ulps is
        printed (the groups' readout runs at M 512, the one-shard group's at
        M 1024);
      - save and restore: the 2-shard session saved under build/ and
        restored into a fresh 2-shard runtime (64 rows over both engines,
        slot tables equal); restoring it into a 1-shard runtime raises; both
        run one more epoch (8 K5 many rows + 8 K9 a shard each) and a serve
        of the 4 tenants and a base row (one dispatch a shard, 33 K5 at few
        rows each): losses, adapters, moments, pools, slot tables and tokens
        bitwise between them, and adapters, moments and tokens bitwise the
        one-shard session's after its 4th epoch;
      - the scheduler over the restored 2-shard session on the shared-prefix
        trace (8 requests of tenants 0..3 in turn, reuse on, batch 4 a
        shard): a live batch and a KV pool a shard, K10 twice a reuse wave
        and K5 as each shard's dispatch counters imply, no leaks on either
        shard, temperature-0 tokens bitwise a one-shard scheduler's over the
        same adapters;
      - over two cards when the machine has them: the same session over
        ``[cuda:0, cuda:1]`` equal to the 1-card session bitwise (the
        ``--check-parity`` bar) and an elastic 2 -> 1 restore that continues
        bitwise; otherwise one line saying it did not run.
    Prints adapt s an epoch with 1 and 2 shards, serve and scheduler tokens/s,
    save and restore s, and the decode graphs' captures and replays. Returns
    each kernel's launches."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.checkpoint import restore_runtime_session, save_runtime_session
    from repro_torch.core import decode_graph as DG
    from repro_torch.core.runtime import SessionRuntime
    from repro_torch.launch import fleet as FL
    from repro_torch.optim.optimizers import adamw
    from repro_torch.runtime.sharding import make_mesh

    dev = torch.device("cuda")
    cfg, params, tokens, labels = (kept[k] for k in ("cfg", "params", "tokens", "labels"))
    prompts, base_one, one = kept["session_prompts"], kept["session_base"], kept["one_shard"]
    who = list(range(FLEET_TENANTS)) + [None]
    sl = FL.setup(FL.parse_args([*FLEET_ARGS, "--mode", "full"]))[1]
    graphs0 = dict(DG.GRAPHS.stats)
    totals: dict[str, int] = {}
    tally = _PerShard(torch)

    def runtime(devices=(dev,), shards=SHARDS, **kw):
        mesh = make_mesh((len(devices),), ("data",), devices=list(devices))
        return SessionRuntime(cfg, sl, params, max_tenants=FLEET_TENANTS, samples_per_tenant=FLEET_SAMPLES,
                              seq=FLEET_SEQ, optimizer=adamw(1e-3), use_kernel=True, mesh=mesh,
                              placement_shards=shards, **kw)

    def watch(rt):
        tally.wrap(rt, "ingest", lambda tenant, *a: rt.pool.shard_of(tenant))
        tally.wrap(rt, "_adapt_epochs", lambda group, spt, shard, **kw: shard)
        tally.wrap(rt, "_serve_shard", lambda s, *a, **kw: s)

    def held(what, want_launches, want_rows, taken=None):
        """Hold this window's launches by shard (each shard: kernel -> count)
        and the grouped forwards' by shard and row class (``taken``: a
        ``tally.take()`` already made)."""
        torch.cuda.synchronize()
        got, rows, _ = taken if taken is not None else tally.take()
        check(got == want_launches, f"shard {what}: launches by shard {got} != {want_launches}")
        check(rows == want_rows, f"shard {what}: grouped forwards by shard and row class {rows} != {want_rows}")
        counts = _launches()
        check(sum(counts.values()) == sum(n for s in got.values() for n in s.values()),
              f"shard {what}: {counts} launched outside the per-shard calls")
        for key, n in _merge_rows(rows).items():
            MAIN_ROWS[key] = MAIN_ROWS.get(key, 0) + n
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
        _reset_launches()

    fwd, bwd = "grouped_skip_sum_fwd", "grouped_skip_sum_bwd"
    per = FLEET_TENANTS // SHARDS
    both = range(SHARDS)
    _reset_launches()
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="shard_ckpt_", dir=ROOT / "build")
    try:
        # -- placement, ingest, adapt ------------------------------------------
        rt = runtime()
        watch(rt)
        base = rt.serve([None] * len(who), prompts, max_new=NEW)
        check(torch.equal(base, base_one), "shard: the base serve differs from the one-shard session's")
        held("base serve", {}, {})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(FLEET_TENANTS):
            for lo in range(0, FLEET_SAMPLES, FLEET_BPT):
                rt.ingest(t, tokens[t, lo:lo + FLEET_BPT], labels[t, lo:lo + FLEET_BPT])
        torch.cuda.synchronize()
        ingest_rate = FLEET_TENANTS * FLEET_SAMPLES / (time.perf_counter() - t0)
        n_ing = per * FLEET_SAMPLES // FLEET_BPT
        held("ingest", {s: {fwd: n_ing} for s in both}, {s: {(fwd, "few_rows"): n_ing} for s in both})
        check([rt.tenant(t).partition for t in range(FLEET_TENANTS)] == list(range(FLEET_TENANTS))
              and [rt.pool.shard_of(t) for t in range(FLEET_TENANTS)] == [t % SHARDS for t in range(FLEET_TENANTS)]
              and [len(e._present) for e in rt.engines] == [per * FLEET_SAMPLES] * SHARDS,
              "shard: tenants, partitions or cache rows not round robin")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rt.adapt(epochs=3, batch_per_tenant=FLEET_BPT, generator=torch.Generator(device=dev).manual_seed(3))
        adapt_s = time.perf_counter() - t0            # the losses are on the host: the epochs have ended
        steps = 3 * FLEET_STEPS
        shard_graphs = [_graph_gain(rt.epoch_graph_stats(s), Counter()) for s in both]
        check(all(g["captures"] == 1 and g["replays"] == steps - 1 for g in shard_graphs),
              f"shard adapt: each shard's graphs {shard_graphs}, not one capture and {steps - 1} replays")
        held("adapt", {s: {fwd: steps, bwd: steps} for s in both}, {s: {(fwd, "many_rows"): steps} for s in both})
        check(out["groups"] == [[0, 2], [1, 3]] and out["path"] == "scan",
              f"shard adapt: groups {out['groups']} on the {out['path']} path")
        losses = np.stack([out["losses"][t] for t in range(FLEET_TENANTS)], axis=-1)
        loss_ulps = _ulps(losses, kept["losses"])
        loss_diff = float(np.abs(losses - kept["losses"]).max())
        for t in range(FLEET_TENANTS):
            for k in ("A", "B"):
                check(torch.equal(rt.tenant(t).adapters[k], kept["adapters"][k][t]),
                      f"shard adapt: tenant {t} adapters {k} != the one-shard session's (max diff "
                      f"{(rt.tenant(t).adapters[k] - kept['adapters'][k][t]).abs().max().item():.3e}; "
                      f"losses {loss_ulps} ulps apart)")
        after3 = {t: dict(rt.tenant(t).adapters) for t in range(FLEET_TENANTS)}
        check(all(torch.equal(after3[t][k], kept["eager_adapters"][k][t])
                  for t in range(FLEET_TENANTS) for k in ("A", "B")),
              "shard adapt: adapters differ from the offline eager loop's")
        print(f"shard graphs on {device_name}: adapt(epochs=3) is each shard's own graph (captured on its device, "
              f"{' / '.join(str(g['captures']) for g in shard_graphs)} capture(s)) replayed "
              f"{' / '.join(str(g['replays']) for g in shard_graphs)} times, the shards' replays issued back to "
              f"back before any write-back; {adapt_s:.3f} s (eager first steps "
              f"{sum(g['first_step_s'] for g in shard_graphs):.3f} + capture "
              f"{sum(g['capture_s'] for g in shard_graphs):.3f} s); adapters bitwise the one-shard session's and "
              f"the offline eager loop's")

        # -- save, restore, continue --------------------------------------------
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_runtime_session(scratch, 1, rt)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        twin = runtime()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_runtime_session(path, twin)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        watch(twin)
        check(sum(len(e._present) for e in twin.engines) == FLEET_TENANTS * FLEET_SAMPLES
              and twin.pool.slot_table() == rt.pool.slot_table() and twin.pool.slot_table()["n_shards"] == SHARDS,
              "shard checkpoint: rows or slot tables not restored")
        lone = runtime(shards=1)
        try:
            restore_runtime_session(path, lone)
            fail("shard checkpoint: a 2-shard capture restored into a 1-shard runtime")
        except ValueError as err:
            check("layout" in str(err), f"shard checkpoint: 1-shard restore raised {err}")
        del lone
        torch.cuda.empty_cache()
        held("checkpoint", {}, {})
        outs, toks, serve_s = [], [], []
        for r in (rt, twin):
            outs.append(r.adapt(epochs=1, batch_per_tenant=FLEET_BPT))
            held("continued epoch", {s: {fwd: FLEET_STEPS, bwd: FLEET_STEPS} for s in both},
                 {s: {(fwd, "many_rows"): FLEET_STEPS} for s in both})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks.append(r.serve(who, prompts, max_new=NEW))
            torch.cuda.synchronize()
            serve_s.append(time.perf_counter() - t0)
            held("serve", {s: {fwd: 1 + NEW} for s in both}, {s: {(fwd, "few_rows"): 1 + NEW} for s in both})
        for t in range(FLEET_TENANTS):
            check(np.array_equal(outs[0]["losses"][t], outs[1]["losses"][t]),
                  f"shard checkpoint: tenant {t} continued losses differ")
            for name in ("adapters", "opt_mu", "opt_nu"):
                for k in ("A", "B"):
                    mine = getattr(rt.tenant(t), name)[k]
                    check(torch.equal(mine, getattr(twin.tenant(t), name)[k]),
                          f"shard checkpoint: tenant {t} {name} {k} differ after the continued epoch")
                    check(torch.equal(mine, one["tenants"][t][name][k]),
                          f"shard: tenant {t} {name} {k} after 4 epochs != the one-shard session's")
        check(all(torch.equal(v, twin.pool.shard_pools(s)[k]) for s in both for k, v in rt.pool.shard_pools(s).items())
              and rt.pool.slot_table() == twin.pool.slot_table(), "shard checkpoint: pools differ")
        check(torch.equal(toks[0], toks[1]) and torch.equal(toks[0], one["tokens"]),
              "shard: temperature-0 tokens differ between the 2-shard session, its restored twin and the "
              "one-shard session")
        loss4_ulps = max(_ulps(outs[0]["losses"][t], one["losses"][t]) for t in range(FLEET_TENANTS))
        check(rt.counters["serve/shard_dispatches"] == SHARDS, f"shard: {dict(rt.counters)}")
        after4 = dict(tenants={t: {name: dict(getattr(rt.tenant(t), name)) for name in ("adapters", "opt_mu",
                                                                                         "opt_nu")}
                               for t in range(FLEET_TENANTS)}, tokens=toks[0], adapters3=after3)
        tally.unwrap()
        del rt
        torch.cuda.empty_cache()

        # -- the scheduler: a live batch and a KV pool a shard ---------------------
        sched_out = _shard_scheduler(torch, twin, tally, held, prompts, who)
        del twin
        torch.cuda.empty_cache()

        # -- two cards ----------------------------------------------------------------
        if torch.cuda.device_count() >= 2:
            two = _two_cards(torch, runtime, after4, tokens, labels, prompts, who, scratch)
        else:
            two = None
    finally:
        tally.unwrap()
        shutil.rmtree(scratch, ignore_errors=True)
    graphs = {k: DG.GRAPHS.stats.get(k, 0) - graphs0.get(k, 0) for k in ("captures", "replays", "hits", "misses",
                                                                          "evictions")}
    rd_diff, rd_same, rd_batched, rd_rows = _readout_rows(torch, params, cfg)
    check(rd_same, "shard: the readout gradient one row a call differs between batches of 8 and 4 rows")
    one_s = kept["session_scan_s"]
    total = len(who) * NEW
    print(f"shard {ARCH} full width on {device_name}: placement_shards={SHARDS} over [cuda:0], {FLEET_TENANTS} "
          f"tenants x {FLEET_SAMPLES} samples x seq {FLEET_SEQ}, batch/tenant {FLEET_BPT}, rank {RANK}, fp32 "
          f"cache, use_kernel=True; tenants and partitions round robin, adapt groups [[0, 2], [1, 3]]; ingest "
          f"{ingest_rate:.1f} rows/s; adapt 3 epochs {adapt_s:.3f} s ({adapt_s / 3:.3f} s/epoch) vs one shard "
          f"{one_s:.3f} s ({one_s / 3:.3f} s/epoch); adapters and moments bitwise the one-shard session's "
          f"(the offline fleet's), losses {loss_ulps} ulps apart (max diff {loss_diff:.3e}) after 3 epochs and "
          f"{loss4_ulps} after the 4th; serve of 4 tenants + base, {NEW} new, first call: "
          f"{total / serve_s[0]:.1f} tok/s (2 shard dispatches), tokens bitwise the one-shard session's; "
          f"launches a shard: ingest K5 x{n_ing} (few rows), adapt K5 x{steps} "
          f"(many rows) + K9 x{steps}, continued epoch K5 x{FLEET_STEPS} + K9 x{FLEET_STEPS}, serve K5 x{1 + NEW} "
          f"(few rows)")
    print(f"shard checkpoint on {device_name}: save_runtime_session of the 2-shard session {save_s:.3f} s, "
          f"restore_runtime_session into a fresh 2-shard runtime {restore_s:.3f} s (synchronised), {nbytes} bytes "
          f"({nbytes / 1e9:.3f} GB); a 1-shard runtime refuses it; both continued one epoch and a serve: losses, "
          f"adapters, moments, pools, slot tables and tokens bitwise")
    print(sched_out)
    print(f"shard readout gradient dlogits @ table (fp32, K {cfg.vocab_size}, 8 x {FLEET_SEQ} rows): one cuBLAS "
          f"product over the batch gives a row other bits at M {4 * FLEET_SEQ} than at M {8 * FLEET_SEQ} (max diff "
          f"{rd_diff:.3e}), one row a call (lm._per_row_matmul) the same bits; {rd_batched:.3f} ms batched vs "
          f"{rd_rows:.3f} ms a row a call (CUDA events, warm)")
    print(f"shard decode graphs (core.decode_graph.GRAPHS, LRU of {DG.GRAPHS.capacity}) over the phase: "
          f"{graphs['captures']} captures, {graphs['replays']} replays, {graphs['hits']} hits, {graphs['misses']} "
          f"misses, {graphs['evictions']} evictions")
    if two is None:
        print(f"shard two cards: not run, this machine has {torch.cuda.device_count()} card "
              f"(the 2-card --check-parity and the elastic 2 -> 1 restore need two)")
    else:
        print(two)
    return totals


def _readout_rows(torch, params, cfg):
    """The readout gradient's product ``dlogits @ table`` (K = the vocab) at
    the fleet step's shape, 8 rows x 128 positions, fp32: as one cuBLAS
    product over the batch (M 1024) and over half of it (M 512), and one row
    a call (``lm._per_row_matmul``, what ``lm_loss_rows`` runs) for both.
    Returns (the batched product's largest difference between the two batch
    sizes, per-row bitwise, batched ms, per-row ms): CUDA events, warm."""
    from repro_torch.models.lm import _per_row_matmul

    g = torch.Generator(device="cuda").manual_seed(23)
    table = (params["head"] if not cfg.tie_embeddings else params["embed"])["table"].float()
    dl = torch.randn((8, FLEET_SEQ, cfg.vocab_size), generator=g, device="cuda")
    half = [0, 2, 4, 6]
    batched = (dl @ table)[half]
    diff = (batched - dl[half] @ table).abs().max().item()
    rows = _per_row_matmul(dl, table)[half]
    same = torch.equal(rows, _per_row_matmul(dl[half].contiguous(), table))

    def ms(fn):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 10

    return diff, same, ms(lambda: dl @ table), ms(lambda: _per_row_matmul(dl, table))


def _merge_rows(rows: dict) -> dict:
    out: dict = {}
    for per in rows.values():
        for key, n in per.items():
            out[key] = out.get(key, 0) + n
    return out


def _shard_scheduler(torch, rt, tally, held, serve_prompts, serve_who):
    """The scheduler over the 2-shard session ``rt`` and over a one-shard
    serve session holding the same adapters, on the shared-prefix trace with
    tenants 0..3 in turn and reuse on, after a warm-up on other prompts; and
    a ``serve`` of ``serve_who`` on each, timed after a warm one. Returns the
    lines to print."""
    import numpy as np

    from repro_torch.core.runtime import SessionRuntime
    from repro_torch.core.scheduler import RequestScheduler

    cfg = rt.cfg
    one = SessionRuntime(cfg, rt.sl, rt.params, max_tenants=FLEET_TENANTS, samples_per_tenant=1, seq=8,
                         use_kernel=True, device=rt.device)
    ids = list(range(FLEET_TENANTS))
    one.pool.register_many(ids, {k: torch.stack([rt.tenant(t).adapters[k] for t in ids]) for k in ("A", "B")})
    args = dict(SCHED_ARGS, inflight_per_tenant=SCHED_REQS)
    who = [i % FLEET_TENANTS for i in range(SCHED_REQS)]
    serve_s, served = {}, {}
    for name, r in (("one", one), ("two", rt)):
        for _ in range(2):   # the first call captures its decode graphs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            served[name] = r.serve(serve_who, serve_prompts, max_new=NEW)
            torch.cuda.synchronize()
            serve_s[name] = time.perf_counter() - t0
    check(torch.equal(served["one"], served["two"]), "shard serve: tokens differ between 1 and 2 shards")
    _reset_launches()
    tally.take()
    runtimes = {"one": one, "two": rt}

    def replay(name, prompts, tallied=False):
        r = runtimes[name]
        r.reset_prefix_cache()
        sched = RequestScheduler(r, prefix_reuse=True, **args)
        if tallied:
            tally.wrap(sched, "_dispatch", lambda shard, admits: shard, counters=sched.counters)
        reqs = [sched.submit(t, p, max_new=SCHED_NEW) for t, p in zip(who, prompts)]
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        sched.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        r.check_prefix_no_leaks()
        return [q.result() for q in reqs], dt, sched

    for name in runtimes:   # warm-up: other prompts
        replay(name, _shared_prefix_trace(cfg.vocab_size, 17, 4))
    prompts = _shared_prefix_trace(cfg.vocab_size, 13, SCHED_REQS)
    times = {"one": [], "two": []}
    for i, name in enumerate(("one", "two", "two", "one")):   # in turns
        toks, dt, sched = replay(name, prompts, tallied=i == 1)
        times[name].append(dt)
        if i != 1:
            _reset_launches()   # the main-path count is the tallied replay's
        if i == 0:
            t_one, s_one = toks, sched
        elif i == 1:
            t_two, s_two = toks, sched
            launches, rows, counters = tally.take()
            tally._wrapped.remove((sched, "_dispatch"))
            del sched._dispatch
            chunk = args["chunk"]
            for s in range(SHARDS):
                c = counters.get(s, {})
                check(c.get("dispatch/admit_reuse", 0) >= 1, f"shard scheduler: shard {s} never reused: {c}")
                want = {"grouped_skip_sum_fwd": (c.get("dispatch/admit", 0) + c["dispatch/admit_reuse"])
                        * (1 + chunk) + c.get("dispatch/step", 0) * chunk,
                        "paged_gather": 2 * c["dispatch/admit_reuse"]}
                check(launches.get(s) == want, f"shard scheduler: shard {s} launches {launches.get(s)} != "
                      f"{want} (counters {c})")
            check(sorted(sched._batches) == list(range(SHARDS))
                  and sorted(sched.prefix_metrics()["pools"]) == [str(s) for s in range(SHARDS)],
                  f"shard scheduler: live batches {sorted(sched._batches)}, pools "
                  f"{sorted(sched.prefix_metrics()['pools'])}")
            held("scheduler", launches, rows, (launches, rows, counters))
            per_shard = {s: launches[s]["paged_gather"] for s in range(SHARDS)}
        else:
            check(all(np.array_equal(a, b) for a, b in zip(toks, t_one)), f"shard scheduler: replay {i} tokens")
    check(all(np.array_equal(a, b) for a, b in zip(t_one, t_two)),
          f"shard scheduler: tokens {[t.tolist() for t in t_two]} != the one-shard scheduler's "
          f"{[t.tolist() for t in t_one]}")
    check(s_one.counters["prefix/hits"] == s_two.counters["prefix/hits"],
          f"shard scheduler: prefix hits {dict(s_two.counters)} vs one shard {dict(s_one.counters)}")
    total, n_serve = SCHED_REQS * SCHED_NEW, len(serve_who) * NEW
    del one
    return (f"shard serve {ARCH} full width, {len(serve_who)} rows x {PROMPT} prompt + {NEW} new, the graphs "
            f"warm: 2 shards {serve_s['two']:.3f} s = {n_serve / serve_s['two']:.1f} tok/s (2 dispatches) vs one "
            f"shard {serve_s['one']:.3f} s = {n_serve / serve_s['one']:.1f} tok/s, same tokens\n"
            f"shard scheduler {ARCH} full width: {SCHED_REQS} requests of tenants 0..3 in turn x ({SCHED_SHARE} "
            f"shared + {SCHED_TAIL} tail) prompt + {SCHED_NEW} new, reuse on, batch 4 a shard, bucket 2, chunk 2, "
            f"kv block 32, after a warm-up, in turns (1, 2, 2, 1 shards): 2 shards "
            f"{' / '.join(f'{t:.3f}' for t in times['two'])} s = "
            f"{' / '.join(f'{total / t:.1f}' for t in times['two'])} tok/s vs one shard "
            f"{' / '.join(f'{t:.3f}' for t in times['one'])} s = "
            f"{' / '.join(f'{total / t:.1f}' for t in times['one'])} tok/s; a live batch and a KV pool a shard, "
            f"K10 a shard {per_shard} = 2 x its reuse waves, K5 as each shard's dispatch counters imply, no leaks "
            f"on either shard; temperature-0 tokens bitwise the one-shard scheduler's in every replay")


def _two_cards(torch, runtime, ref, tokens, labels, prompts, who, scratch):
    """The 2-shard session over [cuda:0, cuda:1] against the same session on
    cuda:0 alone (``ref``: its adapters after 3 epochs, its state and tokens
    after the 4th; the ``--check-parity`` bar: bitwise), then saved after its
    adapt and restored onto cuda:0 alone (the elastic 2 -> 1 restore), both
    continuing one epoch and a serve bitwise. Returns the line to print."""
    import numpy as np

    from repro_torch.checkpoint.checkpoint import restore_runtime_session, save_runtime_session

    cards = (torch.device("cuda", 0), torch.device("cuda", 1))

    def run(rt):
        rt.serve([None] * len(who), prompts, max_new=NEW)
        for t in range(FLEET_TENANTS):
            for lo in range(0, FLEET_SAMPLES, FLEET_BPT):
                rt.ingest(t, tokens[t, lo:lo + FLEET_BPT], labels[t, lo:lo + FLEET_BPT])
        torch.cuda.synchronize(cards[1])
        t0 = time.perf_counter()
        out = rt.adapt(epochs=3, batch_per_tenant=FLEET_BPT, generator=torch.Generator(device=cards[0]).manual_seed(3))
        return out, time.perf_counter() - t0

    def same(a, b, what):
        for t in range(FLEET_TENANTS):
            for name in ("adapters", "opt_mu", "opt_nu"):
                for k in ("A", "B"):
                    check(torch.equal(getattr(a.tenant(t), name)[k].cpu(), getattr(b.tenant(t), name)[k].cpu()),
                          f"shard two cards: {what}: tenant {t} {name} {k} differ")

    two = runtime(cards)
    out2, dt2 = run(two)
    check({two.tenant(t).adapters["A"].device.index for t in range(FLEET_TENANTS)} == {0, 1},
          "shard two cards: the shards' state is not on both cards")
    for t in range(FLEET_TENANTS):
        for k in ("A", "B"):
            check(torch.equal(two.tenant(t).adapters[k].cpu(), ref["adapters3"][t][k].cpu()),
                  f"shard two cards: tenant {t} adapters {k} != the 1-card session's")
    path = save_runtime_session(scratch, 2, two)
    back = runtime()
    restore_runtime_session(path, back)
    outs, toks = [], []
    for r in (two, back):
        outs.append(r.adapt(epochs=1, batch_per_tenant=FLEET_BPT))
        toks.append(r.serve(who, prompts, max_new=NEW).cpu())
    same(two, back, "elastic 2 -> 1 restore")
    for t in range(FLEET_TENANTS):
        check(np.array_equal(outs[0]["losses"][t], outs[1]["losses"][t]), f"shard two cards: tenant {t} losses")
        for name in ("adapters", "opt_mu", "opt_nu"):
            for k in ("A", "B"):
                check(torch.equal(getattr(two.tenant(t), name)[k].cpu(), ref["tenants"][t][name][k].cpu()),
                      f"shard two cards: tenant {t} {name} {k} after 4 epochs != the 1-card session's")
    check(torch.equal(toks[0], toks[1]) and torch.equal(toks[0], ref["tokens"].cpu()),
          "shard two cards: tokens differ")
    # both now hold their graphs: three more epochs each, replays only, the
    # two cards' shards overlapping against the two shards on one card
    replay_s = {}
    for name, r in (("two cards", two), ("one card", back)):
        since = r.epoch_graph_stats()
        for d in cards:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        r.adapt(epochs=3, batch_per_tenant=FLEET_BPT)
        replay_s[name] = time.perf_counter() - t0
        gain = _graph_gain(r.epoch_graph_stats(), since)
        check(gain["captures"] == 0 and gain["replays"] == 6 * FLEET_STEPS, f"shard two cards: {name} graphs {gain}")
    del two, back
    torch.cuda.empty_cache()
    _reset_launches()   # a measurement beside the main path: its launches are not counted
    return (f"shard two cards: the 2-shard session over [cuda:0, cuda:1] (adapt 3 epochs {dt2:.3f} s) bitwise the "
            f"1-card session (adapters, moments, tokens); saved and restored onto cuda:0 alone (elastic 2 -> 1), "
            f"both continued one epoch and a serve bitwise; then adapt 3 epochs of replays only: two cards "
            f"{replay_s['two cards']:.3f} s, one card {replay_s['one card']:.3f} s "
            f"({replay_s['one card'] / replay_s['two cards']:.2f}x)")


def small_shard_check(torch):
    """Reduced float32 stablelm-1.6b, 4 tenants x 4 samples x seq 16, rank
    8, ``placement_shards=2``: serve -> ingest -> adapt(epochs=2) -> serve on
    the card (kernels) and on the CPU (plain versions), from the same
    initial adapters (a CPU generator): the same adapt groups, per-step
    losses (rtol 1e-4), adapters (atol 1e-4) and temperature-0 tokens."""
    import numpy as np

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.core.runtime import SessionRuntime
    from repro_torch.models.lm import init_lm

    cfg = reduce_config(get_config(ARCH))
    sl = SL.SkipLoRAConfig(rank=RANK, mode="full", cache_dtype="float32", use_fused_kernel=True)
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (4, 4, 16), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (4, 4, 16), generator=g)
    prompts = torch.randint(0, cfg.vocab_size, (5, 8), generator=g)
    who = [None, 0, 1, 2, 3]
    res = {}
    for where in ("cpu", "cuda"):
        rt = SessionRuntime(cfg, sl, _to(params, where), max_tenants=4, samples_per_tenant=4, seq=16, lr=1e-2,
                            use_kernel=True, placement_shards=SHARDS, device=where)
        base = rt.serve([None] * 5, prompts, max_new=4).cpu()
        for t in range(4):
            rt.ingest(t, tokens[t], labels[t])
        out = rt.adapt(epochs=2, batch_per_tenant=2, generator=torch.Generator().manual_seed(3))
        res[where] = (out["groups"], np.stack([out["losses"][t] for t in range(4)], axis=-1),
                      {k: np.stack([rt.tenant(t).adapters[k].cpu().numpy() for t in range(4)]) for k in ("A", "B")},
                      base, rt.serve(who, prompts, max_new=4).cpu(), rt.counters["serve/shard_dispatches"])
    (gc, lc, ac, bc, tc, dc), (gg, lg, ag, bg, tg, dg) = res["cpu"], res["cuda"]
    loss_err = float((np.abs(lg - lc) / np.abs(lc)).max())
    ad_err = max(float(np.abs(ag[k] - ac[k]).max()) for k in ac)
    check(gc == gg == [[0, 2], [1, 3]] and dc == dg == SHARDS, f"small shard: groups {gg} vs {gc}")
    check(loss_err <= 1e-4 and ad_err <= 1e-4, f"small shard: card vs CPU losses {loss_err:.3e}, adapters {ad_err:.3e}")
    check(torch.equal(bc, bg) and torch.equal(tc, tg), f"small shard: tokens card {tg} vs CPU {tc}")
    print(f"shard small: reduced {ARCH} float32, 4 tenants x 4 samples, {SHARDS} shards: card (kernels) vs CPU "
          f"(plain versions) groups {gg}, max loss rel diff {loss_err:.3e}, max adapter diff {ad_err:.3e}, "
          f"temperature-0 tokens equal")


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


def _near_tie_flips(torch, params, cfg, pool, what, prompts, tenants, toks_a, toks_b):
    """Temperature-0 tokens of two runs of the same requests: where request
    i first differs (token d), the dense path's logits for prompt i + the
    first d tokens of run b (``tenants[i]``'s adapters from ``pool``) must
    have their top two within ``TOP2_REL_TOL`` of the largest |logit|, else
    the check fails. Returns one line per flip."""
    import numpy as np

    from repro_torch.models.lm import sched_prefill

    dev, flips = params["embed"]["table"].device, []
    for i, (a, b) in enumerate(zip(toks_a, toks_b)):
        a, b = np.asarray(a), np.asarray(b)
        if np.array_equal(a, b):
            continue
        d = int(np.flatnonzero(a != b)[0])
        ctx = torch.as_tensor(np.concatenate([np.asarray(prompts[i]), b[:d]])[None], device=dev)
        with torch.no_grad():
            logits, _ = sched_prefill(params, cfg, ctx, torch.tensor([ctx.shape[1]], device=dev),
                                      pool.pools(), pool.lookup([tenants[i]]))
        top = torch.topk(logits[0, 0].float(), 2).values
        gap, mag = (top[0] - top[1]).item(), logits.float().abs().max().item()
        check(gap <= TOP2_REL_TOL * mag, f"{what}: request {i} token {d} differs "
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
    flips = _near_tie_flips(torch, rt.params, rt.cfg, rt.pool, "scheduler: reuse on vs off", prompts,
                            [tenant] * SCHED_REQS, on_toks, off_toks)
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
    solo_flips = _near_tie_flips(torch, rt.params, rt.cfg, rt.pool, "scheduler vs solo serve", mid, who,
                                 runs["continuous"], runs["solo"])
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


# ---------------------------------------------------------------------------
# Phase 13: the kernel tooling (autotune, roofline) and the full-backprop
# trainer
# ---------------------------------------------------------------------------

TOOLING_DIR = ROOT / "build" / "tooling"
#: grouped forwards whose tile / geometry candidates may differ from the
#: default's bits, with the tolerance that holds them instead (relative to
#: the largest output); empty: every candidate must give the default's bits
TILE_TOL: dict[str, float] = {}


def _tune_cases(torch):
    """(label, variants, x, a_pool, b_pool, idx) of the sweeps at
    stablelm-1.6b widths (L 24, D 2048, R 8, bf16 rows, fp32 pools): the
    serve cell's decode step (4 rows in 4 slots, slot 0 the zero slot), fleet
    serving's (one row in each of 5 slots of a 6-slot pool) and, for K5
    alone, the fleet step (M 1024 in 4 slots of 256)."""
    from repro_torch.kernels import autotune as AT

    x, (a, b), idx = _case(torch, torch.bfloat16, BATCH, (1,) * BATCH, seed=21, int8=False)
    yield "serve-decode", AT.VARIANTS, x, a, b, idx
    x, (a, b), idx = _case(torch, torch.bfloat16, 5, SERVE_DECODE, seed=22, int8=False)
    yield "fleet-serve-decode", AT.VARIANTS, x, a, b, idx
    x, a, b, _, idx = _fleet_rows(torch, (256,) * FLEET_TENANTS, seed=23)
    yield "fleet-step", ("grouped",), x, a, b, idx


def _autotune_part(torch, device_name):
    """``tune_grouped`` over every case and variant with a real timer and a
    cold cache, each candidate's output held against the default's bits; a
    warm pass that must be all cache hits with the same choices;
    ``apply_choice`` of one winner and its reset; ``tune_decode_unroll`` at
    the decode shape and ``tune_kv_block`` at full width."""
    from repro_torch.configs import get_config
    from repro_torch.core import kv_pool as KV
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops

    cfg = get_config(ARCH)
    TOOLING_DIR.mkdir(parents=True, exist_ok=True)
    path = TOOLING_DIR / "autotune.json"
    path.unlink(missing_ok=True)
    cache = AT.AutotuneCache(str(path))
    timer = AT.median_timer(iters=20, warmup=3)
    base = AT.config_key(cfg, RANK)
    choices, decode = {}, None
    for label, variants, x, a, b, idx in _tune_cases(torch):
        m = x.shape[1]
        for variant in variants:
            record = []
            ch = AT.tune_grouped(x, a, b, idx, variant, config=f"{base}-{label}", cache=cache, timer=timer,
                                 record=record)
            check(ch.source == "measured" and ch.time_s <= ch.default_time_s, f"autotune {variant} {label}: {ch}")
            want = next(out for tm, g, _, _, out in record if (tm, g) == (ops.TM, "rule"))
            check(bool(torch.isfinite(want.float()).all()), f"autotune {variant} {label}: non-finite output")
            worst = 0.0
            for tm, g, _, _, out in record:
                if torch.equal(out, want):
                    continue
                err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
                check(variant in TILE_TOL and err <= TILE_TOL[variant],
                      f"autotune {variant} {label}: tile {tm} {g} differs from the default's bits by {err:.3e} "
                      f"of the largest output")
                worst = max(worst, err)
            cands = "; ".join(f"{tm}/{g} {t * 1e6:.1f} ({p * 1e6:.2f})" for tm, g, t, p, _ in record)
            bits = ("every candidate bitwise the default's" if not worst
                    else f"candidates within {worst:.2e} of the default's largest output (TILE_TOL)")
            print(f"autotune {variant} {label} M={m} on {device_name}: tm/geometry measured us (predicted us): "
                  f"{cands}; winner tm {ch.tm} {ch.grid_order} {ch.time_s * 1e6:.1f} us against the default "
                  f"(tm {ops.TM}, rule) {ch.default_time_s * 1e6:.1f} us ({ch.default_time_s / ch.time_s:.2f}x), "
                  f"predicted {ch.predicted_s * 1e6:.2f} us; {bits}")
            choices[variant, label] = ch
            if (variant, label) == ("grouped", "serve-decode"):
                decode = (x, a, b, idx, ch)
    check(cache.misses == len(choices) and cache.hits == 0, f"cold pass: {cache.hits} hits, {cache.misses} misses")

    def poisoned(fn):
        raise AssertionError("a warm autotune pass timed a candidate")

    warm = AT.AutotuneCache(str(path))
    for label, variants, x, a, b, idx in _tune_cases(torch):
        for variant in variants:
            ch = AT.tune_grouped(x, a, b, idx, variant, config=f"{base}-{label}", cache=warm, timer=poisoned)
            was = choices[variant, label]
            check(ch.source == "cache" and (ch.tm, ch.grid_order) == (was.tm, was.grid_order),
                  f"warm autotune {variant} {label}: {ch} != {was}")
    check(warm.hits == len(choices) and warm.misses == 0, f"warm pass: {warm.hits} hits, {warm.misses} misses")
    print(f"autotune warm pass: {warm.hits} cache hits, 0 misses, the same {len(choices)} choices ({path.name})")

    x, a, b, idx, ch = decode
    want = ops.skip_lora_grouped(x[:, :, None], a, b, idx)[:, 0]
    K.ROW_LAUNCHES.clear()
    try:
        AT.apply_choice(ch)
        check(ops.get_default_tile() == (ch.tm, ch.grid_order), f"apply_choice installed {ops.get_default_tile()}")
        plan = ops.grouped_plan(idx, a.shape[0])
        check(ops.plan_tile(plan) == ch.tm, "the plan ignores the installed tile")
        got = ops.skip_lora_grouped(x[:, :, None], a, b, idx, plan=plan)[:, 0]
        check(torch.equal(got, want), "the installed winner changed the serve decode's bits")
        taken = ch.grid_order if ch.grid_order != "rule" else K.grouped_fwd_geometry(x.shape[1], plan[0].numel())
        check(K.ROW_LAUNCHES == {("grouped_skip_sum_fwd", taken): 1}, f"row classes {K.ROW_LAUNCHES}")
    finally:
        ops.set_default_tile(None, None)

    times = []

    def recording(fn, real=AT.median_timer(iters=10, warmup=2)):
        times.append(real(fn))
        return times[-1]

    u, t = AT.tune_decode_unroll(x, a, b, idx, tm=ch.tm, grid_order=ch.grid_order, steps=16, timer=recording)
    check(u in AT.UNROLL_CANDIDATES and t == min(times), f"tune_decode_unroll: {u}, {t}, {times}")
    per = ", ".join(f"unroll {c} {tt * 1e6:.1f} us" for c, tt in zip(AT.UNROLL_CANDIDATES, times))
    print(f"autotune decode unroll (K5, serve decode, tm {ch.tm} {ch.grid_order}, 16 dispatches as 16 / unroll "
          f"graph replays) on {device_name}: {per}; winner unroll {u}")
    times.clear()
    kv = AT.tune_kv_block(cfg, config=base, seq=64, batch=4, cache=cache, timer=recording)
    blocks = sorted(set(AT.KV_BLOCK_CANDIDATES) | {KV.DEFAULT_BLOCK})
    check(len(times) == len(blocks) and kv.time_s == min(times), f"tune_kv_block: {kv}, {times}")
    per = ", ".join(f"block {blk} {tt * 1e6:.1f} us" for blk, tt in zip(blocks, times))
    print(f"autotune kv block ({ARCH}, seq 64, batch 4: publish + gather_blocks, K10) on {device_name}: {per}; "
          f"winner block {kv.tm} ({kv.default_time_s / kv.time_s:.2f}x the default block {KV.DEFAULT_BLOCK})")
    check(KV.get_default_block() == KV.DEFAULT_BLOCK, "tune_kv_block changed the default block")


def _trainer_part(torch, device_name):
    """``launch/train.py --full --steps 4 --batch 8 --seq 128`` per step and
    with ``--scan-chunk 2`` (one CUDA-graph replay a chunk): losses finite
    and the last below the first, the chunked losses and final parameters bitwise the
    per-step ones; step ms both ways and the peak memory; a replayed step's
    time for the roofline."""
    import shutil
    import statistics

    from repro_torch.core import decode_graph as DG
    from repro_torch.launch import train as TT
    from repro_torch.optim.optimizers import tree_leaves

    steps, bsz, seq = 4, 8, 128
    base = TOOLING_DIR / "train_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    DG.GRAPHS.clear()   # the serve and scheduler phases' graphs hold full-width weights and caches
    argv = ["--arch", ARCH, "--full", "--steps", str(steps), "--batch", str(bsz), "--seq", str(seq),
            "--device", "cuda", "--ckpt-every", "1000", "--log-every", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    per_step = TT.main([*argv, "--ckpt-dir", str(base / "step")])
    peak_step = torch.cuda.max_memory_allocated() / 2**30
    losses = per_step["losses"]
    check(len(losses) == steps and all(map(math.isfinite, losses)), f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    step_ms = 1e3 * statistics.median(per_step["step_s"][1:])
    REMAT_SEEN["trainer"] = (losses, step_ms, peak_step)
    params = per_step["params"]
    del per_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    chunked = TT.main([*argv, "--ckpt-dir", str(base / "chunk"), "--scan-chunk", "2"])
    peak_chunk = torch.cuda.max_memory_allocated() / 2**30
    check(chunked["chunks"] == [2, 2], f"train chunks {chunked['chunks']}")
    check(chunked["losses"] == losses, f"train: chunked losses {chunked['losses']} != per-step {losses}")
    same = all(torch.equal(p, q) for p, q in zip(tree_leaves(chunked["params"]), tree_leaves(params), strict=True))
    check(same, "train: the chunked run's final parameters differ from the per-step run's")
    # a replay holds only device work: its synchronised host time is the
    # steps' device time (an eager step's thousands of launches outlast any
    # spin that holds the stream, so CUDA events around one would count the
    # host's issue too)
    chunk_ms = STEP_MS["train"] = 1e3 * chunked["step_s"][-1] / chunked["chunks"][-1]
    first_ms = 1e3 * chunked["step_s"][0] / chunked["chunks"][0]
    del chunked, params
    TT.GRAPHS.clear()
    shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"train full backprop {ARCH} full width (24 layers, bf16, AdamW fp32 moments) on {device_name}: "
          f"{steps} steps of batch {bsz} x seq {seq}, losses {' / '.join(f'{v:.4f}' for v in losses)}; per-step "
          f"path {step_ms:.1f} ms a step (host clock, median of steps 1-3), peak {peak_step:.1f} GiB; "
          f"--scan-chunk 2: {chunk_ms:.1f} ms a step in a replay (the first chunk, warm-up and capture included, "
          f"{first_ms:.1f}), peak {peak_chunk:.1f} GiB; chunked losses and final parameters bitwise the per-step "
          f"run's")


def _roofline_part(device_name):
    """model_flops, measured device ms and MFU_model against the card's bf16
    peak for the steps the main paths time at full width, and the cached
    step's readout against the fp32 peak."""
    from repro_torch.configs import get_config
    from repro_torch.launch import flops as FL
    from repro_torch.launch import roofline as RL

    cfg = get_config(ARCH)
    rows = [("finetune_cached", "finetune_cached full", (8, 128)),
            ("finetune_cached", "finetune_cached int8", (8, 128)),
            ("finetune_populate", "finetune_populate full", (8, 128)),
            ("finetune_populate", "finetune_populate int8", (8, 128)),
            ("decode", "decode", (BATCH, PROMPT + NEW)),
            ("train", "train", (8, 128))]
    for step, key, shape in rows:
        check(key in STEP_MS, f"roofline: no device time for {key}")
        mf, ms = FL.model_flops(cfg, shape, step), STEP_MS[key]
        how = "a chunk replay's step" if step == "train" else "CUDA events"
        print(f"roofline {key} {ARCH} batch {shape[0]} x {'context' if step == 'decode' else 'seq'} {shape[1]} on "
              f"{device_name}: model_flops {mf:.4e}, device {ms:.3f} ms ({how}), MFU_model "
              f"{RL.mfu(mf, ms / 1e3):.5f} of PEAK_FLOPS {RL.PEAK_FLOPS:.3e} ({mf / (ms / 1e3) / 1e12:.2f} TFLOP/s)")
    ro = FL.readout_flops(cfg, 8 * 128)
    ms, cached = STEP_MS["readout full"], STEP_MS["finetune_cached full"]
    print(f"roofline readout of the cached step (full) on {device_name}: model_flops counts 3 x readout_flops = "
          f"{3 * ro:.4e} (of {FL.model_flops(cfg, (8, 128), 'finetune_cached'):.4e}); the port computes 2 x = "
          f"{2 * ro:.4e} in {ms:.3f} ms ({100 * ms / cached:.1f}% of the step) = {2 * ro / (ms / 1e3) / 1e12:.2f} "
          f"TFLOP/s, {RL.mfu(2 * ro, ms / 1e3, peak=RL.PEAK_FLOPS_FP32):.4f} of PEAK_FLOPS_FP32 "
          f"{RL.PEAK_FLOPS_FP32:.2e}")


def tooling_phase(torch, device_name):
    """The kernel tooling and the trainer, with the launch counters reset
    around them: nothing here adds to the main paths' counts. The defaults
    (tile, geometry, KV block) are the untuned ones afterwards."""
    from repro_torch.core import kv_pool as KV
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops

    t_phase = time.perf_counter()
    print(device_name)
    _reset_launches()
    try:
        _autotune_part(torch, device_name)
        _trainer_part(torch, device_name)
        _roofline_part(device_name)
    finally:
        ops.set_default_tile(None, None)
        KV.set_default_block(None)
        _reset_launches()
    check(ops.get_default_tile() == (ops.TM, "rule") and KV.get_default_block() == KV.DEFAULT_BLOCK,
          "the tooling phase left a tuned default installed")
    check(not K.ROW_LAUNCHES and not any(_launches().values()), "launch counters not reset")
    print(f"tooling phase: {time.perf_counter() - t_phase:.1f} s; defaults restored (tm {ops.TM}, rule, kv block "
          f"{KV.DEFAULT_BLOCK}); launch counters reset: the kernels line counts the main paths only")


# ---------------------------------------------------------------------------
# Phase 14: the other model families at full width
# ---------------------------------------------------------------------------

#: the families' fine-tuning: the train phase's shape with 32 samples
FAM_TRAIN = ["--full", "--use-kernel", "--samples", "32", "--batch", "8", "--seq", "128", "--rank", str(RANK)]
FAM_STEPS = 32 // 8
#: the families' session round: 2 tenants x 8 samples, batch per tenant 4 (1024 rows a step)
FAM_TENANTS, FAM_SAMPLES, FAM_BPT = 2, 8, 4
REDUCED_TOL = 1e-5


def _live_norms(params, cfg):
    """The reference initialises an RMSNorm scale at 0, which without gemma's
    unit offset zeroes every block's input and the readout's: such a
    model's seeded weights get scale 1 instead, so routing, scans and
    fine-tuning see real activations. Other norms keep their init."""
    _live_part(cfg, "final_norm", params["final_norm"])
    for i, layer in enumerate(params["stack"]):
        _live_part(cfg, ("stack", i), layer)
    return params


def _live_part(cfg, key, tree):
    """``_live_norms`` of one of ``lm.init_parts``' parts, in place."""
    if cfg.norm_type != "rmsnorm" or cfg.rmsnorm_unit_offset:
        return
    if key == "final_norm":
        tree["scale"].fill_(1.0)
    elif isinstance(key, tuple):
        for name, p in tree.items():
            if name.startswith(("norm", "post_norm")):
                p["scale"].fill_(1.0)


def _free_device(torch):
    """Drop what earlier phases left on the card: the decode, MLP-epoch,
    trainer and LM-epoch graphs (and their memory pools), then the
    allocator's cache."""
    import gc

    from repro_torch.core import decode_graph as DG
    from repro_torch.core import finetune as MF
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.launch import train as TR

    for graphs in (DG.GRAPHS, MF.GRAPHS, TR.GRAPHS, SL.GRAPHS):
        graphs.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def _width_kernels(torch):
    """K1, K2, K5 and K9 against their plain versions at the new widths
    (D 1024: xlstm-350m; D 1536: musicgen-medium), at the shapes the new
    paths launch: K1/K2 at a cached step (L of the config, M 1024 = batch 8
    x seq 128, R 8, bf16 rows; D 1536 runs the vector branches of width 16,
    1024 those of 32), K5 at a grouped decode step (4 rows in 4 slots), K9
    at a session adapt step (M 1024 in 2 slots). Comparison launches: the
    counters are reset after them."""
    from repro_torch.kernels.skip_lora import kernel as K
    from repro_torch.kernels.skip_lora import ops, ref as R

    lines = []
    for arch, lnum, d in (("xlstm-350m", 24, 1024), ("musicgen-medium", 48, 1536)):
        g = torch.Generator(device="cuda").manual_seed(d)
        m, r = 1024, RANK
        x = torch.randn((lnum, m, d), generator=g, device="cuda").to(torch.bfloat16)
        a = torch.randn((lnum, d, r), generator=g, device="cuda") / d**0.5
        b = torch.randn((lnum, r, d), generator=g, device="cuda") * 0.02
        gr = torch.randn((m, d), generator=g, device="cuda").to(torch.bfloat16)
        pa = torch.randn((4, lnum, d, r), generator=g, device="cuda") / d**0.5
        pb = torch.randn((4, lnum, r, d), generator=g, device="cuda") * 0.02
        pa[0] = 0
        pb[0] = 0
        x4 = x[:, :4].contiguous()
        idx4 = torch.arange(4, dtype=torch.int32, device="cuda")
        idx2 = torch.repeat_interleave(torch.arange(2, dtype=torch.int32, device="cuda"), m // 2)
        plan4, plan2 = ops._plan(idx4, 4, 4, ops.TM), ops._plan(idx2, 2, m, ops.TM)
        cases = (
            ("skip_lora_fwd", lambda: K.skip_lora_fwd(x, a, b), lambda: R.skip_lora_fwd_ref(x, a, b), 2.0**-7),
            ("skip_lora_bwd", lambda: K.skip_lora_bwd(x, a, b, gr), lambda: R.skip_lora_bwd_ref(x, a, b, gr),
             2.0**-6),
            ("grouped_skip_sum_fwd", lambda: K.grouped_skip_sum_fwd(x4, pa, pb, *plan4, ops.TM),
             lambda: R.skip_lora_grouped_ref(x4, pa, pb, idx4), 2.0**-7),
            ("grouped_skip_sum_bwd", lambda: K.grouped_skip_sum_bwd(x, pa[:2], pb[:2], gr, *plan2, ops.TM),
             lambda: R.skip_lora_grouped_bwd_ref(x, pa[:2], pb[:2], gr, idx2), 2.0**-6),
        )
        errs = []
        for name, run, plain, tol in cases:
            got, want = run(), plain()
            torch.cuda.synchronize()
            gots = got if isinstance(got, tuple) else (got,)
            wants = want if isinstance(want, tuple) else (want,)
            worst = 0.0
            for gt, wt in zip(gots, wants):
                check(bool(torch.isfinite(gt).all()), f"{name} D={d}: non-finite output")
                err, mag = _rel_err(gt, wt)
                check(err <= tol * mag, f"{name} D={d}: max |kernel - plain| {err:.3e} > {tol * mag:.3e}")
                worst = max(worst, err / max(mag, 1e-30))
            errs.append(f"{name} {worst:.2e}")
        lines.append(f"{arch} L={lnum} D={d}: " + ", ".join(errs))
    _reset_launches()
    print("families kernels at the new widths, kernel vs plain (max |diff| / max |plain|; tol 2^-7 forward, "
          "2^-6 backward): " + "; ".join(lines))


def _decode_bitwise(torch, cfg, params, tok0, start, caches, **kw):
    """From one prefill's caches: ``decode_scan``'s graph replays against
    the eager ``decode_loop``, greedy, tokens and final caches (KV and
    recurrent states) bitwise. Returns the graph's tokens."""
    from repro_torch.models import lm as LM

    def fresh():
        return [{n: t.clone() for n, t in c.items()} for c in caches]

    want, want_c = LM.decode_loop(params, cfg, tok0, start, fresh(), max_new=NEW, **kw)
    got, got_c = LM.decode_scan(params, cfg, tok0, start, fresh(), max_new=NEW, **kw)
    check(torch.equal(got, want), f"{cfg.name}: graph tokens {got.tolist()} != loop tokens {want.tolist()}")
    check(all(torch.equal(x[n], y[n]) for x, y in zip(got_c, want_c) for n in x),
          f"{cfg.name}: graph caches / states != the eager loop's")
    return got


@contextlib.contextmanager
def _cell_clock(torch):
    """Host seconds spent inside the recurrent blocks' sequence and step
    forms (``blocks._RECURRENT``: projections and the eager time loop),
    synchronised around each call, and the number of calls."""
    from repro_torch.models import blocks as BL

    got, saved = {"s": 0.0, "calls": 0}, dict(BL._RECURRENT)

    def clocked(fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            got["s"] += time.perf_counter() - t0
            got["calls"] += 1
            return out
        return run

    BL._RECURRENT = {k: (init, state, clocked(seq), clocked(step)) for k, (init, state, seq, step) in saved.items()}
    try:
        yield got
    finally:
        BL._RECURRENT = saved


def _family_serve(torch, cfg, params, device_name):
    """Grouped serving of 3 demo tenants and the base row (4 x 128 prompt
    tokens, 32 new, float pool): a warm-up call, then ``generate_grouped``
    (graph replays) and ``generate_loop`` (eager steps), each exactly 33 K5
    (few rows); graph tokens == loop tokens; the base row equal to base
    ``generate``'s or apart at a near tie; from one prefill the replays
    bitwise the eager loop (tokens, KV caches, recurrent states). Returns
    (K5 launches, tok/s)."""
    from repro_torch.core.runtime import generate, generate_grouped, generate_loop
    from repro_torch.launch.serve import demo_pool
    from repro_torch.models import lm as LM

    dev = torch.device("cuda")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=torch.Generator(device=dev).manual_seed(3),
                            device=dev)
    pool = demo_pool(cfg, TENANTS, RANK, None, dev)
    idx = pool.lookup([None] + [f"tenant-{i % TENANTS}" for i in range(1, BATCH)])
    generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, device=dev)   # warm-up: captures
    timed = {}
    for path in ("graph", "loop"):
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        if path == "graph":
            out = generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=NEW, device=dev)
        else:
            out = generate_loop(params, cfg, prompts, max_new=NEW, pools=pool.pools(), idx=idx, device=dev)
        torch.cuda.synchronize()
        timed[path] = (out, time.perf_counter() - t0)
        counts = _launches()
        want = {k: 0 for k in counts}
        want["grouped_skip_sum_fwd"] = 1 + NEW
        check(counts == want, f"{cfg.name} serve {path}: launches {counts} != {want}")
        if path == "graph":
            _tally_rows("grouped_skip_sum_fwd", {"few_rows": 1 + NEW})
    out, dt = timed["graph"]
    check(tuple(out.shape) == (BATCH, NEW) and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"{cfg.name} serve: tokens {tuple(out.shape)} out of range")
    check(torch.equal(out, timed["loop"][0]), f"{cfg.name} serve: graph tokens != loop tokens")
    base = generate(params, cfg, prompts, max_new=NEW, device=dev)
    flips = _near_tie_flips(torch, params, cfg, pool, f"{cfg.name} serve: base row vs base generate",
                            prompts[:1].cpu(), [None], out[:1].cpu(), base[:1].cpu())
    check(not torch.equal(out[1:], base[1:]), f"{cfg.name} serve: the adapters changed no token")
    b, s = prompts.shape
    caches = LM.init_serve_caches(cfg, b, s + NEW, device=dev)
    with _cell_clock(torch) as cells:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = LM.serve_prefill_grouped(params, cfg, prompts, caches, pool.pools(), idx)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    _decode_bitwise(torch, cfg, params, LM.sample_token(logits, 0.0), s, caches, pools=pool.pools(), idx=idx)
    _reset_launches()
    loop_dt = timed["loop"][1]
    share = ""
    if cells["calls"]:
        share = (f"; the prefill {prefill_s:.3f} s, of which the recurrent cells {cells['s']:.3f} s "
                 f"({100 * cells['s'] / prefill_s:.1f} %: {cells['calls']} cells x {s} time steps, eager)")
    print(f"families serve {cfg.name} full width: {BATCH}x{PROMPT} prompt + {NEW} new, 3 tenants + base row on "
          f"{device_name}: graph {dt:.3f} s = {BATCH * NEW / dt:.1f} tok/s, eager loop {loop_dt:.3f} s = "
          f"{BATCH * NEW / loop_dt:.1f} tok/s; grouped_skip_sum_fwd x{1 + NEW} a call both ways; graph == loop "
          f"tokens; from one prefill graph == loop bitwise (tokens, caches, states); base row == base "
          f"generate{'' if not flips else ' but at a near tie: ' + flips[0]}{share}")
    return 1 + NEW, BATCH * NEW / dt


def _family_prefix_serve(torch, cfg, params, device_name):
    """A frontend config: ``serve_prefill(prefix_embeds=)`` of seeded bf16
    prefix embeddings (the config's ``frontend_seq``) ahead of 4 x 128
    prompt tokens, then 32 new tokens from position P + 128, graph replays
    bitwise the eager loop; no grouped launch (single stack, base model).
    Returns tok/s of prefill + graphed decode."""
    from repro_torch.models import frontend as FE
    from repro_torch.models import lm as LM

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g, device=dev)
    shape, dtype = FE.prefix_spec(cfg, BATCH)
    prefix = torch.randn(shape, generator=g, device=dev).to(dtype)
    p = FE.frontend_prefix_len(cfg)

    def call():
        caches = LM.init_serve_caches(cfg, BATCH, p + PROMPT + NEW, device=dev)
        logits, caches = LM.serve_prefill(params, cfg, prompts, caches, prefix_embeds=prefix)
        tok0 = LM.sample_token(logits, 0.0)
        return tok0, caches, LM.decode_scan(params, cfg, tok0, p + PROMPT, caches, max_new=NEW)[0]

    _reset_launches()
    with torch.no_grad():
        call()   # warm-up: captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok0, _, out = call()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        caches = LM.init_serve_caches(cfg, BATCH, p + PROMPT + NEW, device=dev)
        _, caches = LM.serve_prefill(params, cfg, prompts, caches, prefix_embeds=prefix)
        got = _decode_bitwise(torch, cfg, params, tok0, p + PROMPT, caches)
    check(torch.equal(got, out), f"{cfg.name}: a second prefill decoded other tokens")
    check(not any(_launches().values()), f"{cfg.name} prefix serve: a kernel launched: {_launches()}")
    print(f"families serve {cfg.name} full width: prefix {p} x {cfg.d_model} embeddings + {PROMPT} prompt tokens "
          f"x{BATCH}, {NEW} new on {device_name}: serve_prefill(prefix_embeds=) + graphed decode {dt:.3f} s = "
          f"{BATCH * NEW / dt:.1f} tok/s; graph == loop bitwise (tokens, caches); no kernel launched")
    return BATCH * NEW / dt


def _family_train(torch, arch, mode, epochs, device_name, params):
    """Populate + cached epochs through the finetune launcher's own
    single-tenant loop (``prepare`` / ``run_epoch``, ``--use-kernel``) over
    ``params``, the launcher's own seed-0 draw with live norms
    (``_train_epochs``' bars). Returns (launches, epoch times)."""
    from repro_torch.launch import finetune as FT

    args = FT.parse_args(["--arch", arch, *FAM_TRAIN, "--mode", mode, "--epochs", str(epochs)])
    run = FT.prepare(args, params=params)
    start = (run.trainable, run.opt_state)
    what = f"families train {arch} {mode}"
    totals, times, means, graphs = _train_epochs(torch, run, what, FAM_STEPS)
    # the populate epoch again from the same state into the same cache (the
    # rows it rewrites are the ones it wrote): replays only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    *_, again = run.populate_epoch(run.params, *start[:1], run.static, start[1], run.cache, run.tokens, run.labels,
                                   FT.epoch_index_matrix(0, args.samples, args.batch, run.device))
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    _reset_launches()
    check(torch.equal(again.cpu(), REMAT_SEEN[what][1]), f"{what}: a replayed populate epoch's losses differ")
    fwd = next(iter(totals))
    print(f"families train {arch} full width mode={mode} --use-kernel on {device_name}: {args.samples} samples, "
          f"batch {args.batch}, seq {args.seq}, rank {args.rank}: populate epoch {times[0]:.3f} s, cached epoch(s) "
          f"{' / '.join(f'{t:.3f}' for t in times[1:])} s; mean losses {' / '.join(f'{v:.4f}' for v in means)}; "
          f"{fwd} and skip_lora_bwd x{FAM_STEPS} a cached epoch, none during populate")
    print(f"families graphs {arch} mode={mode} on {device_name}: CUDA-graph replays bitwise the eager loop from "
          f"the same state: {_graph_line(times, graphs)}; populate again, replays only: {replay_s:.3f} s")
    return totals, times + [replay_s]


def _family_session(torch, cfg, params, device_name):
    """One ``SessionRuntime`` round (mode int8, float pool, ``use_kernel``):
    2 tenants x 8 samples ingested (one K5 a call, few rows), one
    ``adapt(epochs=1)`` (2 steps of 1024 rows: K8 + K9 each, many rows), a
    serve of the 2 tenants and 2 base rows (33 K5, few rows). Returns the
    launches."""
    import numpy as np

    from repro_torch.core import lm_skiplora as SL
    from repro_torch.core.runtime import SessionRuntime
    from repro_torch.optim.optimizers import adamw

    dev = torch.device("cuda")
    sl = SL.SkipLoRAConfig(rank=RANK, mode="int8", cache_dtype="float32", use_fused_kernel=True)
    rt = SessionRuntime(cfg, sl, params, max_tenants=FAM_TENANTS, samples_per_tenant=FAM_SAMPLES, seq=PROMPT,
                        optimizer=adamw(1e-3), use_kernel=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(23)
    toks = torch.randint(0, cfg.vocab_size, (FAM_TENANTS, FAM_SAMPLES, PROMPT + 1), generator=g, device=dev)
    totals: dict[str, int] = {}

    def window(want, rows):
        for k, n in _window(torch, want, rows).items():
            totals[k] = totals.get(k, 0) + n

    _reset_launches()
    t0 = time.perf_counter()
    for t in range(FAM_TENANTS):
        rt.ingest(t, toks[t, :, :-1], toks[t, :, 1:])
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    window({"grouped_skip_sum_fwd": FAM_TENANTS}, ("grouped_skip_sum_fwd", {"few_rows": FAM_TENANTS}))
    steps = FAM_SAMPLES // FAM_BPT
    t0 = time.perf_counter()
    out = rt.adapt(epochs=1, batch_per_tenant=FAM_BPT, generator=torch.Generator(device=dev).manual_seed(3))
    t_adapt = time.perf_counter() - t0
    window({"grouped_skip_sum_fwd_actint8": steps, "grouped_skip_sum_bwd": steps},
           ("grouped_skip_sum_fwd_actint8", {"many_rows": steps}))
    check(out["path"] == "scan" and all(np.isfinite(out["losses"][t]).all() for t in range(FAM_TENANTS)),
          f"{cfg.name} session adapt: path {out['path']}, losses {out['losses']}")
    prompts = toks[[0, 1, 0, 1], 0, :PROMPT]
    t0 = time.perf_counter()
    served = rt.serve([0, 1, None, None], prompts, max_new=NEW)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    window({"grouped_skip_sum_fwd": 1 + NEW}, ("grouped_skip_sum_fwd", {"few_rows": 1 + NEW}))
    check(tuple(served.shape) == (4, NEW), f"{cfg.name} session serve: tokens {tuple(served.shape)}")
    print(f"families session {cfg.name} full width mode=int8 on {device_name}: {FAM_TENANTS} tenants x "
          f"{FAM_SAMPLES} ingested in {t_ingest:.3f} s ({FAM_TENANTS * FAM_SAMPLES / t_ingest:.1f} rows/s), "
          f"adapt(epochs=1) {t_adapt:.3f} s ({steps} steps: grouped_skip_sum_fwd_actint8 + grouped_skip_sum_bwd "
          f"x{steps}), serve 2 tenants + 2 base rows {t_serve:.3f} s ({4 * NEW / t_serve:.1f} tok/s, "
          f"grouped_skip_sum_fwd x{1 + NEW}); mean losses "
          f"{', '.join(f'{float(np.mean(out['losses'][t])):.4f}' for t in range(FAM_TENANTS))}")
    return totals


def _reduced_card_vs_cpu(torch, arch):
    """A reduced float32 config (live norms) on the card and on the CPU,
    within ``REDUCED_TOL`` of each fp32 output's largest value: the train
    forward's hidden states and aux, a prefill's logits and fp32 states
    (its bf16 cache leaves within one bf16 ulp of theirs), and a decode
    step's logits from the CPU prefill's caches on both (a cache entry one
    bf16 ulp apart would move a step's logits by ~1e-4); grouped greedy
    tokens equal. Returns (largest relative difference, its output)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.runtime import generate_grouped
    from repro_torch.launch.serve import demo_pool
    from repro_torch.models import lm as LM

    cfg = reduce_config(get_config(arch))
    params = _live_norms(LM.init_lm(torch.Generator().manual_seed(0), cfg), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, 12), generator=torch.Generator().manual_seed(4))
    pool = demo_pool(cfg, TENANTS, RANK, None, "cpu")
    idx = pool.lookup([None, "tenant-0", "tenant-1", "tenant-2"])
    kinds = cfg.layer_kinds()
    outs, cpu_caches = {}, None
    for where in ("cpu", "cuda"):
        p = _to(params, where)
        with torch.no_grad():
            fwd = LM.lm_forward(p, cfg, tokens.to(where), mode="train")
            caches = LM.init_serve_caches(cfg, BATCH, 16, device=where)
            logits, caches = LM.serve_prefill(p, cfg, tokens.to(where), caches)
            if cpu_caches is None:
                cpu_caches = [{n: t.clone() for n, t in c.items()} for c in caches]
            same = [{n: t.to(where, copy=True) for n, t in c.items()} for c in cpu_caches]
            step, _ = LM.serve_decode(p, cfg, tokens[:, -1:].to(where), 12, same)
        toks = generate_grouped(p, cfg, tokens.to(where), _to(pool.pools(), where), idx.to(where), max_new=8,
                                device=where)
        named = {"forward h": fwd["h"], "aux": fwd["aux"], "prefill logits": logits, "decode-step logits": step}
        named.update({f"layer {i} {kinds[i]} {n}": t for i, c in enumerate(caches) for n, t in c.items()})
        outs[where] = (named, toks)
    worst = (0.0, "")
    for name, a in outs["cpu"][0].items():
        b = outs["cuda"][0][name].cpu()
        err, mag = _rel_err(b.float(), a.float())
        rel = err / max(mag, 1e-30)
        tol = 2.0**-7 if a.dtype == torch.bfloat16 else REDUCED_TOL
        check(rel <= tol, f"reduced {arch}: {name} card vs CPU {rel:.3e} of its largest value > {tol:g}")
        if a.dtype != torch.bfloat16:
            worst = max(worst, (rel, name))
    check(torch.equal(outs["cpu"][1], outs["cuda"][1].cpu()), f"reduced {arch}: card tokens "
          f"{outs['cuda'][1].tolist()} != CPU tokens {outs['cpu'][1].tolist()}")
    return worst


def families_phase(torch, device_name):
    """The other model families (``models/moe.py``, ``models/ssm.py``,
    ``models/frontend.py``) on the card, after the earlier phases' device
    memory is freed:
      - K1, K2, K5 and K9 against their plain versions at D 1024 and 1536;
      - qwen2-moe-a2.7b at full width (24 layers, d 2048, 60 experts top-4
        + a 5632-wide shared FFN, vocab 151936, seeded bf16 weights drawn on
        the card): grouped serving (K5), the finetune loop in modes full
        and int8, a populate and two cached epochs (K1/K3 + K2), one
        session round (K5, K8, K9);
      - xlstm-350m (grouped serving, a populate and a cached epoch),
        paligemma-3b and musicgen-medium (a prefix serve, a populate and a
        cached epoch), each at full width;
      - phi3.5-moe and jamba-1.5-large reduced, float32, card vs CPU.
    Each family's populate and cached epoch s, serve tok/s and peak GiB.
    Returns each kernel's launches on these paths."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm as LM

    t_phase = time.perf_counter()
    held = _free_device(torch)
    print(f"families phase: {held:.2f} GiB still allocated after freeing the earlier phases' graphs")
    _width_kernels(torch)
    totals: dict[str, int] = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    dev = torch.device("cuda")
    summary = []
    for arch in ("qwen2-moe-a2.7b", "xlstm-350m", "paligemma-3b", "musicgen-medium"):
        t_fam = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        params = _live_norms(LM.init_lm(torch.Generator(device=dev).manual_seed(0), cfg), cfg)
        if cfg.frontend is None:
            k5, tps = _family_serve(torch, cfg, params, device_name)
            add({"grouped_skip_sum_fwd": k5})
        else:
            tps = _family_prefix_serve(torch, cfg, params, device_name)
        epoch_s = []
        for mode in (("full", "int8") if cfg.moe is not None else ("full",)):
            counts, times = _family_train(torch, arch, mode, 3 if cfg.moe is not None else 2, device_name, params)
            add(counts)
            epoch_s.append(f"{mode} populate {times[0]:.3f} s (replayed {times[-1]:.3f} s), cached "
                           f"{' / '.join(f'{t:.3f}' for t in times[1:-1])} s")
        if cfg.moe is not None:
            add(_family_session(torch, cfg, params, device_name))
        peak = torch.cuda.max_memory_allocated() / 2**30
        summary.append(f"{arch}: {'; '.join(epoch_s)}; serve {tps:.1f} tok/s; peak {peak:.2f} GiB; "
                       f"{time.perf_counter() - t_fam:.1f} s")
        del params
        _free_device(torch)
    for arch in ("phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b"):
        worst, what = _reduced_card_vs_cpu(torch, arch)
        print(f"families small: reduced {arch} float32 card vs CPU: forward, aux, prefill logits and states, a "
              f"decode step from the same caches within {REDUCED_TOL:g} of each output's largest value (max "
              f"{worst:.2e}, {what}; bf16 cache leaves within one ulp), grouped greedy tokens equal")
    _reset_launches()
    for line in summary:
        print(f"families {line} on {device_name}")
    print(f"families phase: {time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals


#: the model axis phase's bars, stated before any run: the split backbone
#: against the unsplit one in bf16 at full width, the largest difference
#: over the largest |value| (the split reorders bf16 partial sums in every
#: layer); the pipelined admission reuses the unsplit layers. The MoE's
#: top-4 routing turns a one-ulp change of a router input near a tie into
#: another expert, so the full-width split is held against the unsplit
#: run's routing (``_routing``) and the unpinned difference is printed
#: beside it; the split's own routing is held in float32 at reduced width
#: (``_model_axis_fp32``, ``TP_FP32_BAR``, greedy tokens equal). The
#: pipelined admission's logits must also stay under
#: ``PIPE_SKIP_SHARE`` of what the adapters' skip terms move them by, so a
#: pipeline that drops one of its two stages' terms fails
TP_LOGIT_BAR = 0.05
TP_LOSS_BAR = 1e-2
TP_GRAD_BAR = 0.05
TP_FP32_BAR = 1e-4
PIPE_LOGIT_BAR = 1e-2
PIPE_SKIP_SHARE = 0.25
MODEL_AXIS_ARCH = "qwen2-moe-a2.7b"


def _rel_max(torch, got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _explained(torch, got, want, what) -> str:
    """A flip of the greedy token between two computations of one row's
    logits (``want`` the unsplit's, ``got`` the other's, (V,)) is a near
    tie when ``want`` ranks the other's pick within ``TOP2_REL_TOL`` of its
    largest |logit| below its own argmax (``_near_tie_flips``' rule), and
    the two competing tokens' own differences cover that gap (|d top1| +
    |d pick| >= gap). Fails otherwise; returns the line to print."""
    w, g = want.float(), got.float()
    t1, pick = int(w.argmax()), int(g.argmax())
    gap, mag = (w[t1] - w[pick]).item(), w.abs().max().item()
    own = ((g[t1] - w[t1]).abs() + (g[pick] - w[pick]).abs()).item()
    check(gap <= TOP2_REL_TOL * mag and gap <= own,
          f"{what}: the argmax moves from {t1} to {pick} at a gap {gap:.3e} (bar {TOP2_REL_TOL * mag:.3e}), the two "
          f"tokens' own differences {own:.3e}")
    return (f"gap {gap:.3e} <= {TOP2_REL_TOL} x max |logit| {TOP2_REL_TOL * mag:.3e} and <= |d top1| + |d pick| "
            f"{own:.3e}")


def _argmax_flips(torch, got, want, what):
    """Rows of (A, 1, V) logits whose argmax differs, each explained by
    ``_explained``. Returns one line per flip."""
    flips = []
    for i in torch.nonzero(got.argmax(-1).flatten() != want.argmax(-1).flatten()).flatten().tolist():
        flips.append(f"row {i}: {_explained(torch, got[i, -1], want[i, -1], what)}")
    return flips


def _split_flips(torch, toks_a, toks_b, logits_a, logits_b):
    """Greedy tokens of the unsplit run (``toks_a``) and the split one
    (``toks_b``) with the logits each sampled from (``_sampled``): where
    row i first differs (token d, so both saw the same tokens before it),
    the two runs' logits of that sample must differ by at most
    ``TP_LOGIT_BAR`` of the largest |logit| and explain the flip
    (``_explained``). Returns one line per flip."""
    flips = []
    for i in range(toks_a.shape[0]):
        diff = torch.nonzero(toks_a[i] != toks_b[i]).flatten()
        if not diff.numel():
            continue
        d = int(diff[0])
        la, lb = logits_a[d][i, -1], logits_b[d][i, -1]
        err = _rel_max(torch, lb, la)
        check(err <= TP_LOGIT_BAR, f"model axis serve: row {i} token {d}: logits {err:.3e} > {TP_LOGIT_BAR}")
        flips.append(f"row {i} token {d}: {_explained(torch, lb, la, 'model axis serve')}")
    return flips


@contextlib.contextmanager
def _sampled(torch, log):
    """Every greedy sample inside (``lm.sample_token``, as the decode steps
    and the generation entry points call it) logs the logits it read."""
    from repro_torch.core import runtime as RT
    from repro_torch.models import lm as LM

    real = LM.sample_token

    def sample(logits, *a, **kw):
        log.append(logits.float().cpu())
        return real(logits, *a, **kw)

    LM.sample_token = RT.sample_token = sample
    try:
        yield
    finally:
        LM.sample_token = RT.sample_token = real


@contextlib.contextmanager
def _routing(torch, log, replay):
    """Every MoE routing (``moe.route``) inside: recorded into ``log`` in
    call order, or, with ``replay``, the next recorded decision returned in
    its place (the same call order: the split run of the unsplit run's
    calls). Yields a dict whose "flips" counts, on replay, the tokens whose
    own routing would have picked other experts, and "tokens" all."""
    from repro_torch.models import moe as MOE

    real, seen = MOE.route, {"flips": 0, "tokens": 0}

    def record(router_w, x, mcfg):
        out = real(router_w, x, mcfg)
        log.append(out)
        return out

    def pinned(router_w, x, mcfg):
        out, own = log.pop(0), real(router_w, x, mcfg)
        check(out[1].shape == own[1].shape, f"replayed routing {tuple(out[1].shape)} for {tuple(own[1].shape)}")
        seen["flips"] += int((out[1].sort(-1).values != own[1].sort(-1).values).any(-1).sum())
        seen["tokens"] += own[1][..., 0].numel()
        return out

    MOE.route = pinned if replay else record
    try:
        yield seen
    finally:
        MOE.route = real


def _skip_loss(torch, params, cfg, acts, y_base, labels, adapters):
    """One cached-loss step (the session's adapt step without the update):
    the skip term of ``adapters`` over the cached block inputs, the readout
    loss of the cached hidden plus it, and the adapters' gradients."""
    from repro_torch.models import lm as LM

    a, b = (adapters[k].detach().clone().requires_grad_(True) for k in ("A", "B"))
    skip = torch.einsum("lbsr,lrd->bsd", torch.einsum("lbsd,ldr->lbsr", acts.float(), a), b)
    loss = LM.lm_loss(params, cfg, y_base + skip.to(y_base.dtype), labels)
    loss.backward()
    return loss.detach(), a.grad, b.grad


def model_axis_phase(torch, device_name):
    """The model axis (``models.tp``, ``runtime.pipeline_par``) on one card:
    qwen2-moe-a2.7b at full width (bf16, seeded weights, RMSNorm scales 1),
    its outputs unsplit first, then the backbone split two ways over the
    group ``[cuda:0, cuda:0]`` (``sharding.shard_backbone``) and the unsplit
    params freed: member bytes against ``per_device_bytes``, prefill logits,
    greedy grouped serving (float pool, ``use_kernel=False``, 3 tenants and a
    base row) and one cached-loss step against the unsplit ones, the
    split's own routing in float32 at reduced width (``_model_axis_fp32``),
    and the pipelined admission (``lm.pipeline_sched_prefill``, 2 stages on
    ``[cuda:0, cuda:0]``) against ``sched_prefill``. With two cards, the
    reduced 2-D session over ``[cuda:0, cuda:1]`` against the same over
    ``["cpu", "cpu"]``. No hand-written kernel launches here, as in the
    reference, where a model axis refuses them."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import generate_grouped, generate_loop
    from repro_torch.launch.serve import demo_pool
    from repro_torch.models import lm as LM
    from repro_torch.models import tp as TP
    from repro_torch.runtime import sharding as SH

    t_phase = time.perf_counter()
    _free_device(torch)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda", 0)
    group = [dev, dev]
    cfg = get_config(MODEL_AXIS_ARCH)
    params = _live_norms(LM.init_lm(torch.Generator(device=dev).manual_seed(0), cfg), cfg)
    gen = torch.Generator(device=dev).manual_seed(11)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    pool = demo_pool(cfg, TENANTS, RANK, None, dev)
    who = [None] + [f"tenant-{i % TENANTS}" for i in range(1, BATCH)]
    idx = pool.lookup(who)
    tokens = torch.randint(0, cfg.vocab_size, (2, PROMPT), generator=gen, device=dev)
    labels = torch.randint(0, cfg.vocab_size, (2, PROMPT), generator=gen, device=dev)
    lens = torch.tensor([PROMPT, PROMPT * 3 // 4, PROMPT // 2, 1], device=dev)
    adapters = {"A": torch.randn((cfg.n_layers, cfg.d_model, RANK), generator=gen, device=dev) / cfg.d_model**0.5,
                "B": torch.randn((cfg.n_layers, RANK, cfg.d_model), generator=gen, device=dev) * 0.01}
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    # -- the unsplit outputs, kept alone, their routing recorded -----------
    prefill_routes, serve_routes = [], []
    with torch.no_grad():
        with _routing(torch, prefill_routes, False):
            want_logits = timed("prefill 1-way", lambda: LM.serve_prefill(
                params, cfg, prompts, LM.init_serve_caches(cfg, BATCH, PROMPT, device=dev))[0])
        want_samples = []
        with _routing(torch, serve_routes, False), _sampled(torch, want_samples):
            want_toks = timed("serve 1-way (eager loop)", lambda: generate_loop(
                params, cfg, prompts, max_new=NEW, pools=pool.pools(), idx=idx, use_kernel=False, device=dev))
        graphed = timed("serve 1-way (graphed)", lambda: generate_grouped(
            params, cfg, prompts, pool.pools(), idx, max_new=NEW, use_kernel=False, device=dev))
        check(torch.equal(graphed, want_toks), "model axis: the unsplit graphed serve != its eager loop")
        out = LM.lm_forward(params, cfg, tokens, mode="train", collect_acts=True)
        acts, y_base = out["acts"], out["y_base"]
        del out
        # the admission a microbatch at a time (the pipeline's row counts,
        # so its products' shapes and routing inputs), without the
        # adapters, and whole; its tenants' B drawn 10x the demo's, so
        # their skip terms move the logits well above bf16 rounding
        adm_pools = {k: v.clone() for k, v in pool.pools().items()}
        adm_pools["B"].mul_(10.0)
        mb = BATCH // 2

        def admission(slots):
            return torch.cat([LM.sched_prefill(params, cfg, prompts[m:m + mb], lens[m:m + mb], adm_pools,
                                               slots[m:m + mb], use_kernel=False)[0] for m in range(0, BATCH, mb)])

        want_adm = timed("admission 1-way", lambda: admission(idx))
        skip_share = _rel_max(torch, admission(torch.zeros_like(idx)), want_adm)
        whole_adm = LM.sched_prefill(params, cfg, prompts, lens, adm_pools, idx, use_kernel=False)[0]
    want_loss = timed("loss 1-way", lambda: _skip_loss(torch, params, cfg, acts, y_base, labels, adapters))

    # -- the pipelined admission: 2 GPipe stages of the unsplit layers --------
    stages, valid = LM.pipeline_stage_params(params, cfg, 2)
    with torch.no_grad():
        got_adm = timed("admission pipelined", lambda: LM.pipeline_sched_prefill(
            params, cfg, stages, valid, prompts, lens, adm_pools, idx, devices=group, n_micro=2)[0])
    pipe_err = _rel_max(torch, got_adm, want_adm)
    check(pipe_err <= PIPE_LOGIT_BAR and pipe_err <= PIPE_SKIP_SHARE * skip_share,
          f"model axis pipelined admission: logits {pipe_err:.3e} > {PIPE_LOGIT_BAR} or > {PIPE_SKIP_SHARE} of the "
          f"skip terms' {skip_share:.3e}")
    pipe_flips = _argmax_flips(torch, got_adm, want_adm, "model axis pipelined admission")
    whole_err = _rel_max(torch, got_adm, whole_adm)
    whole_same = int((got_adm.argmax(-1) == whole_adm.argmax(-1)).sum())
    del stages, valid, got_adm, whole_adm, adm_pools

    # -- the split: two members on one card, the unsplit params freed ---------
    gp = timed("shard_backbone", lambda: TP.group_params(params, group))
    total = sum(t.numel() * t.element_size() for t in SH._leaves(params))
    del params
    _free_device(torch)   # the unsplit serve's decode graphs too
    mesh = SH.group_mesh(group)
    shapes = LM.param_shapes(cfg)
    want_bytes = SH.per_device_bytes(shapes, SH.param_specs(shapes, mesh), mesh)
    member_bytes = [sum(t.numel() * t.element_size() for t in SH._leaves(m)) for m in gp.members]
    check(all(b == want_bytes for b in member_bytes),
          f"model axis: member bytes {member_bytes} != per_device_bytes {want_bytes}")
    check(total / max(member_bytes) > 1.5, f"model axis: total / member bytes {total / max(member_bytes):.3f} <= 1.5")

    def split_prefill():
        caches = LM.init_serve_caches(cfg, BATCH, PROMPT, device=dev, params=gp)
        check(isinstance(caches[0]["k"], TP.HeadSplit), "model axis: the split's caches are not split by heads")
        return LM.serve_prefill(gp, cfg, prompts, caches)[0]

    def split_serve():
        return generate_grouped(gp, cfg, prompts, pool.pools(), idx, max_new=NEW, use_kernel=False, device=dev)

    with torch.no_grad():
        with _routing(torch, prefill_routes, True) as pinned_prefill:
            got_logits = timed("prefill split", split_prefill)
        got_samples = []
        with _routing(torch, serve_routes, True) as pinned_serve, _sampled(torch, got_samples):
            got_toks = timed("serve split", split_serve)
        free_logits = split_prefill()
        free_toks = split_serve()
    check(not prefill_routes and not serve_routes, "model axis: the split made other routing calls")
    logit_err = _rel_max(torch, got_logits, want_logits)
    check(logit_err <= TP_LOGIT_BAR, f"model axis prefill logits: {logit_err:.3e} > {TP_LOGIT_BAR}")
    free_err = _rel_max(torch, free_logits, want_logits)
    free_rows = int((free_toks == want_toks).all(-1).sum())
    serve_flips = _split_flips(torch, want_toks.cpu(), got_toks.cpu(), want_samples, got_samples)
    del want_samples, got_samples
    got_loss = timed("loss split", lambda: _skip_loss(torch, gp, cfg, acts, y_base, labels, adapters))
    loss_err = abs(got_loss[0].item() - want_loss[0].item()) / abs(want_loss[0].item())
    grad_err = max(_rel_max(torch, g, w) for g, w in zip(got_loss[1:], want_loss[1:]))
    check(loss_err <= TP_LOSS_BAR and grad_err <= TP_GRAD_BAR,
          f"model axis cached-loss step: loss {loss_err:.3e} (bar {TP_LOSS_BAR}), gradients {grad_err:.3e} "
          f"(bar {TP_GRAD_BAR})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = _launches()
    check(not any(counts.values()), f"model axis: hand-written kernels launched {counts}")
    del gp, acts, y_base
    torch.cuda.empty_cache()
    fp32 = _model_axis_fp32(torch)
    two = _model_axis_two_cards(torch) if torch.cuda.device_count() >= 2 else None
    check(not any(_launches().values()), f"model axis: hand-written kernels launched {_launches()}")
    _reset_launches()

    print(f"model axis {MODEL_AXIS_ARCH} full width bf16 split 2 ways over [cuda:0, cuda:0] on {device_name}: "
          f"member bytes {member_bytes[0]} ({member_bytes[0] / 1e9:.2f} GB) each == per_device_bytes, the whole "
          f"{total} ({total / 1e9:.2f} GB), ratio {total / max(member_bytes):.3f}; peak {peak:.2f} GiB "
          f"(the unsplit params beside the split at the shard_backbone call)")
    print(f"model axis prefill logits ({BATCH}x{PROMPT}), routing pinned to the unsplit run's: split vs unsplit "
          f"max diff / max |logit| {logit_err:.3e} (bar {TP_LOGIT_BAR}); the split's own routing would pick other "
          f"experts for {pinned_prefill['flips']} of {pinned_prefill['tokens']} token-layers, and unpinned the "
          f"logits differ by {free_err:.3e}")
    print(f"model axis grouped serve (float pool, use_kernel=False, 3 tenants + base row, {NEW} new, greedy), "
          f"routing pinned: split tokens == the unsplit eager loop's"
          f"{' except where numerics explain a flip: ' + '; '.join(serve_flips) if serve_flips else ''} "
          f"(unsplit graphed == eager); "
          f"the split's own routing differs at {pinned_serve['flips']} of {pinned_serve['tokens']} token-layers; "
          f"unpinned, {free_rows} of {BATCH} rows keep every token")
    print(f"model axis cached-loss step (2x{PROMPT}, rank {RANK}): loss {got_loss[0].item():.6f} vs "
          f"{want_loss[0].item():.6f}, rel diff {loss_err:.3e} (bar {TP_LOSS_BAR}); adapter gradients max diff / max "
          f"{grad_err:.3e} (bar {TP_GRAD_BAR})")
    print(fp32)
    print(f"model axis pipelined admission (pipeline_sched_prefill, 2 stages on [cuda:0, cuda:0], 2 microbatches, "
          f"lens {lens.tolist()}, tenants' B 10x the demo's): logits vs sched_prefill a microbatch at a time max "
          f"diff / max |logit| {pipe_err:.3e} (bars {PIPE_LOGIT_BAR} and {PIPE_SKIP_SHARE} x {skip_share:.3e}, "
          f"what the skip terms move the logits by: no adapters vs adapters), admission tokens equal"
          f"{' except where numerics explain a flip: ' + '; '.join(pipe_flips) if pipe_flips else ''}; against one "
          f"sched_prefill of "
          f"all {BATCH} rows (other product shapes, other routing inputs) {whole_err:.3e}, {whole_same} of "
          f"{BATCH} tokens equal")
    print("model axis host seconds (synchronised): " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    if two is None:
        print(f"model axis two cards: not run, this machine has {torch.cuda.device_count()} card (the (1 x 2) "
              f"session over [cuda:0, cuda:1] and phi3.5-moe-42b-a6.6b split over two cards need two)")
    else:
        print(two)
    print(f"model axis phase: {time.perf_counter() - t_phase:.1f} s; no hand-written kernel launched")


def _model_axis_fp32(torch):
    """The split's own routing, unpinned: reduced qwen2-moe-a2.7b in float32
    (vocabulary 512, TF32 off as ``main`` sets it) split over ``[cuda:0, cuda:0]`` against the
    unsplit backbone on the card: train forward and serve prefill logits
    within ``TP_FP32_BAR`` of the largest value, and grouped greedy serving
    (float pool, ``use_kernel=False``, the caches split by heads) token for
    token. Returns the line."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.runtime import generate_grouped
    from repro_torch.launch.serve import demo_pool
    from repro_torch.models import lm as LM
    from repro_torch.models import tp as TP

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(reduce_config(get_config(MODEL_AXIS_ARCH)), vocab_size=512, dtype="float32")
    params = _live_norms(LM.init_lm(torch.Generator(device=dev).manual_seed(0), cfg), cfg)
    gp = TP.group_params(params, [dev, dev])
    gen = torch.Generator(device=dev).manual_seed(12)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, 16), generator=gen, device=dev)
    pool = demo_pool(cfg, TENANTS, RANK, None, dev)
    idx = pool.lookup([None] + [f"tenant-{i % TENANTS}" for i in range(1, BATCH)])
    check(not torch.backends.cuda.matmul.allow_tf32, "model axis fp32: TF32 products on")
    with torch.no_grad():
        h = [LM.lm_forward(p, cfg, prompts)["h"] for p in (params, gp)]
        logits = [LM.serve_prefill(p, cfg, prompts, LM.init_serve_caches(cfg, BATCH, 16, device=dev, params=p))[0]
                  for p in (params, gp)]
        toks = [generate_grouped(p, cfg, prompts, pool.pools(), idx, max_new=NEW, use_kernel=False, device=dev)
                for p in (params, gp)]
    h_err, l_err = _rel_max(torch, h[1], h[0]), _rel_max(torch, logits[1], logits[0])
    check(h_err <= TP_FP32_BAR and l_err <= TP_FP32_BAR,
          f"model axis fp32: hidden {h_err:.3e}, logits {l_err:.3e} > {TP_FP32_BAR}")
    check(torch.equal(toks[0], toks[1]), "model axis fp32: the split's greedy tokens differ from the unsplit's")
    return (f"model axis fp32 (reduced {MODEL_AXIS_ARCH}, vocab 512, TF32 off) split over [cuda:0, cuda:0], own "
            f"routing: hidden {h_err:.3e}, prefill logits {l_err:.3e} of the largest value (bar {TP_FP32_BAR}); "
            f"grouped greedy serve ({BATCH}x16 + {NEW} new, caches split by heads) tokens equal "
            f"({time.perf_counter() - t0:.1f} s)")


def _model_axis_two_cards(torch):
    """The reduced float32 (1 data x 2 model) session over [cuda:0, cuda:1]
    (``make_mesh``), with ``pipeline_stages=2`` and without, against the same
    session over ["cpu", "cpu"] (adapters within rtol 1e-4 / atol 1e-6,
    slot tables, serve and scheduler tokens equal). Returns the line."""
    import numpy as np

    from repro_torch.core import lm_skiplora as SL
    from repro_torch.core.runtime import SessionRuntime
    from repro_torch.models import lm as LM
    from repro_torch.models.config import ModelConfig
    from repro_torch.runtime.sharding import _to, make_mesh

    cfg = ModelConfig(name="t", family="test", n_layers=4, d_model=16, n_heads=4, n_kv_heads=2, d_ff=32,
                      vocab_size=64, pattern=("attn",), dtype="float32")

    def session(devices, stages):
        params = _live_norms(LM.init_lm(torch.Generator().manual_seed(0), cfg), cfg)
        params = _to(params, torch.device(devices[0]))
        rt = SessionRuntime(cfg, SL.SkipLoRAConfig(rank=2, mode="full"), params, max_tenants=2,
                            samples_per_tenant=4, seq=6, use_kernel=False, seed=0, pipeline_stages=stages,
                            mesh=make_mesh((1, 2), ("data", "model"), devices=devices))
        g = np.random.default_rng(5)
        for t in ("a", "b"):
            rt.ingest(t, g.integers(0, 64, (4, 6)), g.integers(0, 64, (4, 6)))
        rt.adapt(["a", "b"], epochs=2, batch_per_tenant=2, generator=torch.Generator().manual_seed(7))
        prompts = g.integers(0, 64, (3, 5))
        toks = rt.serve([None, "a", "b"], prompts, max_new=4).cpu()
        rt.attach_scheduler(max_batch=4, max_prompt=5, max_new_cap=6, admit_bucket=2, chunk=2)
        reqs = [rt.enqueue_serve(t, prompts[j, :4 - j], max_new=5) for j, t in enumerate(("a", None, "b"))]
        rt.drain()
        return rt, toks, [r.result().tolist() for r in reqs]

    t0 = time.perf_counter()
    for stages in (0, 2):
        card, toks_card, sched_card = session([torch.device("cuda", 0), torch.device("cuda", 1)], stages)
        cpu, toks_cpu, sched_cpu = session(["cpu", "cpu"], stages)
        for t in ("a", "b"):
            for k in ("A", "B"):
                check(np.allclose(card.tenant(t).adapters[k].cpu().numpy(), cpu.tenant(t).adapters[k].numpy(),
                                  rtol=1e-4, atol=1e-6), f"model axis two cards (stages {stages}): adapters {t} {k}")
        check(card.pool.slot_table() == cpu.pool.slot_table(), f"model axis two cards (stages {stages}): slots")
        check(torch.equal(toks_card, toks_cpu) and sched_card == sched_cpu,
              f"model axis two cards (stages {stages}): tokens differ")
        del card, cpu
    small_s = time.perf_counter() - t0
    return (f"model axis two cards: the reduced float32 (1 x 2) session over [cuda:0, cuda:1], with "
            f"pipeline_stages=2 and without, == the same over [cpu, cpu] (adapters within rtol 1e-4 / atol 1e-6, "
            f"slot tables, serve and scheduler tokens equal; {small_s:.1f} s)\n" + _phi_two_cards(torch))


def _phi_two_cards(torch):
    """phi3.5-moe-42b-a6.6b at full width (83.75 GB bf16) over a (1 data x 2
    model) session mesh on [cuda:0, cuda:1], drawn split
    (``tp.init_group_params``, a part at a time, RMSNorm scales 1):
    each card's backbone bytes at most 0.55 of the whole, 2 tenants
    ingest 4 x 128 tokens each, adapt one epoch, then a grouped serve (4
    x 128 prompt, 32 new, greedy). Returns the line."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import lm_skiplora as SL
    from repro_torch.core.runtime import SessionRuntime
    from repro_torch.models import lm as LM
    from repro_torch.models import tp as TP
    from repro_torch.runtime import sharding as SH

    cfg = get_config("phi3.5-moe-42b-a6.6b")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    gp = TP.init_group_params(torch.Generator(device=cards[0]).manual_seed(0), cfg, cards,
                              prepare=lambda key, tree: _live_part(cfg, key, tree))
    for d in cards:
        torch.cuda.synchronize(d)
    draw_s = time.perf_counter() - t0
    total = sum(t.numel() * t.element_size() for t in SH._leaves(LM.param_shapes(cfg)))
    per_card = [sum(t.numel() * t.element_size() for t in SH._leaves(m)) for m in gp.members]
    check(max(per_card) <= 0.55 * total, f"phi3.5 two cards: a card holds {max(per_card)} of {total} bytes")
    rt = SessionRuntime(cfg, SL.SkipLoRAConfig(rank=RANK, mode="full"), gp, max_tenants=2, samples_per_tenant=4,
                        seq=PROMPT, use_kernel=False, mesh=SH.make_mesh((1, 2), ("data", "model"), devices=cards))
    g = np.random.default_rng(5)
    t0 = time.perf_counter()
    for t in ("a", "b"):
        rt.ingest(t, g.integers(0, cfg.vocab_size, (4, PROMPT)), g.integers(0, cfg.vocab_size, (4, PROMPT)))
    out = rt.adapt(["a", "b"], epochs=1, batch_per_tenant=2, generator=torch.Generator().manual_seed(7))
    for d in cards:
        torch.cuda.synchronize(d)
    adapt_s = time.perf_counter() - t0
    check(all(np.isfinite(v).all() for v in out["losses"].values()), "phi3.5 two cards: adapt losses not finite")
    prompts = g.integers(0, cfg.vocab_size, (BATCH, PROMPT))
    t0 = time.perf_counter()
    toks = rt.serve([None, "a", "b", "a"], prompts, max_new=NEW)
    for d in cards:
        torch.cuda.synchronize(d)
    serve_s = time.perf_counter() - t0
    check(tuple(toks.shape) == (BATCH, NEW) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "phi3.5 two cards: serve tokens out of range")
    peaks = [torch.cuda.max_memory_allocated(d) / 2**30 for d in cards]
    del rt, gp
    torch.cuda.empty_cache()
    return (f"model axis phi3.5-moe-42b-a6.6b full width over (1 x 2) [cuda:0, cuda:1], drawn split in "
            f"{draw_s:.1f} s: backbone bytes a card {per_card} of {total} ({max(per_card) / total:.3f} of the "
            f"whole, bar 0.55); 2 tenants x 4 x {PROMPT} ingested and one adapt epoch {adapt_s:.2f} s (losses "
            f"finite); grouped serve {BATCH}x{PROMPT} + {NEW} new {serve_s:.2f} s = {BATCH * NEW / serve_s:.1f} tok/s "
            f"(eager decode); peaks {peaks[0]:.2f} / {peaks[1]:.2f} GiB")


# ---------------------------------------------------------------------------
# 16. dryrun: the dry-run's cells, the recurrent mixers on a group, int8 state
# ---------------------------------------------------------------------------

#: one production cell of each step kind on the 16 x 16 meta mesh
DRY_META = [("stablelm-1.6b", "train_4k", "train"), ("stablelm-1.6b", "train_4k", "finetune_populate"),
            ("stablelm-1.6b", "train_4k", "finetune_cached"), ("stablelm-1.6b", "prefill_32k", "prefill"),
            ("stablelm-1.6b", "decode_32k", "decode"), ("stablelm-1.6b", "decode_32k", "decode_adapted"),
            ("xlstm-350m", "long_500k", "decode"), ("jamba-1.5-large-398b", "decode_32k", "decode")]
DRY_WORKERS = 4
#: (step kind, (batch, seq), groups): stablelm-1.6b cells a card holds;
#: the cached step at the train phase's shape, 8 x 128 (PERF.md section 7's question)
DRY_CARD = [("train", (8, 512), (1, 2)), ("finetune_cached", (8, 128), (1,)), ("prefill", (4, 2048), (1, 2)),
            ("decode", (32, 2048), (1, 2))]
DRY_PEAK_BAND = (0.8, 1.25)
XLSTM_FP32_LOGIT_BAR = 1e-3
XLSTM_FP32_LOSS_BAR = 1e-4
XLSTM_FP32_GRAD_BAR = 1e-3
QUANT_UPDATE_BAR = 1e-6


def _dry_meta(src, arch, shape, step):
    """A worker process's production cell on meta (no card is touched)."""
    sys.path.insert(0, src)
    import torch

    from repro_torch.launch import dryrun as D

    torch.set_num_threads(1)
    rec = D.run_cell(arch, shape, step)
    rec.pop("per_member")
    return rec


def _dry_card_cell(torch, kind, bs, n, device_name, arch=ARCH, tag="", inspect=None):
    """One cell a card holds (stablelm-1.6b unless ``arch``), counted on
    meta and for real; ``inspect(cell)`` sees the card's cell before it is
    counted. The record gains the card's step ms, peak and peak / counted."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline
    from repro_torch.launch.flops import model_flops
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.runtime import sharding as SH

    cfg = get_config(arch)
    cell_shape = ShapeCell(f"{kind}_{bs[0]}x{bs[1]}", "train" if kind.startswith(("train", "fine")) else
                           ("prefill" if kind == "prefill" else "decode"), bs[1], bs[0])
    mesh = SH.make_mesh((1, n), ("data", "model"), devices=["meta"] * n)
    dev = torch.device("cuda", 0)
    meta = D.count_cell(D.prepare_cell(cfg, cell_shape, kind, mesh=mesh))
    _free_device(torch)
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    cell = D.prepare_cell(cfg, cell_shape, kind, mesh=mesh, group=[dev] * n)
    torch.cuda.synchronize()
    held = torch.cuda.memory_stats()["requested_bytes.all.current"] - before
    if inspect is not None:
        inspect(cell)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec = D.count_cell(cell)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base + held
    check(held == rec["argument_bytes_all_members"], f"dryrun {kind} 1x{n}: the allocator was asked for {held} B "
          f"of arguments, their storages hold {rec['argument_bytes_all_members']} B")
    for f in ("dot_flops", "collective_bytes", "collective_count"):
        check(rec[f] == meta[f], f"dryrun {kind} 1x{n}: {f} on the card {rec[f]} != meta {meta[f]}")
    if n == 1:
        check(rec["argument_size_in_bytes"] == rec["argument_bytes_all_members"],
              f"dryrun {kind} 1x1: spec-tree argument bytes {rec['argument_size_in_bytes']} != the args' "
              f"{rec['argument_bytes_all_members']}")
    predicted = rec["argument_bytes_all_members"] + rec["peak_bytes_all_members"]
    ratio = peak / predicted
    check(DRY_PEAK_BAND[0] <= ratio <= DRY_PEAK_BAND[1],
          f"dryrun {kind} 1x{n}: peak {peak} B / counted {predicted} B = {ratio:.3f} outside {DRY_PEAK_BAND}")
    # device time: a warm-up, then CUDA events around one step
    out = cell.fn(*cell.args)
    del out
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 3 if kind != "train" else 1
    t0.record()
    for _ in range(reps):
        out = cell.fn(*cell.args)
        del out
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    mf = model_flops(cfg, bs, kind)
    mfu = roofline.mfu(mf, ms / 1e3)
    rec.update(card_ms=ms, card_peak=peak, card_ratio=ratio)
    line = (f"{tag}dryrun card {arch} {kind} {bs[0]}x{bs[1]} 1x{n} on {device_name}: meta == card (dot FLOPs "
            f"{rec['dot_flops']:.4e}, collective bytes {rec['collective_bytes']:.4e}, {rec['collective_count']} "
            f"collectives); arguments {held} B == the allocator's requested bytes; peak {peak / 2**30:.3f} GiB / counted "
            f"{predicted / 2**30:.3f} GiB = {ratio:.3f}; {ms:.3f} ms a step (CUDA events, {reps} after a warm-up), "
            f"MFU {mfu:.4f} of 989 TF/s; counted dot FLOPs / model_flops {rec['dot_flops']:.4e}"
            f"{' (member 0)' if n > 1 else ''} / {mf:.4e} = {rec['dot_flops'] / mf:.4f}")
    print(line, flush=True)
    del cell
    _free_device(torch)
    return rec


def _xlstm_split(torch, device_name):
    """xlstm-350m at full width split two ways over ``[cuda:0, cuda:0]``
    against the unsplit run (slice 7c on the card). In float32: the prefill
    logits, greedy grouped serving and a cached-loss step within the
    ``XLSTM_FP32_*`` bars: the checks that can catch a fault of the split.
    In bf16, where an ulp of a partial sum grows through the exponential
    gating, the split's and the unsplit run's prefill logits are printed
    beside their distances from the float32 run's, with no bar: at random
    full-width weights both lie about 0.3 of the largest logit from it, so
    a bar there would hold nothing. Member bytes == ``per_device_bytes``
    in both dtypes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import generate_grouped, generate_loop
    from repro_torch.launch.serve import demo_pool
    from repro_torch.models import lm as LM
    from repro_torch.models import tp as TP
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.runtime import sharding as SH

    dev = torch.device("cuda", 0)
    group = [dev, dev]
    cfg16 = get_config("xlstm-350m")
    cfg = dataclasses.replace(cfg16, dtype="float32")
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    gen = torch.Generator(device=dev).manual_seed(12)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    pool = demo_pool(cfg, TENANTS, RANK, None, dev)
    who = [None] + [f"tenant-{i % TENANTS}" for i in range(1, BATCH)]
    idx = pool.lookup(who)
    tokens = torch.randint(0, cfg.vocab_size, (2, PROMPT), generator=gen, device=dev)
    labels = torch.randint(0, cfg.vocab_size, (2, PROMPT), generator=gen, device=dev)
    adapters = {"A": torch.randn((cfg.n_layers, cfg.d_model, RANK), generator=gen, device=dev) / cfg.d_model**0.5,
                "B": torch.randn((cfg.n_layers, RANK, cfg.d_model), generator=gen, device=dev) * 0.01}
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    def prefill(p, c):
        return LM.serve_prefill(p, c, prompts, LM.init_serve_caches(c, BATCH, PROMPT, device=dev, params=p))[0]

    def member_bytes(p, c, gp):
        mesh = SH.group_mesh(group)
        shapes = LM.param_shapes(c)
        want = SH.per_device_bytes(shapes, SH.param_specs(shapes, mesh), mesh)
        got = [sum(t.numel() * t.element_size() for t in SH._leaves(m)) for m in gp.members]
        check(all(b == want for b in got), f"xlstm split {c.dtype}: member bytes {got} != per_device_bytes {want}")
        return got[0]

    with torch.no_grad():
        want_logits = timed("prefill 1-way fp32", lambda: prefill(params, cfg))
        want_samples = []
        with _sampled(torch, want_samples):
            want_toks = timed("serve 1-way fp32 (eager loop)", lambda: generate_loop(
                params, cfg, prompts, max_new=NEW, pools=pool.pools(), idx=idx, use_kernel=False, device=dev))
        out = LM.lm_forward(params, cfg, tokens, mode="train", collect_acts=True)
        acts, y_base = out["acts"], out["y_base"]
        del out
    want_loss = timed("loss 1-way fp32", lambda: _skip_loss(torch, params, cfg, acts, y_base, labels, adapters))
    gp = TP.group_params(params, group)
    bytes32 = member_bytes(params, cfg, gp)
    with torch.no_grad():
        caches = LM.init_serve_caches(cfg, BATCH, PROMPT, device=dev, params=gp)
        check(isinstance(caches[0]["c"], TP.HeadSplit) and isinstance(caches[0]["conv"], TP.HeadSplit),
              "xlstm split: the mLSTM states are not split over the members")
        got_logits = timed("prefill split fp32", lambda: LM.serve_prefill(gp, cfg, prompts, caches)[0])
        got_samples = []
        with _sampled(torch, got_samples):
            got_toks = timed("serve split fp32", lambda: generate_grouped(
                gp, cfg, prompts, pool.pools(), idx, max_new=NEW, use_kernel=False, device=dev))
    logit_err = _rel_max(torch, got_logits, want_logits)
    check(logit_err <= XLSTM_FP32_LOGIT_BAR, f"xlstm split fp32 prefill logits: {logit_err:.3e} > "
          f"{XLSTM_FP32_LOGIT_BAR}")
    flips = _split_flips(torch, want_toks.cpu(), got_toks.cpu(), want_samples, got_samples)
    del want_samples, got_samples, caches
    got_loss = timed("loss split fp32", lambda: _skip_loss(torch, gp, cfg, acts, y_base, labels, adapters))
    loss_err = abs(got_loss[0].item() - want_loss[0].item()) / abs(want_loss[0].item())
    grad_err = max(_rel_max(torch, g, w) for g, w in zip(got_loss[1:], want_loss[1:]))
    check(loss_err <= XLSTM_FP32_LOSS_BAR and grad_err <= XLSTM_FP32_GRAD_BAR,
          f"xlstm split fp32 cached-loss step: loss {loss_err:.3e} (bar {XLSTM_FP32_LOSS_BAR}), gradients "
          f"{grad_err:.3e} (bar {XLSTM_FP32_GRAD_BAR})")
    del gp, acts, y_base
    # bf16, the deployed dtype: the split's distance from the float32 logits
    # against the unsplit bf16 run's
    p16 = tree_map(lambda t, like: t.to(like.dtype), params, LM.param_shapes(cfg16))
    del params
    with torch.no_grad():
        l16 = prefill(p16, cfg16)
        gp16 = TP.group_params(p16, group)
        bytes16 = member_bytes(p16, cfg16, gp16)
        s16 = prefill(gp16, cfg16)
    noise, split16, diff16 = (_rel_max(torch, l16, want_logits), _rel_max(torch, s16, want_logits),
                              _rel_max(torch, s16, l16))
    del p16, gp16
    _free_device(torch)
    return (f"dryrun 7c xlstm-350m full width split 2 ways over [cuda:0, cuda:0] on {device_name}: member bytes "
            f"{bytes32} (fp32) / {bytes16} (bf16) each == per_device_bytes; fp32: prefill logits ({BATCH}x{PROMPT}) "
            f"max diff / max |logit| {logit_err:.3e} (bar {XLSTM_FP32_LOGIT_BAR}), grouped serve ({NEW} new, greedy, "
            f"float pool, use_kernel=False) tokens equal{' except near ties: ' + '; '.join(flips) if flips else ''}, "
            f"cached-loss step loss rel diff {loss_err:.3e} (bar {XLSTM_FP32_LOSS_BAR}), gradients {grad_err:.3e} "
            f"(bar {XLSTM_FP32_GRAD_BAR}); bf16 (printed, no bar): split vs unsplit logits {diff16:.3e}, split vs "
            f"fp32 {split16:.3e}, unsplit vs fp32 {noise:.3e}; host s "
            + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))


def _quantized_check(torch, device_name):
    """``optim.quantized`` on the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as B
    from repro_torch.models import lm as LM
    from repro_torch.optim import optimizers as O
    from repro_torch.optim import quantized as Q

    cfg = get_config(ARCH)
    gen = torch.Generator().manual_seed(13)
    block = B.init_block(gen, "attn", 0, cfg, LM.model_dtype(cfg))          # on the CPU, seeded
    cpu = O.tree_map(lambda p: p.float(), block)
    card = O.tree_map(lambda p: p.cuda(), cpu)
    grads = [O.tree_map(lambda p: torch.randn(p.shape, generator=gen) * 1e-3, cpu) for _ in range(3)]
    opts = Q.int8_adamw(1e-3, weight_decay=0.1)
    states = [opts.init(cpu), opts.init(card)]
    worst, steps_apart, n_codes = 0.0, 0, 0
    for g in grads:
        u_cpu, states[0] = opts.update(g, states[0], cpu)
        u_gpu, states[1] = opts.update(O.tree_map(lambda t: t.cuda(), g), states[1], card)
        for a, b in zip(O.tree_leaves(u_cpu), O.tree_leaves(u_gpu)):
            worst = max(worst, ((b.cpu() - a).abs().max() / a.abs().max().clamp(min=1e-30)).item())
        for mom in ("mu", "nu"):
            for a, b in zip(O.tree_leaves(getattr(states[0], mom)), O.tree_leaves(getattr(states[1], mom))):
                if a.dtype == torch.int8:
                    d = (b.cpu().int() - a.int()).abs()
                    check(int(d.max()) <= 1, f"int8_adamw: {mom} codes {int(d.max())} steps apart on the card")
                    steps_apart += int((d > 0).sum())
                    n_codes += a.numel()
        cpu, card = O.apply_updates(cpu, u_cpu), O.apply_updates(card, u_gpu)
    check(worst <= QUANT_UPDATE_BAR, f"int8_adamw: updates {worst:.3e} apart (bar {QUANT_UPDATE_BAR})")
    q8 = sum(t.numel() * t.element_size() for t in O.tree_leaves(states[1].mu))
    f32 = sum(t.numel() * 4 for t in O.tree_leaves(cpu))
    g = O.tree_map(lambda p: torch.randn(p.shape, generator=gen), cpu)
    c_cpu, c_gpu = Q.compress_grads(g), Q.compress_grads(O.tree_map(lambda t: t.cuda(), g))
    same = all(torch.equal(a, b.cpu()) for a, b in zip(O.tree_leaves([c_cpu.q, c_cpu.scale]),
                                                        O.tree_leaves([c_gpu.q, c_gpu.scale])))
    back = all(torch.equal(a, b.cpu()) for a, b in zip(O.tree_leaves(Q.decompress_grads(c_cpu, g)), O.tree_leaves(
        Q.decompress_grads(c_gpu, O.tree_map(lambda t: t.cuda(), g)))))
    w = g["attn"]["wq"]
    vals, ix = Q.topk_sparsify(w, 0.01)
    res_cpu = Q.error_feedback_residual(w, vals, ix)
    res_gpu = Q.error_feedback_residual(w.cuda(), vals.cuda(), ix.cuda())
    check(same and back and torch.equal(res_cpu, res_gpu.cpu()),
          f"compress_grads bitwise {same}, decompress {back}, error-feedback residual "
          f"{torch.equal(res_cpu, res_gpu.cpu())}")
    return (f"dryrun int8_adamw {ARCH} block 0 ({sum(t.numel() for t in O.tree_leaves(cpu))} parameters), 3 steps "
            f"on {device_name} against the CPU: updates max diff / max {worst:.3e} (bar {QUANT_UPDATE_BAR}); "
            f"{steps_apart} of {n_codes} moment codes (3 steps, mu and nu) one step apart (none further); moments {q8} B int8 + scales "
            f"against {f32} B fp32: {f32 / q8:.3f}x smaller; compress_grads / decompress_grads / "
            f"error_feedback_residual bitwise the CPU's")


def dryrun_phase(torch, device_name):
    """The dry-run (phase 16 of the module docstring)."""
    import concurrent.futures
    import multiprocessing

    t_phase = time.perf_counter()
    _reset_launches()
    for kind, bs, groups in DRY_CARD:
        for n in groups:
            rec = _dry_card_cell(torch, kind, bs, n, device_name)
            if kind == "train":
                REMAT_SEEN["card", n] = rec
    t_card = time.perf_counter() - t_phase
    pool = concurrent.futures.ProcessPoolExecutor(max_workers=DRY_WORKERS,
                                                  mp_context=multiprocessing.get_context("spawn"))
    try:
        futs = [pool.submit(_dry_meta, str(SRC), *c) for c in DRY_META]
        print(_xlstm_split(torch, device_name), flush=True)
        print(_quantized_check(torch, device_name), flush=True)
        meta = [f.result(timeout=600) for f in futs]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    check(not any(_launches().values()), f"dryrun: hand-written kernels launched {_launches()}")
    for rec in meta:
        check("error" not in rec and rec["dot_flops"] > 0, f"dryrun meta cell {rec}")
        print("dryrun meta " + json.dumps(rec, sort_keys=True))
    print(f"dryrun phase: {time.perf_counter() - t_phase:.1f} s (card cells {t_card:.1f} s; {len(DRY_META)} meta "
          f"cells on the 16x16 mesh in {DRY_WORKERS} worker processes, counts not timings); no hand-written kernel "
          f"launched")


# ---------------------------------------------------------------------------
# Phase 17: rematerialisation in training, and context parallelism
# ---------------------------------------------------------------------------

#: what the earlier phases measured with each period rematerialised:
#: {"train full": (populate s, losses), "trainer": (losses, step ms, peak
#: GiB), ("card", n): the dry-run train cell's record}
REMAT_SEEN: dict = {}
CP_ARCH = "paligemma-3b"
CP_DECODE = (32, 2048)
CP_LOGIT_BAR = 1e-5


@contextlib.contextmanager
def _unrematerialised():
    """Train mode without rematerialisation, as before it was ported:
    ``remat.region`` a plain call."""
    from repro_torch.models import remat as RM

    real = RM.region
    RM.region = lambda fn, *args: fn(*args)
    try:
        yield
    finally:
        RM.region = real


def _remat_part(torch, device_name):
    """Each rematerialised measurement of the earlier phases against the
    same one un-rematerialised (the parent), in this process, in turns:
    the dry-run's train 8 x 512 card cells on 1 x 1 and 1 x 2 (phase 16's
    remat run, then parent, then remat again: meta == card counts, peak /
    counted within ``DRY_PEAK_BAND``, step ms, peak), the loss and
    gradients of that step alone (no optimizer update: what remat keeps
    less of), the full-backprop trainer (4 steps, losses bitwise) and a
    populate epoch of the train phase's launcher (losses bitwise)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch import finetune as FT
    from repro_torch.launch import train as TT
    from repro_torch.models import lm as LM
    from repro_torch.optim.optimizers import tree_leaves

    lines = []
    for n in (1, 2):
        first = REMAT_SEEN["card", n]
        with _unrematerialised():
            old = _dry_card_cell(torch, "train", (8, 512), n, device_name, tag="remat parent: ")
        new = _dry_card_cell(torch, "train", (8, 512), n, device_name, tag="remat again: ")
        check(new["dot_flops"] == first["dot_flops"], "remat: the dry-run train cell's counts moved between runs")
        lines.append(f"remat dryrun card {ARCH} train 8x512 1x{n} on {device_name}: remat / parent / remat: step "
                     f"{first['card_ms']:.1f} / {old['card_ms']:.1f} / {new['card_ms']:.1f} ms, peak "
                     f"(max_memory_allocated) {new['card_peak'] / 2**30:.3f} / {old['card_peak'] / 2**30:.3f} GiB, "
                     f"peak / counted {new['card_ratio']:.3f} / {old['card_ratio']:.3f}, counted temp "
                     f"{new['temp_size_in_bytes'] / 2**30:.3f} / {old['temp_size_in_bytes'] / 2**30:.3f} GiB, "
                     f"dot FLOPs {new['dot_flops']:.4e} / {old['dot_flops']:.4e} "
                     f"(x{new['dot_flops'] / old['dot_flops']:.4f}), collective bytes "
                     f"{new['collective_bytes']:.4e} / {old['collective_bytes']:.4e}")
    # the loss and gradients alone: the activations' peak, which the
    # optimizer update's fp32 moments hide in the cells above
    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    grad_runs = {}
    for name in ("parent", "remat", "remat", "parent"):
        with _unrematerialised() if name == "parent" else contextlib.nullcontext():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            grads = torch.autograd.grad(LM.train_loss_fn(params, cfg, batch), leaves)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            if name in grad_runs:
                check(all(torch.equal(a, b) for a, b in zip(grads, grad_runs[name][2])),
                      f"remat: the {name} gradients moved between runs")
            grad_runs.setdefault(name, [[], [], grads])
            grad_runs[name][0].append(ms)
            grad_runs[name][1].append(peak)
            del grads
    check(all(torch.equal(a, b) for a, b in zip(grad_runs["remat"][2], grad_runs["parent"][2])),
          "remat: the loss's gradients differ from the parent's")
    grad_runs["remat"][2] = grad_runs["parent"][2] = None
    del params, leaves
    torch.cuda.empty_cache()
    (r_ms, r_pk, _), (p_ms, p_pk, _) = grad_runs["remat"], grad_runs["parent"]
    lines.append(f"remat loss + gradients {ARCH} full width 8 x 512 (no optimizer update) on {device_name}: gradients "
                 f"bitwise the parent's; peak over what the call started with {r_pk[0]:.3f} / {p_pk[0]:.3f} GiB remat / "
                 f"parent ({r_pk[0] / p_pk[0]:.3f}); host ms (synchronised) parent, remat, remat, parent: "
                 f"{p_ms[0]:.1f}, {r_ms[0]:.1f}, {r_ms[1]:.1f}, {p_ms[1]:.1f}")
    losses = REMAT_SEEN["trainer"][0]
    argv = ["--arch", ARCH, "--full", "--steps", "4", "--batch", "8", "--seq", "128", "--device", "cuda",
            "--ckpt-every", "1000", "--log-every", "1"]
    trainer = {}
    for name in ("parent", "remat"):
        with _unrematerialised() if name == "parent" else contextlib.nullcontext():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out = TT.main([*argv, "--ckpt-dir", str(TOOLING_DIR / f"remat_{name}")])
            steps = sorted(out["step_s"][1:])
            trainer[name] = (1e3 * steps[len(steps) // 2], torch.cuda.max_memory_allocated() / 2**30)
            check(out["losses"] == losses, f"remat trainer ({name}): losses {out['losses']} against the tooling "
                  f"phase's {losses}")
            del out
        shutil.rmtree(TOOLING_DIR / f"remat_{name}", ignore_errors=True)
    torch.cuda.empty_cache()
    lines.append(f"remat trainer {ARCH} full width --full, 4 steps of 8 x 128 on {device_name}: losses bitwise "
                 f"the parent's ({' / '.join(f'{v:.4f}' for v in losses)}); remat / parent: "
                 f"{trainer['remat'][0]:.1f} / {trainer['parent'][0]:.1f} ms a step (host clock, median of steps "
                 f"1-3), peak {trainer['remat'][1]:.2f} / {trainer['parent'][1]:.2f} GiB")
    # the populate epoch, remat then parent, each from a fresh launcher run
    pop_s, pop_losses = {}, {}
    for name in ("remat", "parent"):
        with _unrematerialised() if name == "parent" else contextlib.nullcontext():
            run = FT.prepare(FT.parse_args([*TRAIN_ARGS, "--mode", "full"]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pop_losses[name] = FT.run_epoch(run, 0).cpu()
            torch.cuda.synchronize()
            pop_s[name] = time.perf_counter() - t0
        del run
        torch.cuda.empty_cache()
    check(torch.equal(pop_losses["remat"], pop_losses["parent"])
          and torch.equal(pop_losses["remat"], REMAT_SEEN["train full"][1]),
          f"remat populate: losses {pop_losses['remat'].tolist()} against the parent's "
          f"{pop_losses['parent'].tolist()}")
    lines.append(f"remat populate {ARCH} full width mode=full ({TRAIN_STEPS} steps of 8 x 128) on {device_name}: "
                 f"losses bitwise the parent's and the train phase's; remat / parent {pop_s['remat']:.3f} / "
                 f"{pop_s['parent']:.3f} s an epoch (host clock; the train phase's first epoch, warm-up included: "
                 f"{REMAT_SEEN['train full'][0]:.3f} s)")
    return lines


def _cp_member_bytes(torch, cfg, n, want_positions):
    """``inspect`` of the paligemma decode cell: each member's K/V part
    holds ``want_positions`` positions, and its cache and parameter bytes
    equal ``per_device_bytes`` of the spec trees."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models import lm as LM
    from repro_torch.models import tp as TP
    from repro_torch.runtime import sharding as SH

    out = {}

    def inspect(cell):
        caches, gp = cell.args[3], cell.args[0]
        mesh = SH.make_mesh((1, n), ("data", "model"), devices=["meta"] * n)
        shapes = LM.init_serve_caches(cfg, CP_DECODE[0], CP_DECODE[1], device="meta")
        specs = ST.cache_specs(shapes, mesh, ST.rules_for(ShapeCell("d", "decode", CP_DECODE[1], CP_DECODE[0]),
                                                          mesh))
        want = SH.per_device_bytes(shapes, specs, mesh)
        kv = [c[k] for c in caches for k in ("k", "v")]
        check(all(TP.seq_split(t) and [p.shape[-3] for p in t.parts] == [want_positions] * n for t in kv),
              f"context parallel: the caches are not split into {n} x {want_positions} positions")
        got = [sum(t.parts[i].numel() * t.parts[i].element_size() for t in kv) for i in range(n)]
        check(got == [want] * n, f"context parallel: member cache bytes {got} != per_device_bytes {want}")
        pshapes = LM.param_shapes(cfg)
        pwant = SH.per_device_bytes(pshapes, SH.param_specs(pshapes, mesh), mesh)
        pgot = [sum(t.numel() * t.element_size() for t in SH._leaves(m)) for m in gp.members]
        check(pgot == [pwant] * n, f"context parallel: member parameter bytes {pgot} != {pwant}")
        out.update(cache=got[0], params=pgot[0])

    return inspect, out


def _cp_fp32_steps(torch, dev, n):
    """Reduced float32 paligemma split ``n`` ways over ``[dev] * n``, its
    caches split by sequence, against the same group with its caches whole
    on the home device: each decode step from the same caches, the
    logits' largest difference over their largest value. The caches are
    float32 too (the port's are bf16), so that no key rounds to bf16 the
    other way after an ulp of a hidden state (with bf16 caches the card
    read 4.3e-5 on an H100)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import lm as LM
    from repro_torch.models import tp as TP

    cfg = reduce_config(get_config(CP_ARCH))
    params = LM.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    _live_norms(params, cfg)
    gp = TP.group_params(params, [dev] * n)
    gen = torch.Generator(device=dev).manual_seed(2)
    seq, prompt = 64, 20
    tokens = torch.randint(0, cfg.vocab_size, (4, prompt), generator=gen, device=dev)
    whole = LM.init_serve_caches(cfg, 4, seq, device=dev)
    split = LM.init_serve_caches(cfg, 4, seq, device=dev, params=gp)
    for a, b in zip(whole, split):
        for k in ("k", "v"):
            a[k] = a[k].float()
            b[k] = TP.HeadSplit([p.float() for p in b[k].parts], b[k].ranges, b[k].axis)
    worst = 0.0
    with torch.no_grad():
        l1, _ = LM.serve_prefill(gp, cfg, tokens, whole)
        l2, _ = LM.serve_prefill(gp, cfg, tokens, split)
        worst = _rel_max(torch, l2, l1)
        for step, pos in enumerate([prompt, torch.tensor(prompt + 1, device=dev), 40,
                                    torch.tensor([41, 50, 60, 63], device=dev)]):
            for a, b in zip(whole, split):
                for k in ("k", "v"):
                    b[k][:, :] = a[k]
            tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen, device=dev)
            l1, _ = LM.serve_decode(gp, cfg, tok, pos, whole)
            l2, _ = LM.serve_decode(gp, cfg, tok, pos, split)
            check(bool(torch.isfinite(l2).all()), f"context parallel fp32 step {step}: non-finite logits")
            worst = max(worst, _rel_max(torch, l2, l1))
    check(worst <= CP_LOGIT_BAR, f"context parallel fp32: logits {worst:.3e} > {CP_LOGIT_BAR}")
    return worst


def _cp_part(torch, device_name):
    """paligemma-3b (one KV head) at full width split two ways over
    ``[cuda:0, cuda:0]``, its K/V caches split by sequence: the dry-run's
    decode 32 x 2048 card cell on the 1 x 2 group (meta == card, the
    arguments the allocator's, each member's part 1024 positions, member
    bytes == ``per_device_bytes``); greedy grouped serving from a 4 x 128
    prefill, 32 new tokens, against the unsplit run (near ties explained,
    ``_split_flips``); a reduced float32 copy within ``CP_LOGIT_BAR``."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import generate_grouped, generate_loop
    from repro_torch.launch.serve import demo_pool
    from repro_torch.models import lm as LM
    from repro_torch.models import tp as TP

    dev = torch.device("cuda", 0)
    cfg = get_config(CP_ARCH)
    lines, secs = [], {}
    inspect, seen = _cp_member_bytes(torch, cfg, 2, CP_DECODE[1] // 2)
    rec = _dry_card_cell(torch, "decode", CP_DECODE, 2, device_name, arch=CP_ARCH, tag="context parallel: ",
                         inspect=inspect)
    lines.append(f"context parallel {CP_ARCH} decode {CP_DECODE[0]}x{CP_DECODE[1]} 1x2 on {device_name}: each "
                 f"member's K/V part {CP_DECODE[1] // 2} positions, member cache bytes {seen['cache']} == "
                 f"per_device_bytes, member parameter bytes {seen['params']}; {rec['card_ms']:.2f} ms a step; "
                 f"collectives {json.dumps(rec['collectives_per_op'], sort_keys=True)}")

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    params = LM.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    gen = torch.Generator(device=dev).manual_seed(12)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    pool = demo_pool(cfg, TENANTS, RANK, None, dev)
    who = [None] + [f"tenant-{i % TENANTS}" for i in range(1, BATCH)]
    idx = pool.lookup(who)
    with torch.no_grad():
        want_samples = []
        with _sampled(torch, want_samples):
            want = timed("serve unsplit (eager loop)", lambda: generate_loop(
                params, cfg, prompts, max_new=NEW, pools=pool.pools(), idx=idx, use_kernel=False, device=dev))
        gp = TP.group_params(params, [dev, dev])
        del params
        caches = LM.init_serve_caches(cfg, BATCH, PROMPT + NEW, device=dev, params=gp)
        check(TP.seq_split(caches[0]["k"]), "context parallel: the serve caches are not split by sequence")
        del caches
        got_samples = []
        with _sampled(torch, got_samples):
            got = timed("serve split", lambda: generate_grouped(gp, cfg, prompts, pool.pools(), idx, max_new=NEW,
                                                               use_kernel=False, device=dev))
    flips = _split_flips(torch, want.cpu(), got.cpu(), want_samples, got_samples)
    del gp, want_samples, got_samples
    _free_device(torch)
    lines.append(f"context parallel {CP_ARCH} full width (bf16, one KV head) grouped serve {BATCH}x{PROMPT} + {NEW} "
                 f"new (greedy, float pool, use_kernel=False) split 2 ways over [cuda:0, cuda:0] on {device_name}: "
                 f"tokens equal to the unsplit run's{' except near ties: ' + '; '.join(flips) if flips else ''}")
    worst = timed("reduced fp32 steps", lambda: _cp_fp32_steps(torch, dev, 2))
    lines.append(f"context parallel fp32 reduced {CP_ARCH} split 2 ways on {device_name}: prefill and 4 decode "
                 f"steps (int, 0-d, per-row positions) from the same caches, logits max diff / max |logit| "
                 f"{worst:.3e} (bar {CP_LOGIT_BAR}); host s " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    return lines


def remat_cp_phase(torch, device_name):
    """Phase 17 of the module docstring."""
    t_phase = time.perf_counter()
    _reset_launches()
    for part in (_remat_part, _cp_part):
        for line in part(torch, device_name):
            print(line, flush=True)
    check(not any(_launches().values()), f"remat / context parallel: hand-written kernels launched {_launches()}")
    print(f"remat / context parallel phase: {time.perf_counter() - t_phase:.1f} s; no hand-written kernel launched")


def _chunk_states(torch, device_name):
    """``launch.train``'s scan chunk with two trainer states of equal shapes
    (reduced stablelm-1.6b, two seeds) alternated through one
    ``make_scan_chunk`` over one staged set: each state's losses and final
    parameters and moments bitwise its own eager ``make_step`` trajectory,
    the tokens and labels never written, one graph entry a state."""
    import numpy as np

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.cuda_graph import GraphCache
    from repro_torch.launch import train as TT
    from repro_torch.models.lm import init_lm
    from repro_torch.optim.optimizers import adamw

    cfg = reduce_config(get_config(ARCH))
    opt = adamw(3e-4, weight_decay=0.1)
    g = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (32, 32), generator=g, device="cuda", dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (32, 32), generator=g, device="cuda", dtype=torch.int32)
    data = (tokens.clone(), labels.clone())
    mats = [torch.as_tensor(np.random.default_rng(s).integers(0, 32, size=(2, 4)), device="cuda") for s in range(3)]
    step = TT.make_step(cfg, opt)
    states, want = [], []
    for seed in (0, 1):
        p = init_lm(torch.Generator(device="cuda").manual_seed(seed), cfg)
        states.append((p, opt.init(p)))
        st, ls = opt.init(p), []
        for m in mats:
            for ids in m:
                p, st, loss = step(p, st, {"tokens": tokens[ids], "labels": labels[ids]})
                ls.append(loss)
        want.append(_state_leaves(p, st) + [torch.stack(ls)])
    graphs = GraphCache(capacity=4)
    run = TT.make_scan_chunk(cfg, opt, graphs=graphs)
    losses = [[], []]
    for m in mats:
        for i in (0, 1):
            p, st, ls = run(*states[i], tokens, labels, m)
            states[i] = (p, st)
            losses[i].append(ls)
    for i in (0, 1):
        check(_same(torch, _state_leaves(*states[i]) + [torch.cat(losses[i])], want[i]),
              f"train chunk: state {i} left its own eager trajectory when alternated with another of equal shapes")
    check(torch.equal(tokens, data[0]) and torch.equal(labels, data[1]), "train chunk: tokens or labels written")
    check(graphs.stats["misses"] == 2 and graphs.stats["hits"] == 4, f"train chunk: graph stats {graphs.stats}")
    graphs.clear()
    return (f"train chunk keying on {device_name}: two reduced {ARCH} states of equal shapes alternated through "
            f"one make_scan_chunk, 3 chunks of 2 steps each: each bitwise its own eager trajectory (losses, "
            f"params, moments), tokens and labels unwritten, one graph entry a state")


def twins_phase(torch, device_name):
    """The twins of the reference's two LM examples on the card, and the
    trainer chunk's keying (``_chunk_states``):
      - ``repro_torch.examples.finetune_lm`` at its ~100M config (14 layers,
        d 576, vocab 50304, float32; 64 samples of 256 tokens, batch 8, rank
        8, 4 epochs): losses finite and falling, every epoch graph replays
        (2 captures, 32 step replays), the cached-epoch speedup;
      - ``repro_torch.examples.serve_adapted`` (reduced gemma2-9b, 3 tenants
        and a base row, 24-token prompts, 12 new): every row equal to
        single-tenant serving (4/4).
    Both run the plain versions, as the reference's examples do: no
    hand-written kernel launches."""
    import numpy as np

    from repro_torch.examples import finetune_lm as FLM
    from repro_torch.examples import serve_adapted as SA

    t_phase = time.perf_counter()
    _free_device(torch)
    _reset_launches()
    out = FLM.main(["--epochs", "4", "--device", "cuda"])
    steps = 64 // 8
    g = out["graphs"]
    check(g["captures"] == 2 and g["replays"] == 4 * steps - 2, f"finetune_lm twin: graph stats {dict(g)}")
    means = [float(v.mean()) for v in out["losses"]]
    check(all(np.isfinite(v).all() for v in out["losses"]) and means[-1] < means[0],
          f"finetune_lm twin: mean losses {means}")
    t = out["times"]
    print(f"twin finetune_lm (~100M, 14L d=576 vocab 50304 float32) on {device_name}: 4 epochs x {steps} steps of "
          f"8 x 256: populate {t[0]:.3f} s, cached {' / '.join(f'{v:.3f}' for v in t[1:])} s, cached-epoch speedup "
          f"{t[0] / (sum(t[1:]) / len(t[1:])):.1f}x (first cached epoch with its capture; without it "
          f"{t[0] / (sum(t[2:]) / len(t[2:])):.1f}x); graphs: {g['captures']} captured in {g['capture_s']:.3f} s "
          f"(+{g['first_step_s']:.3f} s eager first steps), {g['replays']} step replays; mean losses "
          f"{' / '.join(f'{v:.4f}' for v in means)}")
    served = SA.main(["--device", "cuda"])
    check(served["agree"] == SA.BATCH, f"serve_adapted twin: {served['agree']}/{SA.BATCH} rows match solo serving")
    print(f"twin serve_adapted (reduced gemma2-9b, use_kernel=False) on {device_name}: rows matching single-tenant "
          f"serving {served['agree']}/{SA.BATCH}, adapter-vs-base divergence {served['diverged']:.2f}")
    check(not any(_launches().values()), f"twins: hand-written kernels launched {_launches()}")
    print(_chunk_states(torch, device_name))
    _reset_launches()
    print(f"twins phase: {time.perf_counter() - t_phase:.1f} s; no hand-written kernel launched")


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
    t_run = time.perf_counter()
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
    shard_launches = shard_phase(torch, smi, kept)
    del kept
    torch.cuda.empty_cache()
    small_fleet_check(torch)
    small_session_check(torch)
    small_shard_check(torch)
    cli_drill_check(torch)
    sched_launches = scheduler_phase(torch, smi)
    small_scheduler_check(torch)
    paper_phase(torch, smi)
    twins_phase(torch, smi)
    tooling_phase(torch, smi)
    families_launches = families_phase(torch, smi)
    model_axis_phase(torch, smi)
    dryrun_phase(torch, smi)
    remat_cp_phase(torch, smi)
    # each kernel's launches over every main path that runs it
    for counts in (fleet_launches, serve_launches, session_launches, shard_launches, sched_launches,
                   families_launches):
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
    print(f"eager comparisons beside the epoch graphs (not in the kernels line): {EAGER_LAUNCHES} kernel launches")
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s, the builds included")
    check(all(r["launches"] is not None for r in results.values()), "a kernel has no launch count")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
