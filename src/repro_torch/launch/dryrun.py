"""The dry-run of every (arch x shape x mesh) cell: the counterpart of
``repro.launch.dryrun``.

The reference lowers and compiles each cell's step for the 16x16 and
2x16x16 meshes on forced host devices and reads XLA's memory and cost
analyses and its HLO. The port has no compiler to ask: it *executes* one
data shard's program on the ``meta`` device, which computes nothing and
holds no memory, under ``launch.op_analysis.OpCounter``. ``run_cell``
builds the cell (``launch.steps.build_cell``) on
``launch.mesh.make_production_mesh(devices="meta")``, takes the first data
shard's slice of the batch (``batch_specs``), splits the backbone over that
shard's model group (``tp.group_params``: 16 members; under 'fsdp' / 'ep'
the batch covers the grid, so the group is one device holding the gathered
weights), and runs the step once. The record has the reference's fields,
per device (the home member's: the busiest):

  - ``flops``, ``dot_flops``, ``bytes_accessed``: the counter's;
  - ``collective_bytes`` / ``collective_count`` / ``collectives_per_op``:
    the model group's collectives as ``models.tp`` makes them, plus the
    data axis's (``_data_collectives``): under 'tp', an all-gather of each
    leaf ``maybe_fsdp_specs`` split over 'data' and the gradient
    all-reduce of a training step over the data shards; under 'fsdp' /
    'ep', an all-gather of every split weight and a reduce-scatter of its
    gradient. Each is counted once a step;
  - ``argument_size_in_bytes``: exact, from the spec trees
    (``sharding.spec_shards``); ``output_size_in_bytes``: the step's
    outputs that are not its arguments (the serve caches are updated in
    place); ``temp_size_in_bytes``: the counter's peak of new storages less
    the outputs; ``memory_analysis`` says the same in a line;
  - ``build_s`` / ``run_s`` where the reference has ``lower_s`` /
    ``compile_s``, and ``per_member``: each member's counts.

These are counts, not timings. Where the reference's ``cache_specs`` put a
K/V cache's sequence on 'data' (``long_500k``: one sequence, fewer rows
than data shards, ``steps.rules_for``), the first data shard's program
holds its 1/D of the positions, [0, S / D), and decodes at its last one,
so that it attends every position it holds; over a model group whose KV
heads do not divide it, ``tp.init_caches`` splits those positions again
(1/(D·M) a device). The merge of the D shards' partial outputs (an
all-gather of each attention layer's partials and log-sum-exps) is counted
once a step with the data axis's other collectives. ``--unroll`` is
accepted and changes nothing (the reference's numbers are the same either
way). A recurrent cell's time loops are
counted from two runs cut to 2 and 3 steps (``op_analysis.count(
sample_loops=True)``). Several cells run in ``--jobs`` worker
processes, one intra-op thread each.

Usage (any host, no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
      --shape train_4k --step train --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out records.json [--jobs N]
  PYTHONPATH=src python -m repro_torch.launch.roofline --in records.json --md
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Optional

import torch

from repro_torch.core import lm_skiplora as SL
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import steps as ST
from repro_torch.launch.shapes import SHAPES, ShapeCell
from repro_torch.models import lm as LM
from repro_torch.models import tp as TP
from repro_torch.optim.optimizers import OptState, tree_leaves
from repro_torch.runtime import sharding as SH

#: the first argument of each step kind that holds a batch dimension
_BATCH_ARG = {"train": 2, "finetune_populate": 3, "finetune_cached": 4, "prefill": 1, "decode": 1,
              "decode_adapted": 2}


@dataclasses.dataclass
class Cell:
    """One data shard's program, ready to run: ``fn(*args)``."""

    fn: Any
    args: tuple
    cfg: Any
    shape: ShapeCell
    step: str
    strategy: str
    mesh: SH.Mesh
    group: list
    batch_shards: int
    seq_shards: int
    arg_specs: tuple
    example_args: tuple
    build_s: float


def _mesh_name(mesh: SH.Mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _arg_bytes(tree, specs, mesh) -> float:
    """Bytes a device holds of ``tree`` under ``specs`` (per_device_bytes
    over the example args' trees: OptState fields, per-layer cache lists)."""
    if tree is None:
        return 0.0
    if isinstance(tree, OptState):
        return sum(_arg_bytes(getattr(tree, f), getattr(specs, f), mesh) for f in ("step", "mu", "nu"))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size() / SH.spec_shards(tuple(tree.shape), specs, mesh)
    if isinstance(tree, dict):
        return sum(_arg_bytes(v, specs[k], mesh) for k, v in tree.items())
    return sum(_arg_bytes(v, s, mesh) for v, s in zip(tree, specs))


def _batch_shards(specs, step: str, mesh) -> int:
    """How many data shards split the batch: dim 0 of the first batch
    argument's spec."""
    spec = specs[_BATCH_ARG[step]]
    leaf = next(iter(spec.values())) if isinstance(spec, dict) else spec
    return SH.spec_shards((), leaf[:1], mesh) if leaf else 1


#: the argument of the serve step kinds that holds the caches
_CACHE_ARG = {"prefill": 2, "decode": 3, "decode_adapted": 4}


def _seq_shards(specs, step: str, mesh) -> int:
    """How many data shards split the K/V caches' sequence: the data axes
    in the sequence entry of the first K/V spec (1 where none does)."""
    if step not in _CACHE_ARG:
        return 1
    layer = next((c for c in specs[_CACHE_ARG[step]] if "k" in c), None)
    part = None if layer is None else layer["k"][1]
    axes = () if part is None else ((part,) if isinstance(part, str) else tuple(part))
    data = tuple(a for a in axes if a != "model")
    return SH._axis_size(mesh, data) if data else 1


def _group(mesh: SH.Mesh, strategy: str, group) -> list:
    """The shard's model group: the mesh's first one (its 'model' axis),
    or one device where the batch covers the model axis ('fsdp' / 'ep')."""
    devices = list(group) if group is not None else SH.session_mesh_layout(mesh)[2][0]
    return devices[:1] if strategy in ("fsdp", "ep") else devices


def _draw_params(cfg, group):
    dev = torch.device(group[0])
    if dev.type == "meta":
        params = LM.param_shapes(cfg)
        return TP.group_params(params, group) if len(group) > 1 else params
    gen = torch.Generator(device=dev).manual_seed(0)
    if len(group) > 1:
        return TP.init_group_params(gen, cfg, group)
    return LM.init_lm(gen, cfg)


def _like(t: torch.Tensor, device, gen, *, rows: Optional[int] = None, high: int = 2) -> torch.Tensor:
    """``t``'s shape and dtype (dim 0 cut to ``rows``) on ``device``: empty
    on meta, else random (ints below ``high``)."""
    shape = (rows,) + tuple(t.shape[1:]) if rows is not None and t.dim() else tuple(t.shape)
    if device.type == "meta":
        return torch.empty(shape, dtype=t.dtype, device=device)
    if not t.dtype.is_floating_point:
        return torch.randint(0, high, shape, generator=gen, device=device, dtype=t.dtype)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(t.dtype)


def prepare_cell(
    arch,
    shape,
    step_kind: str,
    *,
    multi_pod: bool = False,
    skiplora_mode: str = "full",
    strategy: str = "tp",
    mesh: Optional[SH.Mesh] = None,
    group=None,
) -> Cell:
    """Build a cell and its first data shard's inputs on ``group`` (default:
    the mesh's first model group; the production meshes lie on ``meta``).
    ``arch`` / ``shape`` as ``steps.build_cell`` takes them."""
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.time()
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod, devices="meta")
    sl = SL.SkipLoRAConfig(rank=16, mode=skiplora_mode)
    fn, args, in_specs, _ = ST.build_cell(arch, shape, mesh, step_kind, skiplora=sl, strategy=strategy)
    cfg, shape = ST._resolve(arch, shape)
    group = [torch.device(d) for d in _group(mesh, strategy, group)]
    home = group[0]
    shards = _batch_shards(in_specs, step_kind, mesh)
    seq_shards = _seq_shards(in_specs, step_kind, mesh)
    rows = max(1, shape.batch // shards)
    gen = None if home.type == "meta" else torch.Generator(device=home).manual_seed(1)
    params = _draw_params(cfg, group)
    vocab = cfg.vocab_size

    def batch(tree):
        return {k: _like(v, home, gen, rows=rows, high=vocab) for k, v in tree.items()}

    def adapters():
        g = SL.init_adapters(LM._MetaGenerator() if gen is None else gen, cfg, sl)
        g["B"] = g["B"] if gen is None else 0.01 * torch.randn(g["B"].shape, generator=gen, device=home)
        return g

    if step_kind == "train":
        tree, _ = ST.trainable_tree(params)
        local = (params, fn.opt.init(tree), batch(args[2]))
    elif step_kind == "finetune_populate":
        t, s = SL.split_trainable(adapters(), sl)
        local = (params, t, s, batch(args[3]))
    elif step_kind == "finetune_cached":
        t, s = SL.split_trainable(adapters(), sl)
        local = (params, t, s, fn.opt.init(t), batch(args[4]))
    else:
        seq = shape.seq // seq_shards        # the first data shard's positions
        caches = LM.init_serve_caches(cfg, rows, seq, device=home, params=params)
        if step_kind == "prefill":
            prefix = None if args[3] is None else _like(args[3], home, gen, rows=rows)
            local = (params, _like(args[1], home, gen, rows=rows, high=vocab), caches, prefix)
        else:
            token = _like(args[1] if step_kind == "decode" else args[2], home, gen, rows=rows, high=vocab)
            pos = torch.tensor(seq - 1, dtype=torch.int32, device=home)
            local = ((params, token, pos, caches) if step_kind == "decode"
                     else (params, adapters(), token, pos, caches))
    return Cell(fn, local, cfg, shape, step_kind, strategy, mesh, group, shards, seq_shards, in_specs, args,
                time.time() - t0)


def _member_bytes(tree, seen: set, out: dict, member: int = 0, n: int = 1) -> None:
    """Bytes of the distinct storages in ``tree`` by member (a group's
    member trees, a ``HeadSplit``'s parts and, over a group of ``n``, an
    OptState's per-member moment trees to their members; anything else to
    the home member), skipping storages in ``seen``."""
    if tree is None:
        return
    if TP.is_group(tree):
        for i, m in enumerate(tree.members):
            _member_bytes(m, seen, out, i)
        return
    if isinstance(tree, TP.HeadSplit):
        for i, p in enumerate(tree.parts):
            _member_bytes(p, seen, out, i)
        return
    if isinstance(tree, OptState):
        _member_bytes(tree.step, seen, out, member)
        for f in ("mu", "nu"):
            v = getattr(tree, f)
            if n > 1 and isinstance(v, list) and len(v) == n:
                for i, m in enumerate(v):
                    _member_bytes(m, seen, out, i)
            else:
                _member_bytes(v, seen, out, member)
        return
    if isinstance(tree, torch.Tensor):
        st = tree.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            out[member] = out.get(member, 0) + st.nbytes()
        return
    if isinstance(tree, dict):
        tree = list(tree.values())
        n = 1
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _member_bytes(v, seen, out, member, n)


def _data_collectives(counter: OA.OpCounter, cell: Cell) -> None:
    """The data axis's collectives, once a step (see the module
    docstring): they move nothing between a shard's members, so
    ``models.tp`` does not see them. Called after the step, outside the
    counter's mode (the meta shapes it reads are not the step's)."""
    mesh = cell.mesh
    data = [a for a in ("pod", "data") if a in mesh.axis_names]
    n_data = SH._axis_size(mesh, tuple(data)) if data else 1
    trains = cell.step in ("train", "finetune_populate", "finetune_cached")
    p_specs = cell.arg_specs[0]
    full = LM.param_shapes(cell.cfg)
    for leaf, spec in zip(SH._leaves(full), SH._leaves(p_specs)):
        nbytes = leaf.numel() * leaf.element_size()
        axes = [a for p in spec if p is not None for a in ((p,) if isinstance(p, str) else p)
                if SH._axis_size(mesh, a) > 1]
        on_data = any(a in ("pod", "data") for a in axes)
        if len(cell.group) > 1:                  # 'tp': the leaf's model shard
            model = SH._axis_size(mesh, "model") if "model" in axes else 1
            if on_data:
                counter.add_collective("all-gather", nbytes / model)
            if cell.step == "train" and n_data > 1:
                counter.add_collective("all-reduce", nbytes / model)
        else:                                    # 'fsdp' / 'ep', or one device
            if axes:
                counter.add_collective("all-gather", nbytes)
            if cell.step == "train" and mesh.size > 1:
                counter.add_collective("reduce-scatter" if axes else "all-reduce", nbytes)
    if trains and cell.step != "train" and mesh.size > 1:
        adapters = cell.args[1]
        counter.add_collective("all-reduce", sum(t.numel() * t.element_size() for t in tree_leaves(adapters)))
    if cell.seq_shards > 1:
        # the sequence over data shards: each attention layer's partial
        # outputs (the compute dtype) and fp32 log-sum-exps gathered
        cfg, d = cell.cfg, cell.seq_shards
        rows = cell.args[_BATCH_ARG[cell.step]].shape[0]       # one token a row
        item = LM.model_dtype(cfg).itemsize
        for kind in cfg.layer_kinds():
            if kind in ("attn", "attn_local"):
                counter.add_collective("all-gather", d * rows * cfg.n_heads * cfg.resolved_head_dim * item)
                counter.add_collective("all-gather", d * rows * cfg.n_heads * 4)


def count_cell(cell: Cell, *, sample_loops: bool = True) -> dict:
    """Count ``cell``'s step (``op_analysis.count``; its time loops sampled
    unless ``sample_loops`` is False) -> the record."""
    args_seen: set = set()
    arg_members: dict = {}
    n = len(cell.group)
    _member_bytes(cell.args, args_seen, arg_members, n=n)
    t0 = time.time()
    out, counter = OA.count(lambda: cell.fn(*cell.args), sample_loops=sample_loops)
    run_s = time.time() - t0
    _data_collectives(counter, cell)
    out_members: dict = {}
    _member_bytes(out, set(args_seen), out_members, n=n)
    coll = counter.collectives()
    home = counter.home
    out_bytes = float(out_members.get(0, 0))
    arg_bytes = _arg_bytes(cell.example_args, cell.arg_specs, cell.mesh)
    temp = max(0.0, home.peak_bytes - out_bytes)
    rec = {
        "arch": cell.cfg.name,
        "shape": cell.shape.name,
        "step": cell.step,
        "mesh": _mesh_name(cell.mesh),
        "strategy": cell.strategy,
        "chips": int(cell.mesh.size),
        "unrolled": False,
        "build_s": round(cell.build_s, 3),
        "run_s": round(run_s, 3),
        "flops": home.flops,
        "dot_flops": home.dot_flops,
        "bytes_accessed": home.bytes_accessed,
        "collective_bytes": coll.total_bytes,
        "collective_count": coll.count,
        "collectives_per_op": coll.per_op_bytes,
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_bytes),
        "temp_size_in_bytes": int(temp),
        "group": n,
        "batch_shards": cell.batch_shards,
        "seq_shards": cell.seq_shards,
        "ops": counter.ops,
        "per_member": [{**counter.members[i].as_dict(), "argument_bytes": arg_members.get(i, 0),
                        "output_bytes": out_members.get(i, 0)} for i in range(n)],
        "peak_bytes_all_members": counter.peak_all,
        "argument_bytes_all_members": int(sum(arg_members.values())),
    }
    rec["memory_analysis"] = (
        f"per device (member 0 of {n}): argument {arg_bytes / 2**30:.3f} GiB (spec trees), "
        f"output {out_bytes / 2**30:.3f} GiB, temp {temp / 2**30:.3f} GiB (peak new {home.peak_bytes / 2**30:.3f} "
        f"GiB; counted, not allocated)")
    return rec


def run_cell(
    arch,
    shape_name,
    step_kind: str,
    *,
    multi_pod: bool = False,
    unroll: bool = False,
    skiplora_mode: str = "full",
    strategy: str = "tp",
) -> dict:
    """Build one cell on the production mesh (over ``meta``) and count its
    first data shard's program; the dry-run / roofline record.
    ``unroll`` changes nothing (kept for the reference's flag)."""
    del unroll
    cell = prepare_cell(arch, shape_name, step_kind, multi_pod=multi_pod, skiplora_mode=skiplora_mode,
                        strategy=strategy)
    return count_cell(cell)


def _cell_record(arch, shape, step, multi_pod, unroll, skiplora_mode, strategy):
    """One cell's record and None, or its error record and the traceback
    (the reference records a failed cell as ``{"error": ...}``)."""
    try:
        rec = run_cell(arch, shape, step, multi_pod=multi_pod, skiplora_mode=skiplora_mode, strategy=strategy)
        rec["unrolled"] = unroll
        return rec, None
    except Exception as e:  # noqa: BLE001 -- a failed cell is a record, as in the reference
        return ({"arch": arch, "shape": shape, "step": step, "mesh": "2x16x16" if multi_pod else "16x16",
                 "error": f"{type(e).__name__}: {e}"}, traceback.format_exc())


def default_step_for(shape_name: str) -> str:
    return {
        "train_4k": "train",
        "prefill_32k": "prefill",
        "decode_32k": "decode",
        "long_500k": "decode",
    }[shape_name]


def main(argv=None) -> list[dict]:
    from repro_torch.configs.registry import list_archs
    from repro_torch.launch.shapes import cell_supported

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--step", default=None, choices=list(ST.STEP_KINDS))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="run every supported cell")
    ap.add_argument("--skiplora-mode", default="full")
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp", "ep"])
    ap.add_argument("--unroll", action="store_true", help="accepted for the reference's flag; changes nothing")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1,
                    help="worker processes for several cells (default: the host's CPUs; 1 runs in this process)")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, str]] = []
    if args.all:
        for a in list_archs():
            for s in SHAPES:
                ok, why = cell_supported(a, s)
                if not ok:
                    print(f"SKIP {a} x {s}: {why}")
                    continue
                cells.append((a, s, default_step_for(s)))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells.append((args.arch, args.shape, args.step or default_step_for(args.shape)))

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    jobs = [(a, s, st, mp, args.unroll, args.skiplora_mode, args.strategy) for a, s, st in cells for mp in meshes]
    n = max(1, min(args.jobs, len(jobs)))
    t_all = time.time()
    if n == 1:
        results = (_cell_record(*job) for job in jobs)
    else:
        import concurrent.futures
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn"),
                                                      initializer=torch.set_num_threads, initargs=(1,))
        results = pool.map(_cell_record, *zip(*jobs))
    records = []
    for (arch, shape, step, mp, *_), (rec, tb) in zip(jobs, results):
        records.append(rec)
        tag = f"{arch} x {shape} x {step} x {'multi' if mp else 'single'}"
        if tb is not None:
            print(f"FAIL {tag}: {rec['error']}\n{tb}", flush=True)
            continue
        print(f"OK   {tag}: dot_flops={rec['dot_flops']:.3e} coll={rec['collective_bytes']:.3e}B "
              f"ops={rec['ops']} build={rec['build_s']}s run={rec['run_s']}s", flush=True)
        print("  memory:", rec["memory_analysis"])
    if n > 1:
        pool.shutdown()
    print(f"{len(records)} records, {sum('error' in r for r in records)} errors, {time.time() - t_all:.1f} s "
          f"in {n} process{'es' if n > 1 else ''}")
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        with open(args.out, "w") as f:
            json.dump(existing + records, f, indent=1)
        print(f"wrote {len(records)} records to {args.out}")
    return records


if __name__ == "__main__":
    main()
