"""End-to-end training launcher: the full-backprop baseline.

The counterpart of ``repro.launch.train``: full-backprop training of any
``--arch`` (reduced or full config) with AdamW (weight decay 0.1), gradient
clipping at global norm 1, the synthetic token pipeline, checkpointing and
the fault supervisor. It is the ``train`` step that
``launch.flops.model_flops(..., "train")`` counts, and the baseline that
Skip2-LoRA's cached step is measured against.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --full --steps 4 --batch 8 --seq 128 [--scan-chunk 2]

Same flags as the reference's CLI, plus ``--device`` (default ``cuda``) and
``--seed`` (weights drawn from a ``torch.Generator``). The step reaches no
hand-written kernel, as in the reference: the model has no adapters and
never sets ``use_flash``.

The default path runs one step a Python call under ``runtime.fault``'s
``Supervisor`` with a ``CheckpointManager`` (``--ckpt-every``): an
exception rolls back to the latest checkpoint, and a launch that finds a
checkpoint in ``--ckpt-dir`` resumes from it. Step s always trains on the
sampler's batch s, so a resumed run continues the uninterrupted one's data.

``--scan-chunk N`` runs N steps per dispatch over pre-sampled batch ids, the
whole synthetic set staged on the device: the reference's ``lax.scan``. On
the card a chunk is one CUDA-graph replay (``make_scan_chunk``) over the
parameters, AdamW's moments and step, the staged tokens and labels, the
(N, batch) id matrix and the losses. Each captured step writes its new
parameters and moments back into the caller's own (donated, handed back),
so the graph's pool holds one step's temporaries, not N copies of the
state; the tokens and labels are only read, and the entry is keyed on the
storage of all four. On the CPU a chunk is the eager loop. A chunk's result
is the same bits as N per-step calls.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.cuda_graph import GraphCache, capture, on_side_stream, storage_sig
from repro_torch.data.pipeline import DataConfig, SamplerState, make_pipeline
from repro_torch.models.lm import init_lm, train_loss_fn
from repro_torch.optim.optimizers import OptState, adamw, apply_updates, clip_by_global_norm, tree_leaves, tree_map
from repro_torch.runtime.fault import Supervisor

Params = Any

#: the CUDA graphs of the scan chunks run on the card
GRAPHS = GraphCache(capacity=2)


def _like(tree: Params, leaves) -> Params:
    """``tree``'s structure over ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_step(cfg, opt):
    """(params, opt_state, batch {"tokens", "labels"}) -> (params, opt_state,
    loss): the loss, ``torch.autograd.grad`` over every parameter, the
    gradients clipped to global norm 1, ``opt.update`` and
    ``apply_updates``. Functional: new tensors out, the inputs untouched."""

    def step(params, opt_state, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = train_loss_fn(p, cfg, batch)
            grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True, materialize_grads=True)
        grads = clip_by_global_norm(_like(params, grads), 1.0)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()

    return step


def _opt_leaves(st: OptState) -> list[torch.Tensor]:
    return [st.step] + tree_leaves(st.mu) + tree_leaves(st.nu)


class _ChunkGraph:
    """One chunk of ``n`` steps on the card: static buffers and the graph of
    the steps over them. The first call's parameters and moments become the
    static buffers (donated, no copy: at full width the state is ~16 GB),
    which each step's new state is written back into; the staged tokens and
    labels are read in place and never written. The entry is keyed on the
    storage of all four (``chunk_key``), so only the caller that was
    handed the buffers back reaches them again; the id matrix goes into a
    buffer of the entry's own."""

    def __init__(self, step, params, opt_state, tokens, labels, idx_mat):
        self.step = step
        self.params, self.opt_state = params, opt_state
        self.tokens, self.labels = tokens, labels
        self.idx = idx_mat.clone()
        self.losses = torch.zeros(idx_mat.shape[0], dtype=torch.float32, device=idx_mat.device)
        self.graph = None

    def _state(self) -> list[torch.Tensor]:
        return tree_leaves(self.params) + _opt_leaves(self.opt_state)

    def _batch(self, s: int) -> dict:
        ids = self.idx[s]
        return {"tokens": self.tokens[ids], "labels": self.labels[ids]}

    def _body(self, n: int) -> None:
        for s in range(n):
            params, opt_state, loss = self.step(self.params, self.opt_state, self._batch(s))
            torch._foreach_copy_(self._state(), tree_leaves(params) + _opt_leaves(opt_state))
            self.losses[s].copy_(loss)

    def run(self, idx_mat):
        self.idx.copy_(idx_mat)
        if self.graph is None:
            # warm-up: one step whose result is dropped, so the state stays
            # the caller's; its temporaries go back to the device before the
            # capture's own pool takes one step's worth
            on_side_stream(lambda: self.step(self.params, self.opt_state, self._batch(0)), self.idx.device)
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            capture(graph, lambda: self._body(self.idx.shape[0]), what=f"a train chunk of {self.idx.shape[0]} steps")
            self.graph = graph
        self.graph.replay()
        return self.params, self.opt_state, self.losses.clone()

    def free(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.params = self.opt_state = self.tokens = self.labels = None


def chunk_key(cfg, opt, params, opt_state, tokens, labels, idx_mat) -> tuple:
    """What fixes a chunk's graph: the config, the optimizer, the id
    matrix's shape and the storage of the state it donates (params,
    moments, step count) and of the tokens and labels it reads."""
    return (cfg, opt, tuple(idx_mat.shape), idx_mat.dtype, tokens.device, storage_sig(params),
            storage_sig(_opt_leaves(opt_state)), storage_sig(tokens), storage_sig(labels))


def make_scan_chunk(cfg, opt, *, graphs: Optional[GraphCache] = None):
    """A chunk of train steps as one dispatch: ``run_chunk(params,
    opt_state, tokens, labels, idx_mat) -> (params, opt_state, losses
    (n,))`` over an (n, batch) id matrix gathering from device-staged
    tokens / labels (S, seq).

    On CUDA tensors the chunk is one CUDA-graph replay (cached in
    ``GRAPHS`` by ``chunk_key``); its first call runs one step eagerly on a
    side stream (the warm-up, its result dropped) and captures. The
    caller's params and opt_state become the graph's static buffers, and
    the returned params and opt_state ARE those buffers, which the next
    call with them overwrites: they are donated, as the reference's
    ``donate_argnums`` donates them. Tokens and labels are only read.
    Another state, even of equal shapes, keys another entry and never
    lands in these buffers. A failed capture raises ``GraphCaptureError``;
    nothing falls back to eager steps. On CPU tensors the chunk is the
    eager loop and returns new tensors."""
    step = make_step(cfg, opt)
    cache = GRAPHS if graphs is None else graphs

    def run_chunk(params, opt_state, tokens, labels, idx_mat):
        idx_mat = idx_mat.to(device=tokens.device, dtype=torch.long)
        if not tokens.is_cuda:
            losses = []
            for ids in idx_mat:
                params, opt_state, loss = step(params, opt_state, {"tokens": tokens[ids], "labels": labels[ids]})
                losses.append(loss)
            return params, opt_state, torch.stack(losses)
        key = chunk_key(cfg, opt, params, opt_state, tokens, labels, idx_mat)
        e = cache.entry(key, lambda: _ChunkGraph(step, params, opt_state, tokens, labels, idx_mat))
        return e.run(idx_mat)

    return run_chunk


def _state_tree(params, opt_state: OptState) -> dict:
    return {"params": params, "opt": {"step": opt_state.step, "mu": opt_state.mu, "nu": opt_state.nu}}


def _from_tree(state: dict):
    o = state["opt"]
    return state["params"], OptState(step=o["step"], mu=o["mu"], nu=o["nu"])


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--scan-chunk", type=int, default=0,
                    help="N steps per dispatch: one CUDA-graph replay on the card (0 = off)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights' torch.Generator")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the flags' training. Returns {"losses": per-step losses, "params",
    "opt_state", "step_s": wall seconds of each step (per-step path) or of
    each chunk (scan path), "chunks": steps of each chunk (scan path)}."""
    args = parse_args(argv)
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} params={cfg.param_count():,} on {device}")

    params = init_lm(torch.Generator(device=device).manual_seed(args.seed), cfg)
    opt = adamw(args.lr, weight_decay=0.1)
    opt_state = opt.init(params)
    step_fn = make_step(cfg, opt)

    dcfg = DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=args.seq,
        global_batch=args.batch,
        num_samples=max(args.batch * 8, 256),
    )
    store, sampler = make_pipeline(dcfg)
    ckpt = CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every)
    sup = Supervisor(ckpt)

    t_start = time.time()
    losses: list[float] = []
    step_s: list[float] = []

    if args.scan_chunk > 0:
        # Fused path: chunks of steps in one dispatch; checkpoint per chunk.
        run_chunk = make_scan_chunk(cfg, opt)
        staged = store.batch(np.arange(dcfg.num_samples))
        tokens = torch.as_tensor(staged["tokens"], device=device)
        labels = torch.as_tensor(staged["labels"], device=device)
        chunks = []
        step = 0
        while step < args.steps:
            n = min(args.scan_chunk, args.steps - step)
            idx_mat = torch.as_tensor(np.stack([sampler.next_ids() for _ in range(n)]), device=device)
            _sync(device)
            t0 = time.perf_counter()
            params, opt_state, ls = run_chunk(params, opt_state, tokens, labels, idx_mat)
            losses.extend(ls.float().cpu().tolist())
            step_s.append(time.perf_counter() - t0)
            chunks.append(n)
            prev = step
            step += n
            dt = time.time() - t_start
            print(f"step {step:5d} loss {losses[-1]:.4f} ({dt:.1f}s, {n} steps/dispatch)")
            # Save whenever the chunk crossed a save boundary (chunk size
            # need not divide --ckpt-every).
            if prev // args.ckpt_every != step // args.ckpt_every:
                ckpt.save(step, _state_tree(params, opt_state))
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
        return {"losses": losses, "params": params, "opt_state": opt_state, "step_s": step_s, "chunks": chunks}

    def run_one(state, step):
        sampler.state = SamplerState(dcfg.seed, step)
        batch_np = store.batch(sampler.next_ids())
        batch = {
            "tokens": torch.as_tensor(batch_np["tokens"], device=device),
            "labels": torch.as_tensor(batch_np["labels"], device=device),
        }
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(*_from_tree(state), batch)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        if step % args.log_every == 0:
            dt = time.time() - t_start
            print(f"step {step:5d} loss {float(loss):.4f} ({dt:.1f}s)")
        return _state_tree(params, opt_state)

    state = sup.run(_state_tree(params, opt_state), run_one, num_steps=args.steps)
    params, opt_state = _from_tree(state)
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return {"losses": losses, "params": params, "opt_state": opt_state, "step_s": step_s}


if __name__ == "__main__":
    main()
