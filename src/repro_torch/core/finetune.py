"""Algorithm 1: fine-tuning with Skip2-LoRA (and the seven baselines).

Counterpart of ``repro.core.finetune``. The paper's loop (per epoch, per
batch): forward FCs consulting C_skip, add new results to C_skip, forward
LoRA, backward LoRA, update LoRA weights. Epoch 0 runs the *populate* phase
(backbone forward + cache scatter + adapter SGD step); epochs >= 1 run the
*cached* phase (cache gather + adapter SGD step, zero backbone compute).

Every epoch function takes its (steps, batch) index matrix explicitly, as
the reference's jitted epochs do. The reference runs an epoch as one
``lax.scan`` dispatch; here, on CUDA tensors, an epoch is one CUDA-graph
replay. The graph holds every step of the phase: the gather of ``x[idx]``
and ``y[idx]``, the forward, the backward (``torch.autograd.grad``), the
SGD update in place and, in the populate phase, the cache scatter, over
static buffers for the trainable leaves, the frozen leaves, the cache, ``x``,
``y``, the index matrix and the per-step losses. A call copies its inputs
into those buffers, replays, and hands the results out as clones. Graphs
are cached in ``GRAPHS`` by (phase, method, config, n, steps, batch, lr,
device); an entry's first call runs one step eagerly on a side stream (the
warm-up), loads its inputs again and captures. A capture that fails raises
``GraphCaptureError``; nothing falls back to the eager steps.

``loop=True`` runs the same steps eagerly, one Python call a step: on CPU
tensors that is the only path, and on the card it is the yardstick the
replays are held to, bitwise. Either way an epoch leaves its arguments
untouched and returns new tensors. The per-batch ``_populate_step`` /
``_cached_step`` factories remain as the step-granular API; their steps,
like ``methods.train_step``, update the trainable leaves and the cache in
place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core import methods as M
from repro_torch.core import skip_cache as C
from repro_torch.core.batch_plan import index_matrix
from repro_torch.core.cuda_graph import GraphCache, capture, on_side_stream
from repro_torch.models.mlp import MLPConfig, accuracy
from repro_torch.optim.optimizers import tree_leaves, tree_map

Params = Any

#: the CUDA graphs of the epochs run on the card
GRAPHS = GraphCache(capacity=16)


@dataclasses.dataclass
class FinetuneResult:
    trainable: Params
    frozen: Params
    losses: list[float]
    epoch_times_s: list[float]
    cache: Optional[C.SkipCache] = None

    def predict_fn(self, method: str, cfg: MLPConfig) -> Callable:
        @torch.no_grad()
        def predict(x):
            logits, _ = M.forward(method, self.trainable, self.frozen, x, cfg)
            return logits

        return predict


def epoch_index_matrix(generator: torch.Generator, n: int, batch_size: int, *, device="cuda") -> torch.Tensor:
    """Pre-permuted batch indices, shape (steps, batch), int64 on ``device``.
    The whole epoch's visitation order is decided up front so the epoch can
    run as one replay.

    Covers ALL n samples via the shared planner's ``tail="wrap"`` semantics
    (``core.batch_plan.index_matrix``): a non-dividing last batch wraps
    around to the front of the permutation. Dropping the remainder would
    leave samples unpopulated in epoch 0, and a later epoch's different
    permutation would then gather all-zero cache rows for them."""
    perm = torch.randperm(n, generator=generator, device=generator.device).cpu().numpy()
    return torch.as_tensor(index_matrix(perm, batch_size, tail="wrap"), dtype=torch.long).to(device)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _cache_values(cfg: MLPConfig, trainable: Params, logits: torch.Tensor, xs: list[torch.Tensor]):
    """What the cache keeps of a full skip-LoRA forward: x^2..x^n and the base
    output, by linearity y_base = logits - sum_k x^k A_k B_k (no second,
    adapter-free forward)."""
    skip = torch.zeros_like(logits)
    for k, lora in enumerate(trainable["lora"]):
        skip = skip + M.lora_apply(lora, xs[k])
    values = {f"x{k}": xs[k] for k in range(1, cfg.n_layers)}
    values["y_base"] = logits - skip
    return values


def _populate(cfg: MLPConfig, trainable, frozen, cache, idx, xb, yb, lr, write):
    """Backbone forward + ``write`` of the cache values + adapter step, in
    place. The values come from the step's own forward, with the adapters
    that made its logits."""
    fwd = {}

    def loss_fn(t):
        fwd["out"], fwd["xs"] = M.forward("skip_lora", t, frozen, xb, cfg)
        return M.cross_entropy(fwd["out"], yb)

    loss, grads = M.value_and_grad(loss_fn, trainable)
    with torch.no_grad():
        cache = write(cache, idx, _cache_values(cfg, trainable, fwd["out"].detach(), fwd["xs"]))
    return M.sgd_(trainable, grads, lr), cache, loss


def _populate_body(cfg: MLPConfig, trainable, frozen, cache, idx, xb, yb, lr):
    """Backbone forward + cache write + adapter step (first encounter)."""
    return _populate(cfg, trainable, frozen, cache, idx, xb, yb, lr, C.cache_write)


def _cached_body(cfg: MLPConfig, trainable, cache, idx, xb, yb, lr):
    """Adapter-only step from cached activations (zero backbone compute)."""
    vals = C.cache_read(cache, idx)
    xs = [xb] + [vals[f"x{k}"] for k in range(1, cfg.n_layers)]
    return M.cached_train_step(trainable, vals["y_base"], xs, yb, lr)


def _populate_step(cfg: MLPConfig) -> Callable:
    """Per-batch populate step (step-granular API): (trainable, frozen, cache,
    idx, xb, yb, lr) -> (trainable, cache, loss), in place."""

    def step(trainable, frozen, cache, idx, xb, yb, lr):
        return _populate_body(cfg, trainable, frozen, cache, idx, xb, yb, lr)

    return step


def _cached_step(cfg: MLPConfig) -> Callable:
    """Per-batch cached step (step-granular API): (trainable, cache, idx, xb,
    yb, lr) -> (trainable, loss), in place."""

    def step(trainable, cache, idx, xb, yb, lr):
        return _cached_body(cfg, trainable, cache, idx, xb, yb, lr)

    return step


def masked_populate_step(cfg: MLPConfig) -> Callable:
    """Streaming variant: batch may mix cache hits and misses. The backbone
    runs for the whole batch, but only miss rows are written; hit rows keep
    their cached values (bitwise identical activations either way since the
    backbone is frozen; the write is for first-seen samples)."""

    def write(cache, idx, values):
        return C.cache_write_masked(cache, idx, values, ~C.cache_hits(cache, idx))

    def step(trainable, frozen, cache, idx, xb, yb, lr):
        return _populate(cfg, trainable, frozen, cache, idx, xb, yb, lr, write)

    return step


# ---------------------------------------------------------------------------
# Epochs: the eager loop and the graph replay
# ---------------------------------------------------------------------------

#: what each phase's steps write (the rest of its state is read only)
_WRITES = {"full": ("trainable",), "populate": ("trainable", "cache"), "cached": ("trainable",)}


def _clone(tree):
    if isinstance(tree, C.SkipCache):
        return C.SkipCache(slots={k: v.clone() for k, v in tree.slots.items()}, valid=tree.valid.clone())
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree_map(torch.clone, tree)


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, C.SkipCache):
        return list(tree.slots.values()) + [tree.valid]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return tree_leaves(tree)


def _body(phase: str, method: str, cfg: MLPConfig, lr: float) -> Callable:
    """The steps of one epoch phase over ``state`` (trainable, frozen, cache,
    x, y): ``body(state, idx_mat, losses, steps)`` runs the first ``steps``
    rows of ``idx_mat``, writing step s's loss into ``losses[s]``."""

    def body(st, idx_mat, losses, steps):
        for s in range(steps):
            idx = idx_mat[s]
            xb, yb = st["x"][idx], st["y"][idx]
            if phase == "full":
                _, loss = M.train_step(method, cfg, st["trainable"], st["frozen"], xb, yb, lr)
            elif phase == "populate":
                _, _, loss = _populate_body(cfg, st["trainable"], st["frozen"], st["cache"], idx, xb, yb, lr)
            else:
                _, loss = _cached_body(cfg, st["trainable"], st["cache"], idx, xb, yb, lr)
            losses[s].copy_(loss)

    return body


class _EpochGraph:
    """One epoch phase on the card: static buffers (``state``, the index
    matrix, the losses) and the graph of all its steps over them."""

    def __init__(self, stats, body, state, idx_mat, writes, what):
        self.stats, self.body, self.writes, self.what = stats, body, writes, what
        self.state = _clone(state)
        self.idx = torch.empty_like(idx_mat)
        self.losses = torch.zeros(idx_mat.shape[0], dtype=state["x"].dtype, device=idx_mat.device)
        self.graph = None

    def _load(self, state, idx_mat) -> None:
        for dst, src in zip(_leaves(self.state), _leaves(state), strict=True):
            dst.copy_(src)
        self.idx.copy_(idx_mat)

    def run(self, state, idx_mat):
        steps = self.idx.shape[0]
        if self.graph is None:
            self._load(state, idx_mat)
            on_side_stream(lambda: self.body(self.state, self.idx, self.losses, 1), self.idx.device)
            self.stats["warmup_steps"] += 1
            graph = torch.cuda.CUDAGraph()
            capture(graph, lambda: self.body(self.state, self.idx, self.losses, steps), what=self.what)
            self.graph = graph
            self.stats["captures"] += 1
        self._load(state, idx_mat)
        self.graph.replay()
        self.stats["replays"] += 1
        out = dict(state)
        for k in self.writes:
            out[k] = _clone(self.state[k])
        return out, self.losses.clone()

    def free(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.state = None


def _run_epoch(phase: str, method: str, cfg: MLPConfig, state: dict, idx_mat: torch.Tensor, lr: float,
               loop: bool, graphs: Optional[GraphCache]):
    """One epoch of ``phase`` -> (state with new tensors for what the phase
    writes, per-step losses (steps,))."""
    x = state["x"]
    idx_mat = idx_mat.to(device=x.device, dtype=torch.long)
    steps, batch = idx_mat.shape
    body = _body(phase, method, cfg, lr)
    if loop or not x.is_cuda:
        st = dict(state)
        for k in _WRITES[phase]:
            st[k] = _clone(state[k])
        losses = torch.zeros(steps, dtype=x.dtype, device=x.device)
        body(st, idx_mat, losses, steps)
        return st, losses
    graphs = GRAPHS if graphs is None else graphs
    key = (phase, method, cfg, x.shape[0], steps, batch, float(lr), x.device, x.dtype, state["y"].dtype)
    what = f"the {phase} epoch of {method} ({steps} steps of batch {batch}, n {x.shape[0]})"
    e = graphs.entry(key, lambda: _EpochGraph(graphs.stats, body, state, idx_mat, _WRITES[phase], what))
    return e.run(state, idx_mat)


def make_epoch_fn(method: str, cfg: MLPConfig, *, loop: bool = False,
                  graphs: Optional[GraphCache] = None) -> Callable:
    """Full-forward epoch: (trainable, frozen, x, y, idx_mat, lr) ->
    (trainable, losses). One graph replay on CUDA tensors (``loop=False``),
    else the eager loop of ``train_step``."""

    def epoch(trainable, frozen, x, y, idx_mat, lr):
        st, losses = _run_epoch("full", method, cfg, {"trainable": trainable, "frozen": frozen, "x": x, "y": y},
                                idx_mat, lr, loop, graphs)
        return st["trainable"], losses

    return epoch


def make_skip2_epoch_fns(cfg: MLPConfig, *, loop: bool = False,
                         graphs: Optional[GraphCache] = None) -> tuple[Callable, Callable]:
    """(populate_epoch, cached_epoch), each one graph replay on CUDA tensors
    (``loop=False``), else the eager loop.

    populate_epoch: (trainable, frozen, cache, x, y, idx_mat, lr)
        -> (trainable, cache, losses)
    cached_epoch:   (trainable, cache, x, y, idx_mat, lr)
        -> (trainable, losses)
    """

    def populate_epoch(trainable, frozen, cache, x, y, idx_mat, lr):
        st, losses = _run_epoch("populate", "skip2_lora", cfg,
                                {"trainable": trainable, "frozen": frozen, "cache": cache, "x": x, "y": y},
                                idx_mat, lr, loop, graphs)
        return st["trainable"], st["cache"], losses

    def cached_epoch(trainable, cache, x, y, idx_mat, lr):
        st, losses = _run_epoch("cached", "skip2_lora", cfg, {"trainable": trainable, "cache": cache, "x": x, "y": y},
                                idx_mat, lr, loop, graphs)
        return st["trainable"], losses

    return populate_epoch, cached_epoch


def cached_epoch_via_engine(
    cfg: MLPConfig,
    trainable: Params,
    engine,
    x_ft: torch.Tensor,
    y_ft: torch.Tensor,
    idx_mat,
    lr: float,
) -> tuple[Params, torch.Tensor]:
    """Streaming cached epoch through a ``TieredCacheEngine``: the path when
    the activation cache exceeds the device budget. Per-batch engine reads,
    with the *next* batch's host rows staged on the engine's thread while
    the current step runs. Returns (new trainable, last loss)."""
    trainable = _clone(trainable)
    loss = torch.zeros((), dtype=x_ft.dtype, device=x_ft.device)
    for idx, vals in engine.stream_batches(idx_mat):
        idx = torch.as_tensor(idx, dtype=torch.long, device=x_ft.device)
        xs = [x_ft[idx]] + [vals[f"x{k}"] for k in range(1, cfg.n_layers)]
        trainable, loss = M.cached_train_step(trainable, vals["y_base"], xs, y_ft[idx], lr)
    return trainable, loss


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def finetune(
    generator: torch.Generator,
    method: str,
    cfg: MLPConfig,
    backbone: Params,
    x_ft: torch.Tensor,
    y_ft: torch.Tensor,
    *,
    epochs: int,
    batch_size: int = 20,
    lr: float = 0.05,
    loop: bool = False,
) -> FinetuneResult:
    """Fine-tune with any of the eight methods, on the data's device.
    Dispatches to the cached Algorithm-1 loop for skip2_lora. The adapters
    and then each epoch's order are drawn from ``generator``."""
    if method == "skip2_lora":
        return finetune_skip2_lora(generator, cfg, backbone, x_ft, y_ft, epochs=epochs,
                                   batch_size=batch_size, lr=lr, loop=loop)
    trainable, frozen = M.init_method(generator, cfg, backbone, method)
    n = x_ft.shape[0]
    epoch_fn = make_epoch_fn(method, cfg, loop=loop)
    losses, times = [], []
    for _ in range(epochs):
        idx_mat = epoch_index_matrix(generator, n, batch_size, device=x_ft.device)
        t0 = time.perf_counter()
        trainable, ls = epoch_fn(trainable, frozen, x_ft, y_ft, idx_mat, lr)
        _sync(ls)
        times.append(time.perf_counter() - t0)
        losses.append(float(ls[-1]))
    return FinetuneResult(trainable, frozen, losses, times)


def finetune_skip2_lora(
    generator: torch.Generator,
    cfg: MLPConfig,
    backbone: Params,
    x_ft: torch.Tensor,
    y_ft: torch.Tensor,
    *,
    epochs: int,
    batch_size: int = 20,
    lr: float = 0.05,
    loop: bool = False,
) -> FinetuneResult:
    """Algorithm 1. Epoch 0 populates C_skip; epochs 1..E-1 skip the
    backbone. On the card every epoch phase is one graph replay."""
    trainable, frozen = M.init_method(generator, cfg, backbone, "skip2_lora")
    n = x_ft.shape[0]
    cache = C.cache_for_mlp(n, cfg.dims, cfg.dtype, device=x_ft.device)
    populate_epoch, cached_epoch = make_skip2_epoch_fns(cfg, loop=loop)
    losses, times = [], []
    for e in range(epochs):
        idx_mat = epoch_index_matrix(generator, n, batch_size, device=x_ft.device)
        t0 = time.perf_counter()
        if e == 0:
            trainable, cache, ls = populate_epoch(trainable, frozen, cache, x_ft, y_ft, idx_mat, lr)
        else:
            trainable, ls = cached_epoch(trainable, cache, x_ft, y_ft, idx_mat, lr)
        _sync(ls)
        times.append(time.perf_counter() - t0)
        losses.append(float(ls[-1]))
    return FinetuneResult(trainable, frozen, losses, times, cache=cache)


@torch.no_grad()
def evaluate(
    method: str,
    cfg: MLPConfig,
    result: FinetuneResult,
    x_test: torch.Tensor,
    y_test: torch.Tensor,
) -> float:
    logits, _ = M.forward(
        "skip_lora" if method == "skip2_lora" else method,
        result.trainable,
        result.frozen,
        x_test,
        cfg,
    )
    return float(accuracy(logits, y_test))
