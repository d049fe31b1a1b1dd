"""GPipe pipeline parallelism of the session's admission prefill, the
counterpart of ``repro.runtime.pipeline_par``.

  - ``split_stages``: a layer list into ``n_stages`` contiguous stages, the
    last padded with references to the final layer marked invalid.
  - ``pipeline_apply``: a generic pipelined layer stack over microbatches
    (the schedule the tests hold; the reference for the math below).
  - ``pipeline_prefill``: the scheduler's admission prefill. Each stage
    holds a contiguous block of backbone layers and those layers' adapter
    rows, adds its blocks' skip-LoRA terms from the block *inputs* (the
    paper's skip connections read block inputs only, so the sum composes
    across stages), and hands ``(h, skip)`` to the next stage.

The schedule is the reference's: ``n_micro + n_stages - 1`` ticks, stage
``s`` takes microbatch ``t - s`` at tick ``t``, bubble fraction
``(P - 1) / (M + P - 1)``. One process drives every stage: a handoff is a
copy onto the next stage's device (a no-op when two stages share one), and
each stage's kernels queue on its own device's current stream. A copy
between two cards orders both cards' streams (each waits for the other's
work queued so far), so ``pipeline_prefill`` queues a tick's later stages
first and makes the last stage's copies onto the first device after the
last tick: stage ``s + 1``'s microbatch ``m`` then waits only on its
handoff, and stages on different cards overlap as the schedule says, on
the card's eager streams and in a CUDA graph captured over them alike.
The stage split is a list of lists of the caller's own layer dicts:
nothing is stacked or copied, and a pad is the last layer again with
``valid`` False. The skip terms stay plain torch, as the reference
computes them in plain jnp.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

Params = Any


def _structure(tree: Params):
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return ("list", tuple(_structure(v) for v in tree))
    return "leaf"


def split_stages(layer_params: list[Params], n_stages: int) -> tuple[list[list[Params]], torch.Tensor]:
    """Group L per-layer params into ``n_stages`` stages of ``ceil(L / n)``
    layers. Returns ``(stages, valid)``: ``stages[s]`` the list of stage
    ``s``'s layers (the caller's dicts), the last stage padded with the
    final layer; ``valid`` (n_stages, per) bool on the CPU marks the pads
    False, and runners pass activations through them unchanged."""
    n = len(layer_params)
    if n == 0 or n_stages <= 0:
        raise ValueError(f"need >=1 layer and >=1 stage, got {n}/{n_stages}")
    if n_stages > n:
        raise ValueError(f"{n_stages} stages for {n} layers leaves empty stages")
    per = -(-n // n_stages)
    padded = list(layer_params) + [layer_params[-1]] * (n_stages * per - n)
    if len({_structure(p) for p in padded}) != 1:
        raise ValueError("split_stages needs identically-structured layers (uniform block stacks only)")
    stages = [padded[s * per:(s + 1) * per] for s in range(n_stages)]
    valid = (torch.arange(n_stages * per) < n).reshape(n_stages, per)
    return stages, valid


def _check(stages, devices, valid):
    if len(stages) != len(devices):
        raise ValueError(f"{len(stages)} stages over {len(devices)} devices")
    if valid is None:
        valid = torch.ones((len(stages), len(stages[0])), dtype=torch.bool)
    return [[bool(v) for v in row] for row in valid.tolist()]


def pipeline_apply(
    stages: list[list[Params]],
    x_micro: torch.Tensor,
    layer_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    *,
    devices,
    valid: torch.Tensor = None,
) -> torch.Tensor:
    """Run the pipelined stack over microbatches. ``stages[s]`` lives on
    ``devices[s]``; ``x_micro`` (n_micro, mb, ...) on ``devices[0]``;
    ``valid`` from ``split_stages`` (False layers pass their input on).
    Returns (n_micro, mb, ...) on ``devices[0]``, each microbatch taken
    off the last stage at tick ``m + n_stages - 1``."""
    devices = [torch.device(d) for d in devices]
    ok = _check(stages, devices, valid)
    n_stages, n_micro = len(stages), x_micro.shape[0]
    buf: list = [None] * n_stages
    outs: list = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        nxt: list = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            h = x_micro[m].to(devices[0]) if s == 0 else buf[s]
            for p, v in zip(stages[s], ok[s]):
                if v:
                    h = layer_fn(p, h)
            if s + 1 < n_stages:
                nxt[s + 1] = h.to(devices[s + 1])
            else:
                outs[m] = h.to(devices[0])
        buf = nxt
    return torch.stack(outs)


def pipeline_prefill(
    stages: list[list[Params]],
    stage_a: list[torch.Tensor],
    stage_b: list[torch.Tensor],
    valid: torch.Tensor,
    x_micro: torch.Tensor,
    lens: torch.Tensor,
    slots: torch.Tensor,
    block_fn: Callable[[int, int, Params, torch.Tensor], torch.Tensor],
    *,
    devices,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pipelined admission prefill with per-stage skip-LoRA sums.

    stages: ``split_stages``' layers, stage ``s`` on ``devices[s]``.
    stage_a / stage_b: per stage the adapter pool's rows of its valid
        layers, (n_slots, n_valid_s, D, R) / (n_slots, n_valid_s, R, D) on
        ``devices[s]``.
    x_micro: (n_micro, mb, T, D) embedded prompts; lens (n_micro, mb) the
        rows' prompt lengths; slots (n_micro, mb) their adapter slots; all
        on ``devices[0]``.
    block_fn: (layer index, microbatch index, layer params, h) -> the
        block's output, prefill mode (the caller writes its caches; a
        stage off ``devices[0]`` should copy them there only after this
        call returns, as the last stage's outputs are).

    The carry is ``(h, skip)``: each stage reads its blocks' inputs at every
    row's last real position (``max(len, 1) - 1``, ``lm.sched_prefill``'s
    padding rule), adds ``(h_l @ A[slot, l]) @ B[slot, l]`` for its layers,
    and the last stage hands back the finished sum. Returns (y (n_micro,
    mb, T, D), skip (n_micro, mb, D)) on ``devices[0]``."""
    devices = [torch.device(d) for d in devices]
    ok = _check(stages, devices, valid)
    n_stages, n_micro, per = len(stages), x_micro.shape[0], len(stages[0])
    lens_s = [lens.to(d) for d in devices]
    slots_s = [slots.long().to(d) for d in devices]
    buf: list = [None] * n_stages
    ys: list = [None] * n_micro
    skips: list = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        nxt: list = [None] * n_stages
        # the later stages first: a handoff then waits for the next card's
        # earlier microbatch without holding this tick's work back
        for s in reversed(range(n_stages)):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            if s == 0:
                h = x_micro[m]
                skip = torch.zeros(h.shape[:1] + h.shape[2:], dtype=h.dtype, device=h.device)
            else:
                h, skip = buf[s]
            rows = torch.arange(h.shape[0], device=h.device)
            last = (lens_s[s][m].clamp(min=1) - 1).long()
            slot, k = slots_s[s][m], 0
            for j, (p, v) in enumerate(zip(stages[s], ok[s])):
                if not v:
                    continue
                hl = h[rows, last]                                          # (mb, D)
                a_rows = stage_a[s][slot, k].to(h.dtype)                    # (mb, D, R)
                b_rows = stage_b[s][slot, k].to(h.dtype)                    # (mb, R, D)
                term = torch.einsum("mr,mrd->md", torch.einsum("md,mdr->mr", hl, a_rows), b_rows)
                h = block_fn(s * per + j, m, p, h)
                skip = skip + term
                k += 1
            if s + 1 < n_stages:
                nxt[s + 1] = (h.to(devices[s + 1]), skip.to(devices[s + 1]))
            else:
                ys[m], skips[m] = h, skip
        buf = nxt
    # home after the last tick: a copy mid-schedule would hold the first
    # device's later ticks back until the last stage had caught up
    return torch.stack([y.to(devices[0]) for y in ys]), torch.stack([k.to(devices[0]) for k in skips])


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
