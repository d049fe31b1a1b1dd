"""Rematerialisation of the layer stack in training: the counterpart of
the reference's ``jax.checkpoint`` around each period of layers.

``region(fn, *args)`` runs ``fn(*args)`` as one
``torch.utils.checkpoint`` region (non-reentrant; a test replaces it with
a plain call to get the un-rematerialised run): autograd keeps the
region's inputs and nothing inside it, and the backward replays ``fn`` to
get back the tensors it needs, stopping once it has them all (the
checkpoint's early stop). ``blocks.stack_forward`` wraps each period of
layers in one region in train mode; the remainder layers run outside any,
as in the reference.

The reference's replay is a traced program that XLA prunes: a product
whose result no saved value reads is left out of it (each period's last
FFN down projection, each skip-LoRA tap's ``@ B``). PyTorch's replay runs
every op up to the last tensor it saves, and a matrix product saves its
operands only as it runs. ``product(x, w)`` is ``x @ w`` for such a
product: inside a region it saves its operands itself
(``_TailProduct``) and, in the replay, skips the product whose result
nothing reads, so the replay issues the reference's products. The caller
marks where it applies with ``tail()``: the taps always (their results
only add into the skip sum), the down projection in the region's last
block, where no post-norm reads its result.

The forward draws no random numbers, so no RNG state is stashed for the
replay. The replay runs in a copy of the forward's ``contextvars``
context, so settings read at forward time (``ssm.sample_time_loops``)
hold in the replay too, on whatever thread the backward runs it.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.utils.checkpoint import checkpoint

#: None outside a region, "forward" or "replay" inside one
_REGION: contextvars.ContextVar = contextvars.ContextVar("remat_region", default=None)
#: True while the products ``product`` runs read nothing saved downstream
_TAIL: contextvars.ContextVar = contextvars.ContextVar("remat_tail", default=False)


def in_region() -> bool:
    """True while a region's forward or replay runs."""
    return _REGION.get() is not None


def replaying() -> bool:
    """True while a region's backward replay runs."""
    return _REGION.get() == "replay"


def _enter(fn, phase: str, *args):
    token = _REGION.set(phase)
    try:
        return fn(*args)
    finally:
        _REGION.reset(token)


def region(fn, *args):
    """``fn(*args)`` as one rematerialised region (see the module
    docstring). Without grad mode it is the plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    ctx = contextvars.copy_context()
    calls = []

    def run(*a):
        calls.append(None)
        return ctx.copy().run(_enter, fn, "forward" if len(calls) == 1 else "replay", *a)

    # no RNG state: the forward draws no random numbers
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


@contextlib.contextmanager
def tail(on: bool = True):
    """Mark the ``product`` calls inside as ones whose results no saved
    tensor of the region reads."""
    token = _TAIL.set(on)
    try:
        yield
    finally:
        _TAIL.reset(token)


class _TailProduct(torch.autograd.Function):
    """``x @ w`` (x (..., K), w (K, N)) saving its operands; with ``skip``
    (the replay) the result is left uncomputed, as nothing reads it: one
    uninitialised element broadcast to the result's shape."""

    @staticmethod
    def forward(ctx, x, w, skip):
        from repro_torch.models import tp as TP

        TP.label_node(ctx)     # the backward is the member's that ran the forward
        ctx.save_for_backward(x, w)
        if skip:
            return x.new_empty(()).expand(x.shape[:-1] + w.shape[-1:])
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w.T if ctx.needs_input_grad[0] else None
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1]) if ctx.needs_input_grad[1] else None
        return gx, gw, None


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; inside a region, for a product marked as a tail
    (``tail()``) that autograd records, the one the replay skips."""
    if in_region() and _TAIL.get() and (x.requires_grad or w.requires_grad):
        return _TailProduct.apply(x, w, replaying())
    return x @ w
