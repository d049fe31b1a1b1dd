"""Skip-Cache (Section 4.2 of the paper): the forward-activation cache.

Counterpart of ``repro.core.skip_cache``. For each training sample i the
cache keeps the frozen backbone's intermediate outputs, so the forward pass
of a seen sample can be skipped: ``slots`` maps a name to a
(num_samples, ...) tensor, and ``valid`` is a (num_samples,) bool bitmap.
Lookup by sample id is one gather.

The reference's functions are pure and its epoch loops donate the cache
buffers so XLA updates them in place; here the writes go in place into the
slot tensors, and each write function also returns the cache so callers
read like the reference.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SkipCache:
    """Activation cache: ``slots`` maps name -> (num_samples, ...) tensor."""

    slots: dict[str, torch.Tensor]
    valid: torch.Tensor  # (num_samples,) bool

    @property
    def num_samples(self) -> int:
        return self.valid.shape[0]

    def hit_count(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32))


def init_cache(
    num_samples: int, slot_shapes: dict[str, tuple], dtype=torch.float32, *, device=None
) -> SkipCache:
    slots = {
        name: torch.zeros((num_samples,) + tuple(shape), dtype=dtype, device=device)
        for name, shape in slot_shapes.items()
    }
    return SkipCache(slots=slots, valid=torch.zeros((num_samples,), dtype=torch.bool, device=device))


def cache_for_mlp(num_samples: int, dims: tuple[int, ...], dtype=torch.float32, *, device=None) -> SkipCache:
    """Cache layout for the paper's MLP: the inputs x^2..x^n of FC2..FCn and
    the base last output (x^1 is the raw input, already in the dataset)."""
    n = len(dims) - 1
    slots = {f"x{k}": (dims[k],) for k in range(1, n)}
    slots["y_base"] = (dims[n],)
    return init_cache(num_samples, slots, dtype, device=device)


def cache_write(cache: SkipCache, idx: torch.Tensor, values: dict[str, torch.Tensor]) -> SkipCache:
    """Scatter a batch of computed activations at sample indices ``idx``."""
    idx = idx.long()
    for name, val in values.items():
        cache.slots[name][idx] = val.to(cache.slots[name].dtype)
    # a fill, not ``valid[idx] = True``: that copies a CPU scalar to the
    # device, which a CUDA graph capture refuses
    cache.valid.index_fill_(0, idx, True)
    return cache


def cache_write_masked(
    cache: SkipCache, idx: torch.Tensor, values: dict[str, torch.Tensor], write_mask: torch.Tensor
) -> SkipCache:
    """Scatter only rows where ``write_mask`` is True (streaming ingestion).
    A masked-out row keeps its value and its validity bit."""
    idx = idx.long()
    for name, val in values.items():
        slot = cache.slots[name]
        mask = write_mask.reshape((-1,) + (1,) * (val.ndim - 1))
        slot[idx] = torch.where(mask, val.to(slot.dtype), slot[idx])
    cache.valid[idx] = cache.valid[idx] | write_mask
    return cache


def cache_read(cache: SkipCache, idx: torch.Tensor) -> dict[str, torch.Tensor]:
    """Gather cached activations for a batch of sample indices."""
    idx = idx.long()
    return {name: arr[idx] for name, arr in cache.slots.items()}


def cache_hits(cache: SkipCache, idx: torch.Tensor) -> torch.Tensor:
    return cache.valid[idx.long()]


def cache_nbytes(cache: SkipCache) -> int:
    return sum(a.numel() * a.element_size() for a in cache.slots.values())
