"""Epoch batch planning: ``index_matrix``, a copy of the function of the same
name in ``repro.core.batch_plan`` (numpy only). The rest of that module
(fleet partitions, shadow splits) belongs to the multi-tenant slice."""

from __future__ import annotations

import numpy as np


def index_matrix(
    perm, batch_size: int, *, tail: str = "wrap"
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Batch a visitation order. ``perm``: (n,) row ids (any integer dtype).

    ``tail="wrap"`` -> (steps, batch) ids;
    ``tail="mask"`` -> ((steps, batch) ids, (steps, batch) bool validity).
    ``batch_size`` is clamped to n; steps = ceil(n / batch).
    """
    if tail not in ("wrap", "mask"):
        raise ValueError(f"unknown tail semantics {tail!r}")
    perm = np.asarray(perm)
    n = perm.shape[0]
    if n == 0:
        raise ValueError("empty permutation")
    bs = min(batch_size, n)
    steps = -(-n // bs)  # ceil
    pad = steps * bs - n
    ids = np.concatenate([perm, perm[:pad]]) if pad else perm
    ids = ids.reshape(steps, bs)
    if tail == "wrap":
        return ids
    valid = np.ones(steps * bs, bool)
    if pad:
        valid[n:] = False
    return ids, valid.reshape(steps, bs)
