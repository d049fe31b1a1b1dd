"""Paged KV block pool: the serve-path analog of the Skip-Cache.

Counterpart of ``repro.core.kv_pool`` (a session keeps one a shard). Skip2-LoRA's thesis is
cache-to-skip-compute: pay for a forward once, then reuse its intermediate
state instead of recomputing it. The adapt path does it with cached
activations; this module does it for *prefill*: a fixed pool of KV blocks
(vLLM-style paged layout) that the request scheduler's radix prefix index
(``core.prefix_index``) maps token prefixes onto, so an admitted prompt
whose prefix is already pooled copies blocks instead of running the
backbone over them.

Layout
------
The device data plane is two bf16 tensors, K and V of every layer stacked:
``{"k", "v"}: (L, n_blocks, block, n_kv, hd)`` (the reference keeps its
periods/remainder tree of serve caches with the batch axis read as the
block axis; ``convert.stacked_to_reference`` maps one to the other). So one
gather (K10) moves a table's blocks of every layer at once, and a reuse wave
costs two launches, K and V, not two per layer. The live caches it
publishes from are ``models.lm.init_stacked_caches``' tensors, (L, B, S,
n_kv, hd).

Control plane (host-side, like the AdapterPool's slot table):

  - ``refs[i]``: reference count per block. The radix index holds one ref
    per indexed block; every in-flight admission that reused the block
    holds one more. 0 <=> on the free list.
  - ``free``: LIFO free list (allocation order is deterministic).
  - ``version``: bumped on every data-plane write (publish/copy/reset).
  - ``generation``: bumped on reset. Block-id handles carry the generation
    they were minted under; stale handles no-op on release instead of
    corrupting a reborn block's refcount.

Copy-on-write rule: pooled blocks are IMMUTABLE while shared. Live rows
decode into private dense cache rows, so divergence materialises privately;
``copy_block`` is the primitive for any in-pool writer: it returns the
block itself when exclusively held and a fresh copy when shared, moving the
caller's ref.

Checkpoint plane: ``state_arrays`` (the port's own ``{"k", "v"}`` layout;
``convert.session_from_reference`` maps the reference's periods/remainder
capture onto it), ``state_meta`` and ``load_state``, which the session
runtime's ``session_state`` / ``load_session_state`` carry.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attn import paged
from repro_torch.models.tp import whole

#: Fallback block size (tokens per KV block); ``set_default_block``
#: installs another as the process-wide default (resolved at pool
#: construction).
DEFAULT_BLOCK = 8

_DEFAULT: dict = {"block": None}


def set_default_block(block: Optional[int]) -> None:
    """Install a block size as the process-wide default (``None`` resets to
    ``DEFAULT_BLOCK``)."""
    if block is not None and block < 1:
        raise ValueError(f"kv block {block} must be >= 1")
    _DEFAULT["block"] = block


def get_default_block() -> int:
    return _DEFAULT["block"] or DEFAULT_BLOCK


class KVPoolExhausted(RuntimeError):
    """Allocation failed even after the caller's eviction pass."""


def gather_blocks(
    data: dict[str, torch.Tensor], tables: torch.Tensor, *, use_kernel: bool = False
) -> dict[str, torch.Tensor]:
    """Gather a batch of block tables (B, T) int32 out of the pool: each of
    K and V (L, NB, block, n_kv, hd) -> (L, B, T * block, n_kv, hd), one
    ``paged.gather`` each with ``use_kernel=True`` (K10 on a CUDA pool), its
    plain version on any device otherwise, the reference's default. Padded
    table entries must be valid ids (callers mask the padded key
    positions)."""
    if not use_kernel:
        return {n: paged.paged_gather_ref(x, tables) for n, x in data.items()}
    return {n: paged.gather(x, tables) for n, x in data.items()}


class KVBlockPool:
    """One device's paged KV block pool (device data + host accounting)."""

    def __init__(self, cfg, *, n_blocks: int, block: int, device="cuda"):
        from repro_torch.models.blocks import require_attention

        require_attention(cfg, "a paged KV pool")
        if n_blocks < 1 or block < 1:
            raise ValueError(f"kv pool needs n_blocks, block >= 1; got {n_blocks}, {block}")
        self.cfg = cfg
        self.n_blocks = int(n_blocks)
        self.block = int(block)
        self.device = torch.device(device)
        # bf16, the serve caches' type (models.lm.init_stacked_caches)
        shape = (cfg.n_layers, self.n_blocks, self.block, cfg.n_kv_heads, cfg.resolved_head_dim)
        self.data = {n: torch.zeros(shape, dtype=torch.bfloat16, device=self.device) for n in ("k", "v")}
        self.refs = np.zeros((self.n_blocks,), np.int32)
        #: LIFO over descending ids so allocation pops block 0 first.
        self.free: list[int] = list(range(self.n_blocks - 1, -1, -1))
        self.version = 0
        self.generation = 0
        self.counters: Counter = Counter()

    # -- accounting ----------------------------------------------------------

    def n_free(self) -> int:
        return len(self.free)

    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` free blocks (ref = 1 each). Raises ``KVPoolExhausted``
        when the free list is short: the caller (prefix index) evicts
        unreferenced radix leaves and retries."""
        if n > len(self.free):
            raise KVPoolExhausted(
                f"kv pool needs {n} blocks, {len(self.free)} free of {self.n_blocks}"
            )
        ids = [self.free.pop() for _ in range(n)]
        self.refs[ids] += 1
        self.counters["alloc"] += n
        return ids

    def ref(self, ids) -> None:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return
        if np.any(self.refs[ids] <= 0):
            raise RuntimeError(f"ref of unallocated kv block(s) {ids.tolist()}")
        self.refs[ids] += 1

    def deref(self, ids, generation: Optional[int] = None) -> None:
        """Drop one reference per id; blocks hitting zero return to the
        free list. A ``generation`` older than the pool's means the handle
        predates a reset: released silently (the block it named no longer
        exists)."""
        if generation is not None and generation != self.generation:
            self.counters["stale_release"] += 1
            return
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return
        if np.any(self.refs[ids] <= 0):
            raise RuntimeError(f"deref of free kv block(s) {ids.tolist()}")
        self.refs[ids] -= 1
        freed = [int(i) for i in ids if self.refs[i] == 0]
        self.free.extend(sorted(freed, reverse=True))
        self.counters["freed"] += len(freed)

    def check_no_leaks(self, expected_held: int) -> None:
        """Ref-count invariant: free-list + held == n_blocks, and
        ``expected_held`` (what the radix index, plus any in-flight rows,
        accounts for) blocks are held."""
        held = int((self.refs > 0).sum())
        if held + len(self.free) != self.n_blocks:
            raise RuntimeError(
                f"kv pool leak: {held} held + {len(self.free)} free != {self.n_blocks}"
            )
        if held != expected_held:
            raise RuntimeError(f"kv pool leak: {held} blocks held, expected {expected_held}")

    def reset(self) -> None:
        """Forget every block (refcounts to zero, full free list). The data
        stays on the device, unreachable. Bumps ``generation`` so outstanding
        handles no-op on release."""
        self.refs[:] = 0
        self.free = list(range(self.n_blocks - 1, -1, -1))
        self.version += 1
        self.generation += 1

    # -- data plane ----------------------------------------------------------

    def publish(self, caches: dict[str, torch.Tensor], row: int, ids, slots) -> None:
        """Copy live cache row ``row``'s prompt blocks into the pool: block
        ``slots[j]`` of the row (token span [slots[j] * block, (slots[j] + 1)
        * block)) lands in pool block ``ids[j]``, for every layer. ``caches``
        are stacked live caches {"k", "v"}: (L, B, S, n_kv, hd), whole or
        split by heads or by sequence over a model group (``tp.HeadSplit``,
        gathered onto the pool's device). One gather and one indexed write per tensor."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        slots = np.asarray(slots, np.int64).reshape(-1)
        if ids.size == 0:
            return
        m, blk = int(ids.size), self.block
        cols = (slots[:, None] * blk + np.arange(blk)[None]).reshape(-1)
        cols_t, ids_t = (torch.as_tensor(x, device=self.device) for x in (cols, ids))
        for n, pool in self.data.items():
            src = whole(caches[n][:, int(row)]).index_select(1, cols_t)  # (L, m * blk, n_kv, hd)
            pool[:, ids_t] = src.reshape(src.shape[0], m, blk, *src.shape[2:]).to(pool.dtype)
        self.version += 1
        self.counters["published"] += m

    def copy_block(self, src: int) -> int:
        """Copy-on-write primitive: exclusive blocks are returned as-is;
        shared blocks are duplicated into a fresh allocation and the
        caller's reference moves to the copy."""
        if self.refs[src] < 1:
            raise RuntimeError(f"copy_block of free block {src}")
        if self.refs[src] == 1:
            return src
        dst = self.alloc(1)[0]
        for pool in self.data.values():
            pool[:, dst] = pool[:, src]
        self.deref([src])
        self.version += 1
        self.counters["cow_copies"] += 1
        return dst

    # -- checkpoint ----------------------------------------------------------

    def state_arrays(self) -> dict[str, torch.Tensor]:
        """The data plane, {"k", "v"}: (L, n_blocks, block, n_kv, hd) bf16."""
        return dict(self.data)

    def state_meta(self) -> dict:
        return {
            "n_blocks": self.n_blocks,
            "block": self.block,
            "refs": [int(r) for r in self.refs],
            "free": list(self.free),
            "version": self.version,
        }

    def load_state(self, arrays: dict, meta: dict) -> None:
        """Restore a ``state_arrays`` / ``state_meta`` capture of a pool of
        the same size: the data lands on this pool's device in bf16; refs and
        free list as saved (the radix index's ``load_state`` then recomputes
        them from its tree); ``version`` and ``generation`` move."""
        if (int(meta["n_blocks"]), int(meta["block"])) != (self.n_blocks, self.block):
            raise ValueError(
                f"checkpoint kv pool ({meta['n_blocks']} x {meta['block']}) "
                f"!= this pool ({self.n_blocks} x {self.block}): restore "
                "requires an identically-sized block pool"
            )
        for n, cur in self.data.items():
            arr = torch.as_tensor(arrays[n])
            if tuple(arr.shape) != tuple(cur.shape):
                raise ValueError(f"kv pool {n}: {tuple(arr.shape)} != {tuple(cur.shape)}")
            cur.copy_(arr.to(cur.dtype))
        self.refs = np.asarray(meta["refs"], np.int32).copy()
        self.free = [int(i) for i in meta["free"]]
        self.version += 1
        self.generation += 1
