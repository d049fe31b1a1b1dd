"""Paged KV-cache block gather: the counterpart of
``repro.kernels.flash_attn.paged``.

The paged KV pool (``core.kv_pool``) stores key/value blocks as
``(n_blocks, block, n_kv, head_dim)``, here with a leading layer axis
``(L, n_blocks, block, n_kv, head_dim)`` so one call gathers every layer
(the reference maps its gather over the period leaves with ``jax.vmap``).
A request addresses its prefix through an ordered *block table* of pool
ids; the gather materialises a batch of tables into contiguous per-row K/V,
the admission path's "zero prefill FLOPs" move: reused prefix keys are
copied, never recomputed.

Two implementations with one contract, bitwise equal (data movement, no
arithmetic):

  - ``paged_gather_ref``: ``index_select`` over the block axis, the plain
    version, run on CPU tensors and held against the CUDA kernel on the card;
  - ``paged_gather``: the hand-written CUDA kernel (K10,
    ``csrc/paged_gather.cu``, which replaces
    ``repro/kernels/flash_attn/paged.py::paged_gather``), built by ``nvcc``
    for ``sm_90a`` at first use (``kernels/build.py``) and bound with
    ``ctypes``; it counts its launches in ``LAUNCHES``.

``gather`` is the dispatch the serve path calls.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels.build import I, KernelLib, P, check, check_tensor

CSRC = Path(__file__).resolve().parent / "csrc"
#: kernel name -> its source file under csrc/
SOURCES = {"paged_gather": "paged_gather.cu"}
LIB = KernelLib(CSRC, SOURCES, {"paged_gather": [P] * 3 + [I] * 4 + [P]})

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = LIB.launches
reset_launches = LIB.reset_launches
build = LIB.build

#: pool element types K10 takes (it copies bytes, so any would do; these are
#: the KV cache types of the serve path and the tests)
DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def paged_gather_ref(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Plain version: pool ([L,] NB, block, n_kv, hd) + tables (B, T) int ->
    ([L,] B, T * block, n_kv, hd). Table entries must be valid pool ids;
    rows that own fewer than T blocks pad with any valid id (the caller
    masks the padded positions out of attention)."""
    b, t = tables.shape
    lead = tuple(pool.shape[:-4])
    _, blk, nkv, hd = pool.shape[-4:]
    out = pool.index_select(pool.dim() - 4, tables.reshape(-1))
    return out.reshape(lead + (b, t * blk, nkv, hd))


def paged_gather(
    pool: torch.Tensor,     # (NB, block, n_kv, hd) or (L, NB, block, n_kv, hd)
    tables: torch.Tensor,   # (B, T) int32 pool block ids
) -> torch.Tensor:
    """K10 on the card -> (B, T * block, n_kv, hd), or (L, B, T * block,
    n_kv, hd) with a leading layer axis: one launch gathers every layer.
    Checks device, contiguity and types; never reads table values on the
    host (no sync). The kernel writes zeros for an id outside [0, NB) rather
    than read outside the pool."""
    check(pool.dim() in (4, 5), f"pool must be (NB, block, n_kv, hd) or (L, NB, block, n_kv, hd), "
          f"not {tuple(pool.shape)}")
    check(tables.dim() == 2, f"tables must be (B, T), not {tuple(tables.shape)}")
    check_tensor(pool, "pool", pool.device, pool.shape, DTYPES)
    check_tensor(tables, "tables", pool.device, tables.shape, (torch.int32,))
    lead = tuple(pool.shape[:-4])
    nb, blk, nkv, hd = pool.shape[-4:]
    b, t = tables.shape
    out = torch.empty(lead + (b, t * blk, nkv, hd), dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    LIB.launch("paged_gather", pool, pool.data_ptr(), tables.data_ptr(), out.data_ptr(),
               lead[0] if lead else 1, nb, b * t, blk * nkv * hd * pool.element_size())
    return out


def gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Block-table gather for the serve path, routed by the pool's device: a
    CPU tensor goes to the plain version, a CUDA tensor launches K10 (or
    raises), any other device raises."""
    if pool.device.type == "cpu":
        return paged_gather_ref(pool, tables)
    if pool.device.type != "cuda":
        raise ValueError(f"paged gather runs on cpu or cuda, not {pool.device}")
    return paged_gather(pool, tables)
