"""Generation entry points and the serving session.

Counterpart of ``repro.core.runtime`` on one device:
  - ``generate`` / ``generate_grouped``: one prefill, then ``decode_scan``'s
    loop of ``max_new`` decode steps. Both run on ``device`` ("cuda" unless
    the caller asks for "cpu"); params and pool must already live there. On
    a CUDA device the grouped skip-sum goes through the hand-written
    kernels, on the CPU through their plain versions.
  - ``SessionRuntime``: the serving part of the reference's session, which
    the request scheduler needs: an ``AdapterPool``, batch-level ``serve``,
    the paged KV pool and radix prefix index, and the request-level front
    door (``attach_scheduler`` / ``enqueue_serve`` / ``drain``).

Eager PyTorch needs no compiled-function cache. Not ported yet (slice 5 of
the port, and slice 7 for meshes): ``ingest`` / ``adapt`` / ``enqueue_ingest``
and the cache engine behind them, checkpoints, the control plane, more than
one shard, pipelined admission and ``decode_fuse``.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Optional, Sequence

import torch

from repro_torch.models.lm import (
    decode_scan,
    init_serve_caches,
    sample_token,
    serve_prefill,
    serve_prefill_grouped,
)

Params = Any


def _on_device(params: Params, tokens, device) -> tuple[torch.Tensor, torch.device]:
    device = torch.device(device)
    table = params["embed"]["table"]
    if table.device.type != device.type:
        raise ValueError(f"params live on {table.device}, generation asked for {device}")
    return torch.as_tensor(tokens, device=table.device), table.device


@torch.no_grad()
def generate(
    params: Params,
    cfg,
    tokens,
    *,
    max_new: int,
    adapters_stack: Optional[list[Params]] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """Batched generation with optional single-stack adapters (per-layer
    list, see ``lm_skiplora.adapters_to_stack``). Returns (B, max_new)."""
    tokens, dev = _on_device(params, tokens, device)
    b, s = tokens.shape
    caches = init_serve_caches(cfg, b, s + max_new, device=dev)
    logits, caches = serve_prefill(params, cfg, tokens, caches, adapters=adapters_stack)
    tok0 = sample_token(logits, temperature, generator)
    toks, _ = decode_scan(
        params, cfg, tok0, s, caches, max_new=max_new, temperature=temperature,
        generator=generator, adapters=adapters_stack,
    )
    return toks


@torch.no_grad()
def generate_grouped(
    params: Params,
    cfg,
    tokens,
    pools: dict[str, torch.Tensor],
    idx: torch.Tensor,
    *,
    max_new: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """Multi-tenant generation: batch row b decodes under adapter slot
    ``idx[b]`` of the stacked pool (float or int8 layout, see
    ``AdapterPool.pools()``). One grouped skip-sum launch for the prefill and
    one per decode step: ``1 + max_new`` per call. Returns (B, max_new)."""
    tokens, dev = _on_device(params, tokens, device)
    b, s = tokens.shape
    caches = init_serve_caches(cfg, b, s + max_new, device=dev)
    logits, caches = serve_prefill_grouped(params, cfg, tokens, caches, pools, idx)
    tok0 = sample_token(logits, temperature, generator)
    toks, _ = decode_scan(
        params, cfg, tok0, s, caches, max_new=max_new, temperature=temperature,
        generator=generator, pools=pools, idx=idx,
    )
    return toks


class SessionRuntime:
    """One-device serving session over one adapter pool.

    ``max_tenants`` sizes the pool (``max_tenants + 1`` slots, slot 0 pinned
    zero); ``pool_compress`` picks its layout (None, "int8",
    "int4", "nf4"). The kernels are picked by the device: on a CUDA device
    the grouped skip-sum and the scheduler's prefix-reuse gather (K10) run
    their kernels, on the CPU their plain versions. ``seed`` derives the per-call sampling generators. ``params``
    must live on ``device``."""

    def __init__(
        self,
        cfg,
        sl,
        params,
        *,
        max_tenants: int,
        pool_compress: Optional[str] = None,
        decode_fuse: bool = False,
        seed: int = 0,
        mesh=None,
        placement_shards: Optional[int] = None,
        pipeline_stages: int = 0,
        device="cuda",
    ):
        from repro_torch.core.adapter_pool import AdapterPool

        if mesh is not None or (placement_shards or 1) != 1:
            raise NotImplementedError(
                "a mesh or more than one shard is not ported (slice 5, with multiple GPUs "
                "in slice 7): the port's session runs on one device"
            )
        if pipeline_stages:
            raise NotImplementedError(
                "pipeline_stages is not ported (slice 5, with multiple GPUs in slice 7): "
                "pipelined admission needs a mesh"
            )
        if decode_fuse:
            raise NotImplementedError(
                "decode_fuse=True is not ported (slice 5): the decode skip term goes "
                "through the grouped kernels"
            )
        self.cfg, self.sl = cfg, sl
        self.max_tenants = max_tenants
        self.seed = seed
        self.device = torch.device(device)
        if params["embed"]["table"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed']['table'].device}, the session on {self.device}")
        self.params = params
        self.pool = AdapterPool(max_tenants + 1, cfg, sl.rank, compress=pool_compress, device=self.device)
        self._serve_calls = 0
        self._scheduler = None
        #: The scheduler's prefix-reuse state, built lazily by ``kv_pool()``,
        #: so reuse-off sessions pay nothing.
        self._kv_pool = None
        self._prefix_index = None
        self.counters = Counter()

    def _generator(self, n: int) -> torch.Generator:
        """Counter-derived generator: call ``n`` of an identically seeded
        session draws the same numbers, two calls never share a stream."""
        return torch.Generator(device=self.device).manual_seed((self.seed << 32) + n)

    # -- paged KV prefix cache ----------------------------------------------

    def kv_pool(self, *, block: Optional[int] = None, n_blocks: Optional[int] = None):
        """The paged KV block pool, built on first call. ``block`` is the
        pool's identity: asking again for another block size raises (tables
        and radix paths are block-granular). ``n_blocks`` sizes the first
        call and is ignored once the pool exists."""
        from repro_torch.core.kv_pool import KVBlockPool, get_default_block

        pool = self._kv_pool
        if pool is not None:
            if block is not None and int(block) != pool.block:
                raise ValueError(f"kv pool already built with block={pool.block}; requested {block}")
            return pool
        if n_blocks is None:
            raise ValueError("the first kv_pool() call must size it (n_blocks)")
        self._kv_pool = KVBlockPool(
            self.cfg, n_blocks=int(n_blocks), block=int(block) if block else get_default_block(),
            device=self.device,
        )
        return self._kv_pool

    def prefix_index(self):
        from repro_torch.core.prefix_index import RadixPrefixIndex

        if self._prefix_index is None:
            if self._kv_pool is None:
                raise ValueError("prefix_index() needs kv_pool(...) built first")
            self._prefix_index = RadixPrefixIndex(self._kv_pool)
        return self._prefix_index

    def reset_prefix_cache(self) -> None:
        """Forget every pooled prefix: radix tree cleared, pool refcounts
        zeroed, generation bumped so in-flight handles turn stale."""
        if self._prefix_index is not None:
            self._prefix_index.reset()
        elif self._kv_pool is not None:
            self._kv_pool.reset()

    def check_prefix_no_leaks(self) -> None:
        """Drained-state ref invariant, raised on violation: every held
        block is owned by exactly one radix node and nothing else (no
        in-flight refs survive a drain; free + held == n_blocks)."""
        pool, idx = self._kv_pool, self._prefix_index
        if pool is None:
            return
        pool.check_no_leaks(idx.n_nodes() if idx is not None else 0)
        extra = int(pool.refs.sum()) - int((pool.refs > 0).sum())
        if extra:
            raise RuntimeError(f"kv pool: {extra} in-flight ref(s) outstanding after drain")

    # -- events --------------------------------------------------------------

    @torch.no_grad()
    def serve(
        self,
        tenants: Sequence,
        prompts,
        *,
        max_new: int,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Generation for a mixed-tenant batch: row b decodes under
        ``tenants[b]``'s pool slot (``None`` -> base model). A batch of base
        rows only goes through ``generate``, any other through
        ``generate_grouped`` over the pool. Returns (B, max_new)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        if len(tenants) != prompts.shape[0]:
            raise ValueError(f"{len(tenants)} tenants for batch {prompts.shape[0]}")
        if generator is None:
            generator = self._generator(self._serve_calls)
        self._serve_calls += 1
        if all(t is None for t in tenants):
            path = "serve/single/base"
            toks = generate(self.params, self.cfg, prompts, max_new=max_new,
                            temperature=temperature, generator=generator, device=self.device)
        else:
            path = f"serve/grouped/{'int8' if self.pool.compress == 'int8' else 'float'}"
            toks = generate_grouped(
                self.params, self.cfg, prompts, self.pool.pools(), self.pool.lookup(tenants),
                max_new=max_new, temperature=temperature, generator=generator, device=self.device,
            )
        self.counters[path] += 1
        self.counters["serve/tokens"] += int(toks.numel())
        return toks

    def ingest(self, tenant, tokens, labels):
        raise NotImplementedError("SessionRuntime.ingest is not ported (slice 5: the session runtime)")

    def adapt(self, *args, **kwargs):
        raise NotImplementedError("SessionRuntime.adapt is not ported (slice 5: the session runtime)")

    # -- request-level surface (continuous batching; core.scheduler) ---------

    def attach_scheduler(self, **kw):
        """Construct the session's ``RequestScheduler`` with explicit limits
        (see ``core.scheduler.RequestScheduler``). ``serve`` stays available
        beside it: the scheduler is a front door, not a replacement."""
        from repro_torch.core.scheduler import RequestScheduler

        if self._scheduler is not None:
            raise RuntimeError("session already has a scheduler attached")
        self._scheduler = RequestScheduler(self, **kw)
        return self._scheduler

    @property
    def scheduler(self):
        """The attached scheduler (default limits if never configured)."""
        if self._scheduler is None:
            self.attach_scheduler()
        return self._scheduler

    def enqueue_serve(self, tenant, prompt, *, max_new: int, temperature: float = 0.0):
        """Queue one generation request; returns its ``Request`` future. Pump
        with ``drain()`` or ``scheduler.step()``."""
        return self.scheduler.submit(tenant, prompt, max_new=max_new, temperature=temperature)

    def enqueue_ingest(self, tenant, tokens, labels):
        raise NotImplementedError(
            "SessionRuntime.enqueue_ingest is not ported (slice 5: the session runtime)"
        )

    def drain(self):
        """Run the scheduler until every queued request completes."""
        return self.scheduler.drain()

