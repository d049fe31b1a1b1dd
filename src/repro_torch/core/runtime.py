"""Generation entry points and the session runtime: serve + ingest + adapt.

Counterpart of ``repro.core.runtime``:
  - ``generate`` / ``generate_grouped``: one prefill, then ``decode_scan``'s
    ``max_new`` decode steps, CUDA-graph replays of ``unroll`` steps each on
    the card (``core.decode_graph``). Both run on ``device`` ("cuda" unless
    the caller asks for "cpu"); params and pool must already live there. On
    a CUDA device the grouped skip-sum goes through the hand-written
    kernels, on the CPU through their plain versions. ``generate_loop`` is
    the eager per-token loop the replays are held against.
  - ``SessionRuntime``: the continual-learning session over a
    ``ShardedAdapterPool`` and one ``TieredCacheEngine`` per logical shard
    (the shard's tenants' skip-cache partitions), processing an interleaved
    event stream:
      - ``serve(tenants, prompts)``: generation routed per batch, the
        single-stack path when every row is the base model, the grouped one
        otherwise, one dispatch per shard with rows;
      - ``ingest(tenant, tokens, labels)``: a populate forward that writes
        the tenant's cache partition and returns its last-position adapted
        logits (``models.lm.ingest_prefill``): ingestion doubles as serving;
      - ``adapt(tenants, epochs)``: cached fleet epochs over the grouped
        trainable sums, with no backbone compute, then one batched
        write-back into the pool (``register_many``) and a pin on every
        trained slot. The cache already holds what the populate forward
        saw, so a serve -> ingest -> adapt -> serve session reproduces the
        offline ``fleet_finetune`` adapters and losses bitwise in mode
        ``full`` with an fp32 cache;
      - the request-level front door (``attach_scheduler`` /
        ``enqueue_serve`` / ``enqueue_ingest`` / ``drain``), the paged KV
        pool and the radix prefix index of the request scheduler;
      - with a ``ControlConfig``, shadow eval, a gated write-back and
        rollback (``core.control_plane``);
      - the checkpoint plane: ``session_state`` / ``load_session_state``
        capture and restore the whole session (adapters and optimizer
        moments, the pool, every cached row, the control plane, the paged KV
        pool with its radix tree) in the reference's manifest layout, which
        ``checkpoint.save_runtime_session`` writes to disk.

Batch planning goes through ``core.batch_plan`` with explicit tenant
partitions, so an ``adapt`` group that is a subset or a reordering of the
ingested tenants still replays each tenant's own order.

The data axis (``mesh=`` / ``placement_shards=``): tenants are placed on
logical shards, shard ``s`` lives on ``devices[s % n_devices]`` of a
data-only mesh (``runtime.sharding``), and no value crosses shards. One
process drives every device; each shard's serve, ingest, adapt and
scheduler dispatches run on its device, against its pool, engine and KV
pool. The logical layout travels in checkpoints, so a session restored onto
another device count continues bitwise.

The model axis (a mesh with ``model`` above 1): each logical shard's
backbone is one replica split over its model group (``models.tp``), its
dispatches run under the shard's ``ShardScope``, and with
``pipeline_stages`` the scheduler's admission prefill runs as GPipe
microbatches over the group's devices (``lm.pipeline_sched_prefill``).

The decode's CUDA graphs are cached in ``core.decode_graph``, the resident
adapt's epoch graphs per shard in the session (``core.cuda_graph.EpochGraph``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter, OrderedDict
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import batch_plan
from repro_torch.core import fleet_finetune as FF
from repro_torch.core import lm_skiplora as SL
from repro_torch.core.cache_engine import TieredCacheEngine
from repro_torch.core.control_plane import ControlConfig, ControlPlane
from repro_torch.core.cuda_graph import GraphCache
from repro_torch.models import tp as TP
from repro_torch.models.lm import (
    decode_loop,
    decode_scan,
    ingest_prefill,
    init_serve_caches,
    pipeline_stage_params,
    sample_token,
    serve_prefill,
    serve_prefill_grouped,
)
from repro_torch.optim.optimizers import OptState, adamw

Params = Any


def _on_device(params: Params, tokens, device) -> tuple[torch.Tensor, torch.device]:
    device = torch.device(device)
    home = TP.home_device(params)
    if home.type != device.type:
        raise ValueError(f"params live on {home}, generation asked for {device}")
    return torch.as_tensor(tokens, device=home), home


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
    unroll: int = 1,
    device="cuda",
) -> torch.Tensor:
    """Batched generation with optional single-stack adapters (per-layer
    list, see ``lm_skiplora.adapters_to_stack``): one prefill, then
    ``decode_scan``, whose ``max_new`` steps are CUDA-graph replays of
    ``unroll`` steps each on the card. ``params`` split over a model group
    (``models.tp``) keep each member's KV heads on its device and decode in
    eager steps. Returns (B, max_new)."""
    tokens, dev = _on_device(params, tokens, device)
    b, s = tokens.shape
    caches = init_serve_caches(cfg, b, s + max_new, device=dev, params=params)
    logits, caches = serve_prefill(params, cfg, tokens, caches, adapters=adapters_stack)
    tok0 = sample_token(logits, temperature, generator)
    toks, _ = decode_scan(
        params, cfg, tok0, s, caches, max_new=max_new, temperature=temperature,
        generator=generator, adapters=adapters_stack, unroll=unroll,
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
    use_kernel: bool = True,
    fuse_skip: bool = False,
    unroll: int = 1,
    device="cuda",
) -> torch.Tensor:
    """Multi-tenant generation: batch row b decodes under adapter slot
    ``idx[b]`` of the stacked pool (float, int8 or 4-bit layout, see
    ``AdapterPool.pools()``). One grouped skip-sum launch for the prefill and
    one per decode step: ``1 + max_new`` per call, the steps' inside
    CUDA-graph replays of ``unroll`` steps on the card. ``use_kernel=False``
    sums through the plain versions on any device; ``fuse_skip=True``
    computes the decode steps' skip term as dense per-row math (the prefill
    keeps the grouped kernel either way). A model group's ``params`` as in
    ``generate``. Returns (B, max_new)."""
    tokens, dev = _on_device(params, tokens, device)
    b, s = tokens.shape
    caches = init_serve_caches(cfg, b, s + max_new, device=dev, params=params)
    logits, caches = serve_prefill_grouped(params, cfg, tokens, caches, pools, idx, use_kernel=use_kernel)
    tok0 = sample_token(logits, temperature, generator)
    toks, _ = decode_scan(
        params, cfg, tok0, s, caches, max_new=max_new, temperature=temperature,
        generator=generator, pools=pools, idx=idx, use_kernel=use_kernel, fuse_skip=fuse_skip,
        unroll=unroll,
    )
    return toks


@torch.no_grad()
def generate_loop(
    params: Params,
    cfg,
    tokens,
    *,
    max_new: int,
    adapters_stack: Optional[list[Params]] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    pools: Optional[dict[str, torch.Tensor]] = None,
    idx: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
    fuse_skip: bool = False,
    device="cuda",
) -> torch.Tensor:
    """The per-token Python decode loop, the reference's ``generate_loop``:
    one prefill, then ``max_new`` eager steps (``decode_loop``), kept as
    what the CUDA-graph replays are held against. Single-stack, as the
    reference's; ``pools``/``idx`` run ``generate_grouped``'s prefill and
    steps instead, so the grouped path has its loop too. Returns
    (B, max_new)."""
    tokens, dev = _on_device(params, tokens, device)
    b, s = tokens.shape
    caches = init_serve_caches(cfg, b, s + max_new, device=dev, params=params)
    if pools is not None:
        logits, caches = serve_prefill_grouped(params, cfg, tokens, caches, pools, idx, use_kernel=use_kernel)
    else:
        logits, caches = serve_prefill(params, cfg, tokens, caches, adapters=adapters_stack)
    tok0 = sample_token(logits, temperature, generator)
    toks, _ = decode_loop(
        params, cfg, tok0, s, caches, max_new=max_new, temperature=temperature, generator=generator,
        adapters=adapters_stack, pools=pools, idx=idx, use_kernel=use_kernel, fuse_skip=fuse_skip,
    )
    return toks


def _stages_on(stages: list[list[Params]], devices) -> list[list[Params]]:
    """Stage i's layers on ``devices[i]`` (one copy of a layer a stage
    repeats as padding; the caller's own tensors where they already live)."""
    from repro_torch.runtime.sharding import _to

    out = []
    for stage, dev in zip(stages, devices):
        moved: dict[int, Params] = {}
        for layer in stage:
            if id(layer) not in moved:
                moved[id(layer)] = _to(layer, dev)
        out.append([moved[id(layer)] for layer in stage])
    return out


@dataclasses.dataclass
class TenantState:
    """Per-tenant continual-learning state the runtime keeps between
    events. ``adapters`` / ``opt_*`` are the tenant's slices of the stacked
    fleet trees (flat {"A": (L, D, R), "B": (L, R, D)} layout)."""

    partition: int                      # cache partition index
    n_ingested: int = 0                 # rows written into the partition
    epochs_done: int = 0                # position in the planner's epoch stream
    step: int = 0                       # optimizer step count
    adapters: Optional[Params] = None
    opt_mu: Optional[Params] = None
    opt_nu: Optional[Params] = None

    @property
    def trained(self) -> bool:
        return self.adapters is not None


class SessionRuntime:
    """One session engine for serve + ingest + adapt over a shared pool,
    on one device or over a (data, model) device mesh.

    ``max_tenants`` bounds the cache partitions (``samples_per_tenant`` rows
    each, global id = partition * samples_per_tenant + local id: the fleet
    trainer's convention, so offline and interleaved training address the
    same cache rows) at ``seq`` tokens a row. The pool defaults to
    ``max_tenants / shards + 1`` slots a shard (slot 0 pinned zero;
    ``pool_slots`` overrides the per-shard count) in the layout
    ``pool_compress`` picks (None, "int8", "int4", "nf4"). The engines
    default to fully device-resident; ``cache_capacity`` /
    ``hbm_budget_bytes`` (split evenly over the shards) force tiered
    placement (``cache_dir`` puts the host tier on disk, ``shard_{s}`` below
    it for each shard of a multi-shard session), which sends ``adapt`` down
    the streaming path instead of the resident one. ``lr`` / ``optimizer``
    train the adapters (AdamW at ``lr`` by default). ``seed`` derives the
    serve generators, the epoch plans and the default initial adapters.
    ``idx_memo_slots`` bounds the serve slot-index memo. ``control`` turns
    on the control plane.

    ``mesh`` (default: the one-device mesh of ``device``, "cuda" unless the
    caller asks for the CPU) supplies the devices; ``placement_shards`` fixes
    the *logical* shard count (default: the mesh's data size). Partition
    ``p`` belongs to shard ``p % shards``, shard ``s`` lives on
    ``devices[s % n_devices]``, and the backbone is one replica per distinct
    device (``params`` serve where they live). ``max_tenants`` must divide
    over the shards.

    A ``model`` axis above 1 gives each logical shard a group of devices
    holding ONE backbone replica split Megatron-style over them
    (``sharding.shard_backbone``, run by ``models.tp``): each device's
    backbone bytes drop about M-fold, and every serve, ingest, adapt and
    scheduler dispatch of the shard runs on its group. The KV caches of
    serving and the scheduler's live batch keep each member's KV heads, or
    its range of positions, on its device (``tp.HeadSplit``); the shard's pool, engine, adapters,
    moments and paged prefix pool live on the group's first device (the
    reference replicates them over the group).
    Such a session takes ``use_kernel=False`` (the skip-sums' plain
    versions) and decodes in eager steps. ``pipeline_stages=N`` (N == the
    model-axis size, a float pool) also splits each group's devices into N
    GPipe stages of whole layers (``lm.pipeline_stage_params``) for the
    scheduler's pipelined admission prefill. ``params`` may come split
    already (a ``tp.GroupParams`` over the devices of a mesh with one
    model group): a backbone no card can hold whole, drawn a layer at a
    time.

    ``use_kernel`` picks the skip-sum route of ``serve``, the scheduler,
    ``ingest`` and ``adapt``: the grouped wrappers (on a CUDA device the
    hand-written kernels K5-K9, which launch or raise; on the CPU their
    plain versions), or with ``False`` the plain versions and the
    ``blocked_skip_sum`` einsum, as the reference's flag does.
    ``decode_fuse=True`` computes the decode steps' skip term as dense
    per-row math instead of a grouped kernel launch (the prefills keep the
    kernel). ``params`` must live on a device of the session's type."""

    def __init__(
        self,
        cfg,
        sl: SL.SkipLoRAConfig,
        params,
        *,
        max_tenants: int,
        samples_per_tenant: int,
        seq: int,
        lr: float = 1e-3,
        optimizer=None,
        pool_slots: Optional[int] = None,
        pool_compress: Optional[str] = None,
        cache_capacity: Optional[int] = None,
        hbm_budget_bytes: Optional[int] = None,
        cache_dir: Optional[str] = None,
        use_kernel: bool = True,
        decode_fuse: bool = False,
        seed: int = 0,
        mesh=None,
        placement_shards: Optional[int] = None,
        pipeline_stages: int = 0,
        idx_memo_slots: int = 256,
        control: Optional[ControlConfig] = None,
        device=None,
    ):
        from repro_torch.core.adapter_pool import ShardedAdapterPool
        from repro_torch.runtime import sharding as SH

        if sl.mode not in ("full", "int8"):
            raise ValueError(f"the session runtime trains fleet modes 'full'/'int8', not {sl.mode!r}")
        if idx_memo_slots < 1:
            raise ValueError(f"idx_memo_slots {idx_memo_slots} < 1")
        self.cfg, self.sl = cfg, sl
        self.max_tenants = max_tenants
        self.samples_per_tenant = samples_per_tenant
        self.seq = seq
        self.use_kernel = use_kernel
        self.decode_fuse = decode_fuse
        self.seed = seed

        # -- the mesh and the logical shard layout --------------------------
        if mesh is None:
            mesh = SH.make_mesh((1,), ("data",), devices=[device if device is not None else "cuda"])
        elif device is not None and torch.device(device).type != SH.session_devices(mesh)[0].type:
            raise ValueError(f"device {device} != the mesh's {SH.session_devices(mesh)[0]}")
        self.mesh = mesh
        self.devices = SH.session_devices(mesh)
        n_groups, n_model, groups = SH.session_mesh_layout(mesh)
        self.model_parallel, self.pipeline_stages = n_model, int(pipeline_stages)
        self.n_shards = int(placement_shards) if placement_shards is not None else n_groups
        if self.n_shards < 1:
            raise ValueError(f"placement_shards {self.n_shards} < 1")
        if max_tenants % self.n_shards:
            raise ValueError(f"max_tenants {max_tenants} must divide over {self.n_shards} shards")
        if self.pipeline_stages:
            if self.pipeline_stages != n_model or n_model < 2:
                raise ValueError(
                    f"pipeline_stages={self.pipeline_stages} must equal the mesh's model-axis size ({n_model}, "
                    ">= 2): the stages repurpose each shard's tensor-parallel device group"
                )
            if pool_compress is not None:
                raise ValueError("pipeline serve reads the adapter pool per stage and needs the float layout: "
                                 "pool_compress must be None")
        self.device = self.devices[0]
        home = TP.home_device(params)
        if TP.is_group(params) and (n_groups != 1 or params.devices != groups[0] or self.pipeline_stages):
            raise ValueError("a backbone split beforehand (tp.GroupParams) serves a mesh of one model group over "
                             "its own devices, without pipeline_stages (which need the unsplit layers)")
        if any(d.type != home.type for g in groups for d in g):
            raise ValueError(f"params live on {home}, the session on {[[str(d) for d in g] for g in groups]}")
        #: shard -> its device (its group's first), its backbone replica and
        #: its model group as a ShardScope (None: one device)
        self._shard_device = [self.devices[s % n_groups] for s in range(self.n_shards)]
        if n_model > 1:
            # Each logical shard's group holds ONE backbone replica split
            # over its devices (models.tp); the hand-written grouped kernels
            # take whole tensors on one device, so the skip-sums of a split
            # session run their plain versions, as the reference's grouped
            # Pallas kernels do not partition over a model axis.
            if use_kernel:
                raise ValueError("the grouped skip-LoRA kernels do not run over a model axis; build "
                                 "(data, model) sessions with use_kernel=False")
            subs = [SH.shard_submesh(mesh, g) for g in range(n_groups)]
            self._scope = [SH.ShardScope(subs[s % n_groups]) for s in range(self.n_shards)]
            split = [params] if TP.is_group(params) else [TP.group_params(params, list(sm.devices)) for sm in subs]
            self._shard_params = [split[s % n_groups] for s in range(self.n_shards)]
        else:
            # a data-only mesh: every spec replicates, one replica a device
            assert SH.specs_all_replicated(SH.session_param_specs(params, mesh))
            self._scope = [None] * self.n_shards
            replicas = SH.replicate_backbone(params, self.devices)
            self._shard_params = [replicas[s % n_groups] for s in range(self.n_shards)]
        #: pipeline_stages: the same groups' devices as GPipe stages, stage i
        #: of group g's layers (unsplit) on its device i
        self._stage_blocks: list = [None] * self.n_shards
        self._stage_valid: list = [None] * self.n_shards
        if self.pipeline_stages:
            stages, valid = pipeline_stage_params(params, cfg, self.pipeline_stages)
            per_group = [_stages_on(stages, groups[g]) for g in range(n_groups)]
            for s in range(self.n_shards):
                self._stage_blocks[s], self._stage_valid[s] = per_group[s % n_groups], valid
        self.params = self._shard_params[0]
        self.optimizer = optimizer if optimizer is not None else adamw(lr)
        #: Opt-in control plane: with ``control=None`` the session plans,
        #: trains and writes back exactly the uncontrolled trajectory. With a
        #: ``ControlConfig`` every tenant's epochs skip its held-out rows,
        #: ``adapt`` computes the pre/post held-out loss in the same epoch
        #: call as training, and write-back is gated.
        self.control_cfg = control
        self.control = ControlPlane(control) if control is not None else None

        # -- per-shard engines, pool, partitions ----------------------------
        n = self.n_shards
        tenants_per_shard = max_tenants // n
        shard_samples = tenants_per_shard * samples_per_tenant
        if cache_capacity is None and hbm_budget_bytes is None:
            cache_capacity = shard_samples * n   # fully resident: the resident adapt path
        split = (lambda v: v) if n == 1 else (lambda v: max(1, v // n))
        self.engines = [
            TieredCacheEngine(
                shard_samples, SL.lm_cache_layout(cfg, sl, seq),
                capacity=None if cache_capacity is None else split(cache_capacity),
                hbm_budget_bytes=None if hbm_budget_bytes is None else split(hbm_budget_bytes),
                directory=cache_dir if cache_dir is None or n == 1 else f"{cache_dir}/shard_{s}",
                device=self._shard_device[s],
            )
            for s in range(n)
        ]
        self.engine = self.engines[0]
        self.pool = ShardedAdapterPool(
            pool_slots if pool_slots is not None else tenants_per_shard + 1, cfg, sl.rank, n_shards=n,
            devices=self._shard_device, compress=pool_compress,
            history=control.history_depth if control is not None else 0,
        )
        self._tenants: dict[Any, TenantState] = {}
        #: free cache partitions, partition p of shard p % shards; each
        #: shard pops its smallest first (``_add_tenant``)
        self._free_partitions = list(range(max_tenants - 1, -1, -1))
        #: per shard, the resident adapt path's id-indexed cache
        #: (``export_skipcache``), kept across adapt calls until the next
        #: ingest on the shard writes new rows
        self._export: list = [None] * n
        #: per shard, the resident adapt path's epoch graphs (captured on the
        #: shard's device over its export), freed with the export
        self._epoch_graphs = [GraphCache(capacity=8) for _ in range(n)]
        #: (shard, tenant tuple, shard pool version) -> slot-index tensor,
        #: LRU: repeated serve batches skip the host-to-device slot-index
        #: build, a slot-map change moves the version, and live traffic's
        #: unbounded orderings are capped at ``idx_memo_slots``
        #: (``counters`` keeps ``idx_memo/{hits,misses,evictions}``).
        self._idx_cache: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self._idx_cache_cap = int(idx_memo_slots)
        self._serve_calls = 0
        self._scheduler = None
        #: The scheduler's prefix-reuse state per shard, built lazily by
        #: ``kv_pool(shard, ...)``, so reuse-off sessions pay nothing.
        self._kv_pools: dict[int, Any] = {}
        self._prefix_indexes: dict[int, Any] = {}
        self.counters = Counter()

    def _group(self, shard: int) -> list[torch.device]:
        """The shard's model group's devices (its one device on a data-only
        mesh)."""
        params = self._shard_params[shard]
        return params.devices if TP.is_group(params) else [self._shard_device[shard]]

    def _on(self, shard: int):
        """The shard's device as the current CUDA device (a no-op on the
        CPU): its graphs capture and its kernels launch there."""
        dev = self._shard_device[shard]
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def _generator(self, n: int, shard: int = 0) -> torch.Generator:
        """Counter-derived generator of serve call ``n`` on ``shard``: an
        identically seeded session draws the same numbers, two calls or two
        shards never share a stream (one shard: call ``n``'s stream)."""
        return torch.Generator(device=self._shard_device[shard]).manual_seed(
            (self.seed << 32) + n * self.n_shards + shard)

    # -- shard arithmetic ----------------------------------------------------

    def _shard_of_partition(self, partition: int) -> int:
        return partition % self.n_shards

    def _local_ids(self, partition: int, rows) -> list[int]:
        """Global partition + partition-local row ids -> the shard engine's ids."""
        off = (partition // self.n_shards) * self.samples_per_tenant
        return [off + int(r) for r in rows]

    def _global_id(self, shard: int, local_id: int) -> int:
        part = (local_id // self.samples_per_tenant) * self.n_shards + shard
        return part * self.samples_per_tenant + local_id % self.samples_per_tenant

    # -- tenant bookkeeping --------------------------------------------------

    def tenant(self, tenant) -> TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        return st

    def _add_tenant(self, tenant) -> TenantState:
        shard = self.pool.place(tenant)
        free = self._free_partitions
        pick = next((i for i in range(len(free) - 1, -1, -1) if free[i] % self.n_shards == shard), None)
        if pick is None:
            where = "" if self.n_shards == 1 else f" of shard {shard}"
            raise RuntimeError(
                f"session full: all {self.max_tenants // self.n_shards} cache partitions{where} in use "
                f"({self.max_tenants} session-wide)"
            )
        st = TenantState(partition=free.pop(pick))
        self._tenants[tenant] = st
        return st

    def release(self, tenant) -> None:
        """Drop a tenant's training state and cache partition. Its pool slot,
        if any, stays registered but is unpinned, so LRU applies again; a
        tenant without a slot loses its shard placement too."""
        st = self._tenants.pop(tenant)
        self._free_partitions.append(st.partition)
        if self.pool.has(tenant):
            self.pool.unpin(tenant)
        else:
            self.pool.unplace(tenant)
        for idx in self._prefix_indexes.values():
            idx.drop_tenant(tenant)

    # -- paged KV prefix cache ----------------------------------------------

    def kv_pool(self, shard: int = 0, *, block: Optional[int] = None, n_blocks: Optional[int] = None):
        """The shard's paged KV block pool, built on its device at the first
        call. ``block`` is the pool's identity: asking again for another
        block size raises (tables and radix paths are block-granular).
        ``n_blocks`` sizes the first call and is ignored once the pool
        exists."""
        from repro_torch.core.kv_pool import KVBlockPool, get_default_block

        pool = self._kv_pools.get(shard)
        if pool is not None:
            if block is not None and int(block) != pool.block:
                raise ValueError(f"kv pool shard {shard} already built with block={pool.block}; requested {block}")
            return pool
        if n_blocks is None:
            raise ValueError(f"the first kv_pool() call of shard {shard} must size it (n_blocks)")
        pool = self._kv_pools[shard] = KVBlockPool(
            self.cfg, n_blocks=int(n_blocks), block=int(block) if block else get_default_block(),
            device=self._shard_device[shard],
        )
        return pool

    def prefix_index(self, shard: int = 0):
        from repro_torch.core.prefix_index import RadixPrefixIndex

        idx = self._prefix_indexes.get(shard)
        if idx is None:
            pool = self._kv_pools.get(shard)
            if pool is None:
                raise ValueError(f"prefix_index({shard}) needs kv_pool({shard}, ...) built first")
            idx = self._prefix_indexes[shard] = RadixPrefixIndex(pool)
        return idx

    def reset_prefix_cache(self) -> None:
        """Forget every pooled prefix on every shard: radix trees cleared,
        pool refcounts zeroed, generations bumped so in-flight handles turn
        stale."""
        for shard, pool in self._kv_pools.items():
            idx = self._prefix_indexes.get(shard)
            if idx is not None:
                idx.reset()
            else:
                pool.reset()

    def check_prefix_no_leaks(self) -> None:
        """Drained-state ref invariant on every shard, raised on violation:
        every held block is owned by exactly one radix node and nothing else
        (no in-flight refs survive a drain; free + held == n_blocks)."""
        for shard, pool in self._kv_pools.items():
            idx = self._prefix_indexes.get(shard)
            pool.check_no_leaks(idx.n_nodes() if idx is not None else 0)
            extra = int(pool.refs.sum()) - int((pool.refs > 0).sum())
            if extra:
                raise RuntimeError(f"kv pool shard {shard}: {extra} in-flight ref(s) outstanding after drain")

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
        unroll: int = 1,
    ) -> torch.Tensor:
        """Generation for a mixed-tenant batch: row b decodes under
        ``tenants[b]``'s pool slot (``None`` -> base model). A batch of base
        rows only goes through ``generate``, any other through
        ``generate_grouped`` over the pool with the session's ``use_kernel``
        and ``decode_fuse``; on the card ``unroll`` decode steps a CUDA-graph
        replay. On a multi-shard session the batch splits by slot shard:
        each shard decodes its rows against its own pool on its own device
        (base rows ride shard 0), from a generator of its own (drawn from
        ``generator`` when one is given), and the rows stitch back in order
        on shard 0's device. Returns (B, max_new)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        if len(tenants) != prompts.shape[0]:
            raise ValueError(f"{len(tenants)} tenants for batch {prompts.shape[0]}")
        call = self._serve_calls
        self._serve_calls += 1
        if all(t is None for t in tenants):
            path = "serve/single/base"
            with self._on(0):
                toks = generate(self.params, self.cfg, prompts, max_new=max_new, temperature=temperature,
                                generator=generator if generator is not None else self._generator(call),
                                unroll=unroll, device=self.device)
        else:
            path = f"serve/grouped/{'int8' if self.pool.compress == 'int8' else 'float'}"
            if self.n_shards == 1:
                toks = self._serve_shard(0, tenants, prompts, max_new=max_new, temperature=temperature,
                                         generator=generator if generator is not None else self._generator(call),
                                         unroll=unroll)
            else:
                base = None
                if generator is not None:
                    base = int(torch.randint(0, 1 << 62, (1,), generator=generator, device=generator.device))
                parts = []
                for s, (rows, subs) in enumerate(self.pool.route(tenants)):
                    if not rows:
                        continue
                    gen = self._generator(call, s) if base is None else \
                        torch.Generator(device=self._shard_device[s]).manual_seed(base + s)
                    sub = prompts[torch.tensor(rows, device=prompts.device)].to(self._shard_device[s])
                    parts.append((rows, self._serve_shard(s, subs, sub, max_new=max_new, temperature=temperature,
                                                          generator=gen, unroll=unroll)))
                    self.counters["serve/shard_dispatches"] += 1
                toks = None
                for rows, sub_toks in parts:   # dispatched above, gathered here
                    if toks is None:
                        toks = torch.empty((len(tenants), max_new), dtype=sub_toks.dtype, device=self.device)
                    toks[torch.tensor(rows, device=self.device)] = sub_toks.to(self.device)
        self.counters[path] += 1
        self.counters["serve/tokens"] += int(toks.numel())
        return toks

    def _serve_shard(self, s: int, tenants, prompts, *, max_new, temperature, generator, unroll) -> torch.Tensor:
        """Grouped decode of one shard's rows against its pool, on its
        device (on a one-shard session, the whole grouped path)."""
        key = (s, tuple(tenants), self.pool.shards[s].version)
        idx = self._idx_cache.get(key)
        if idx is None:
            self.counters["idx_memo/misses"] += 1
            while len(self._idx_cache) >= self._idx_cache_cap:
                self._idx_cache.popitem(last=False)
                self.counters["idx_memo/evictions"] += 1
            idx = self._idx_cache[key] = self.pool.lookup_local(s, tenants)
        else:
            self.counters["idx_memo/hits"] += 1
            self._idx_cache.move_to_end(key)
            self.pool.touch(tenants)   # recency still follows traffic
        with self._on(s):
            return generate_grouped(
                self._shard_params[s], self.cfg, prompts, self.pool.shard_pools(s), idx,
                max_new=max_new, temperature=temperature, generator=generator, use_kernel=self.use_kernel,
                fuse_skip=self.decode_fuse, unroll=unroll, device=self._shard_device[s],
            )

    @torch.no_grad()
    def ingest(self, tenant, tokens, labels) -> torch.Tensor:
        """Populate forward for new samples on the tenant's shard: writes the
        batch into the tenant's cache partition AND returns the last-position
        logits under the tenant's current adapters (the zero slot until its
        first ``adapt`` write-back): ingestion doubles as serving. tokens,
        labels: (B, seq). Returns (B, 1, V) logits on the shard's device."""
        # Validate before registering: a rejected batch must not leak a
        # cache partition or leave a tenant with nothing ingested.
        st = self._tenants.get(tenant)
        b, s = torch.as_tensor(tokens).shape
        if s != self.seq:
            raise ValueError(f"seq {s} != session cache layout seq {self.seq}")
        filled = st.n_ingested if st is not None else 0
        if filled + b > self.samples_per_tenant:
            raise ValueError(f"tenant {tenant!r} partition full: {filled}+{b} > {self.samples_per_tenant}")
        if st is None:
            st = self._add_tenant(tenant)
        shard = self._shard_of_partition(st.partition)
        dev = self._shard_device[shard]
        tokens = torch.as_tensor(tokens, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        with self._on(shard):
            idx = self.pool.lookup_local(shard, [tenant if self.pool.has(tenant) else None] * b)
            logits, acts, y_base = ingest_prefill(
                self._shard_params[shard], self.cfg, tokens, self.pool.shard_pools(shard), idx,
                use_kernel=self.use_kernel,
            )
            values = SL._encode_acts(acts, None, self.sl)
            values["y_base"] = y_base
            values["labels"] = labels
            self.engines[shard].write(self._local_ids(st.partition, range(st.n_ingested, st.n_ingested + b)),
                                      values)
        self._export[shard] = None   # new rows: the resident path's export is stale
        self._epoch_graphs[shard].clear()   # and the graphs captured over it
        st.n_ingested += b
        self.counters["ingest/rows"] += b
        return logits

    def adapt(
        self,
        tenants: Optional[Sequence] = None,
        *,
        epochs: int = 1,
        batch_per_tenant: int = 4,
        generator: Optional[torch.Generator] = None,
    ) -> dict:
        """Cached fleet epochs over the tenants' ingested partitions (every
        ingested tenant by default), then one batched write-back into the
        pool (``register_many``) and a pin on every trained slot.

        Tenants new to training draw their initial adapters from
        ``generator`` (on any device, the draw then moves to the shard's;
        default: seeded from ``seed`` on the session's first device) as
        ``fleet_finetune`` does (``init_fleet_adapters`` row i ->
        i-th new tenant in call order), and the planner replays each
        tenant's own order, so a fresh session's first ``adapt`` reproduces
        the offline trainer. Tenants are grouped by (optimizer step, epoch
        position, partition fill, shard): only tenants on one trajectory can
        share the stacked optimizer's step count, and only tenants of one
        shard share a device. Every group runs on its shard's device; the
        losses come to the host after every group has been issued.

        The engine's placement picks the path: fully resident -> "scan" (the
        epochs read an id-indexed export of the cache; on the card they are
        replays of graphs the session keeps per shard, captured on the
        shard's device and freed when an ingest makes the export stale),
        tiered -> "stream" (``fleet_cached_epoch_via_engine``, eager steps).
        Every group's epochs are issued before the first write-back, so the
        shards' replays go out back to back. A model group's epochs stay
        eager. Returns {"losses": {tenant: (epochs, steps) np.ndarray},
        "groups": [tenant lists], "path"}."""
        order = list(self._tenants) if tenants is None else list(tenants)
        if not order:
            raise ValueError("no tenants to adapt")
        for t in order:
            if self.tenant(t).n_ingested == 0:
                raise ValueError(f"tenant {t!r} has no ingested samples")

        fresh = [t for t in order if not self.tenant(t).trained]
        if fresh:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(self.seed)
            stacked0 = {k: v.to(self.device) for k, v in
                        FF.init_fleet_adapters(generator, self.cfg, self.sl, len(fresh)).items()}
            opt0 = self.optimizer.init(stacked0)
            for i, t in enumerate(fresh):
                st = self.tenant(t)
                st.adapters = _slice(stacked0, i)
                st.opt_mu, st.opt_nu = _slice(opt0.mu, i), _slice(opt0.nu, i)
                st.step = 0

        groups: dict[tuple, list] = {}
        for t in order:
            st = self.tenant(t)
            groups.setdefault((st.step, st.epochs_done, st.n_ingested, self._shard_of_partition(st.partition)),
                              []).append(t)
        # Every group's epochs are issued before any write-back: a write-back
        # uploads slot ids and the gate reads losses, each a wait for the
        # device, so the shards' epochs run back to back, and overlap on
        # separate devices. No group's epochs read the pool or another
        # group's tenants, so the order changes nothing they compute.
        pending = []
        for (step0, epoch0, spt, shard), group in groups.items():
            with self._on(shard):
                pending.append(self._adapt_epochs(
                    group, spt, shard, epochs=epochs, epoch0=epoch0, step0=step0,
                    batch_per_tenant=batch_per_tenant,
                ))
        for run in pending:
            with self._on(run["shard"]):
                self._write_back(run)
        losses: dict[Any, np.ndarray] = {}
        paths = set()
        for run in pending:   # to the host after every group is issued
            group, ls_epochs, path = run["group"], run["losses"], run["path"]
            paths.add(path)
            ls = np.stack([l.cpu().numpy() for l in ls_epochs])   # (epochs, steps, n)
            for g, t in enumerate(group):
                losses[t] = ls[:, :, g]
        self.counters["adapt/epochs"] += epochs * len(groups)
        return {"losses": losses, "groups": list(groups.values()),
                "path": "stream" if "stream" in paths else "scan"}

    def _adapt_epochs(self, group, spt, shard, *, epochs, epoch0, step0, batch_per_tenant) -> dict:
        """Issue one same-(trajectory, shard) group's cached epochs on the
        shard's device and engine; on the resident path they are replays of
        the shard's epoch graphs, and nothing here waits for the device.
        Returns what ``_write_back`` needs: the per-epoch (steps, N) losses
        on the device, the new state, the held-out losses and the path."""
        n, dev, engine = len(group), self._shard_device[shard], self.engines[shard]
        params = self._shard_params[shard]
        states = [self.tenant(t) for t in group]
        stacked = _to(_stack([st.adapters for st in states]), dev)
        opt_state = OptState(
            step=torch.full((), step0, dtype=torch.int32, device=dev),
            mu=_to(_stack([st.opt_mu for st in states]), dev),
            nu=_to(_stack([st.opt_nu for st in states]), dev),
        )
        # Shadow split: with a control plane each tenant's epochs permute its
        # train rows only; every holdout_every-th ingested row is held out.
        holdout = self.control_cfg.holdout_every if self.control is not None else None
        train_rows, eval_rows = batch_plan.shadow_split(spt, every=holdout)
        do_eval = self.control is not None and eval_rows.size > 0
        bpt = min(batch_per_tenant, train_rows.size)
        row_tenant = FF.fleet_row_tenant(n, bpt, device=dev)
        partitions = [st.partition for st in states]
        # the plan offsets into the shard's id space while each tenant's
        # stream follows its global partition: a re-sharded (or elastically
        # restored) session replays the same orders
        local_parts = [p // self.n_shards for p in partitions]
        kw = dict(use_kernel=self.use_kernel)
        resident = engine.capacity >= engine.num_samples
        if do_eval:
            eval_idx = _upload(batch_plan.fleet_eval_index(
                n, spt, holdout_every=holdout, partitions=local_parts,
                partition_stride=self.samples_per_tenant,
            ), dev)
            eval_row_tenant = FF.fleet_row_tenant(n, eval_rows.size, device=dev)
        if resident:
            if self._export[shard] is None:
                self._export[shard] = engine.export_skipcache()
            cache = self._export[shard]
            graphs = self._epoch_graphs[shard]
            epoch_fn = FF.make_fleet_cached_epoch(self.cfg, self.sl, self.optimizer, n, graphs=graphs, **kw)
        else:
            step_fn = FF.make_fleet_cached_step_from_vals(self.cfg, self.sl, self.optimizer, n, **kw)
            ev_fn = FF.make_fleet_eval_loss(self.cfg, self.sl, n, **kw)

        pre_loss = post_loss = None
        if do_eval and not resident:
            # Streaming path: eval is its own (backbone-free) call over the
            # engine-read cached rows.
            pre_loss = ev_fn(params, stacked, engine.read(eval_idx), eval_row_tenant)
        all_losses, steps_per_epoch = [], 0
        for e in range(epochs):
            idx_mat = batch_plan.fleet_index_matrix(
                epoch0 + e, n, spt, bpt, seed=self.seed, partitions=local_parts, streams=partitions,
                partition_stride=self.samples_per_tenant, holdout_every=holdout,
            )
            steps_per_epoch = idx_mat.shape[0]
            want_pre = do_eval and resident and e == 0
            want_post = do_eval and resident and e == epochs - 1
            if want_pre or want_post:
                # Shadow eval folded into the epoch call, on the cached rows.
                eval_epoch = FF.make_fleet_cached_epoch_eval(
                    self.cfg, self.sl, self.optimizer, n, eval_pre=want_pre, eval_post=want_post,
                    graphs=graphs, **kw
                )
                stacked, opt_state, ls, pre, post = eval_epoch(
                    params, stacked, opt_state, cache, _upload(idx_mat, dev),
                    row_tenant, eval_idx, eval_row_tenant,
                )
                pre_loss = pre if want_pre else pre_loss
                post_loss = post if want_post else post_loss
            elif resident:
                stacked, opt_state, ls = epoch_fn(
                    params, stacked, opt_state, cache, _upload(idx_mat, dev), row_tenant
                )
            else:
                stacked, opt_state, ls = FF.fleet_cached_epoch_via_engine(
                    step_fn, params, stacked, opt_state, engine, idx_mat, row_tenant
                )
            all_losses.append(ls)
        if do_eval and not resident:
            post_loss = ev_fn(params, stacked, engine.read(eval_idx), eval_row_tenant)
        return {"group": group, "shard": shard, "states": states, "stacked": stacked, "opt_state": opt_state,
                "losses": all_losses, "pre": pre_loss, "post": post_loss, "epochs_done": epoch0 + epochs,
                # from the plan: reading opt_state.step would wait for the device
                "step": step0 + steps_per_epoch * epochs, "path": "scan" if resident else "stream"}

    def _write_back(self, run: dict) -> None:
        """A group's write-back into the pool (gated with a control plane)
        and the tenants' new training state."""
        group, states, stacked, opt_state = run["group"], run["states"], run["stacked"], run["opt_state"]
        step_after, epochs_done = run["step"], run["epochs_done"]
        if self.control is None:
            for g, st in enumerate(states):
                self._advance(st, stacked, opt_state, g, step_after, epochs_done)
            self.pool.register_many(group, stacked)
            for t in group:
                self.pool.pin(t)   # in-flight session state: never LRU-evicted
            return

        # -- gated write-back (control plane on): the gate reads the eval
        # losses on the host, which waits for this group's epochs.
        pre_np = None if run["pre"] is None else run["pre"].cpu().numpy()
        post_np = None if run["post"] is None else run["post"].cpu().numpy()
        decisions: dict[Any, str] = {}
        meta: dict[Any, dict] = {}
        for g, t in enumerate(group):
            pre_g = None if pre_np is None else float(pre_np[g])
            post_g = None if post_np is None else float(post_np[g])
            # A first-ever write-back has no served version to protect.
            dec = self.control.decide(t, pre_g, post_g) if self.pool.has(t) else "accept"
            decisions[t] = dec
            meta[t] = {"step": step_after, "eval_loss": post_g}
            self.control.record(t, dec, pre=pre_g, post=post_g, step=step_after)
            self.counters[f"control/{dec}"] += 1
        for g, (t, st) in enumerate(zip(group, states)):
            if decisions[t] != "reject":   # reject: retrain the same plan next adapt
                self._advance(st, stacked, opt_state, g, step_after, epochs_done)
        self.pool.register_many(group, stacked, gate=decisions.__getitem__, meta=meta)
        for t in group:
            self.pool.pin(t)
        # Auto-rollback: a tenant whose last N gated write-backs all failed is
        # presumed to diverge. Restore its previous served version (when the
        # slot has one) and restart its optimizer from zero.
        for t, st in zip(group, states):
            if decisions[t] == "accept" or not self.control.should_auto_rollback(t):
                continue
            if self.pool.has(t) and self.pool.history_len(t) > 0:
                self.pool.rollback(t)
            st.opt_mu, st.opt_nu = _zeros(st.opt_mu), _zeros(st.opt_nu)
            st.step = 0
            self.control.record_rollback(t, auto=True)
            self.counters["control/rollbacks"] += 1
            self.counters["control/auto_rollbacks"] += 1

    @staticmethod
    def _advance(st: TenantState, stacked, opt_state, g: int, step: int, epochs_done: int) -> None:
        st.adapters = _slice(stacked, g)
        st.opt_mu, st.opt_nu = _slice(opt_state.mu, g), _slice(opt_state.nu, g)
        st.step, st.epochs_done = step, epochs_done

    # -- control plane -------------------------------------------------------

    def rollback(self, tenant) -> dict:
        """Serve-plane rollback: restore the tenant's previous adapter
        version into its pool slot, bitwise, and move the pool version so
        every slot-index memo invalidates. Training state is not rewound (a
        quantised pool's payload cannot rebuild float training state). Needs
        a pool with version history (a session with a ``ControlConfig``)."""
        meta = self.pool.rollback(tenant)
        if self.control is not None:
            self.control.record_rollback(tenant)
        self.counters["control/rollbacks"] += 1
        return meta

    def control_metrics(self) -> Optional[dict]:
        """The control plane's JSON-able ledger (None when disabled)."""
        return None if self.control is None else self.control.metrics()

    # -- introspection -------------------------------------------------------

    def _engine_stats(self):
        if self.n_shards == 1:
            return self.engine.stats
        agg = type(self.engine.stats)()
        for eng in self.engines:
            for f in dataclasses.fields(agg):
                setattr(agg, f.name, getattr(agg, f.name) + getattr(eng.stats, f.name))
        return agg

    def epoch_graph_stats(self, shard: Optional[int] = None) -> Counter:
        """The resident adapt's epoch graphs of ``shard`` (default: summed
        over every shard): captures, replays, eager first steps and their host
        seconds (``cuda_graph.EpochGraph``)."""
        out = Counter()
        for graphs in self._epoch_graphs if shard is None else [self._epoch_graphs[shard]]:
            out.update(graphs.stats)
        return out

    def stats(self) -> dict[str, float]:
        out = {f"runtime/{k}": float(v) for k, v in sorted(self.counters.items())}
        out.update(dict(self._engine_stats().as_rows()))
        out.update(dict(self.pool.stats.as_rows()))
        return out

    # -- request-level surface (continuous batching; core.scheduler) ---------

    def attach_scheduler(self, **kw):
        """Construct the session's ``RequestScheduler`` with explicit limits
        (see ``core.scheduler.RequestScheduler``). ``serve`` and ``ingest``
        stay available beside it: the scheduler is a front door, not a
        replacement."""
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
        """Queue fine-tuning ingestion to run at a step boundary between
        decode dispatches; returns its ``IngestRequest``."""
        return self.scheduler.submit_ingest(tenant, tokens, labels)

    def drain(self):
        """Run the scheduler until every queued request completes."""
        return self.scheduler.drain()

    # -- checkpoint plane ----------------------------------------------------

    def session_state(self) -> tuple[dict, dict]:
        """(arrays, meta) for ``checkpoint.save_runtime_session``: the trained
        tenants' stacked adapters and optimizer moments (tenant order in
        meta; stacked on the first device), the pool's arrays and slot table,
        every present cache row under its *global* id in logical layout (read
        from each shard's engine in chunks of its capacity, copied to the
        host), the control plane and each shard's paged KV pool with its
        radix tree. The manifest keys and nesting are the reference's (one
        shard: the pool's own table and arrays; several: keyed ``s<i>`` with
        the placement). Tenant ids must be JSON-serialisable."""
        order = list(self._tenants)
        trained = [t for t in order if self._tenants[t].trained]
        arrays: dict[str, Any] = {}
        if trained:
            sts = [self._tenants[t] for t in trained]
            arrays["adapters"] = _stack([_to(st.adapters, self.device) for st in sts])
            for name in ("opt_mu", "opt_nu"):
                moments = _stack([_to(getattr(st, name), self.device) for st in sts])
                if moments is not None:
                    arrays[name] = moments
        arrays["pool"] = self.pool.state_arrays()
        ids, parts = [], []
        for s, eng in enumerate(self.engines):
            present = sorted(eng._present)
            chunk = max(1, eng.capacity)
            for lo in range(0, len(present), chunk):
                ids += [self._global_id(s, i) for i in present[lo:lo + chunk]]
                parts.append({n: v.cpu() for n, v in eng.read(present[lo:lo + chunk]).items()})
        present = sorted(ids)
        if parts:
            cat = {n: parts[0][n] if len(parts) == 1 else torch.cat([p[n] for p in parts]) for n in parts[0]}
            if present != ids:
                order_ = torch.as_tensor(np.argsort(np.asarray(ids), kind="stable"))
                cat = {n: v[order_] for n, v in cat.items()}
            arrays["cache"] = cat
        meta = {
            "tenants": [
                {"id": t, "partition": st.partition, "n_ingested": st.n_ingested,
                 "epochs_done": st.epochs_done, "step": st.step}
                for t, st in self._tenants.items()
            ],
            "trained": trained,
            "pool_table": self.pool.slot_table(),
            "present": present,
            "layout": {"seq": self.seq, "rank": self.sl.rank, "mode": self.sl.mode,
                       "samples_per_tenant": self.samples_per_tenant, "n_shards": self.n_shards,
                       # restore-compared: another pool would reinterpret packed bytes
                       "pool_compress": self.pool.compress, "pool_slots": self.pool.n_slots,
                       "max_tenants": self.max_tenants,
                       # informational: the device layout the session ran on
                       "mesh_shape": list(self.mesh.shape), "mesh_axes": list(self.mesh.axis_names),
                       "model_parallel": self.model_parallel, "pipeline_stages": self.pipeline_stages},
        }
        if self.control is not None:
            meta["control"] = self.control.state()
        if self._kv_pools:
            arrays["kv_pool"] = {str(s): p.state_arrays() for s, p in sorted(self._kv_pools.items())}
            meta["kv_pool"] = {
                str(s): {**p.state_meta(),
                         "radix": self._prefix_indexes[s].state() if s in self._prefix_indexes else []}
                for s, p in sorted(self._kv_pools.items())
            }
        return arrays, meta

    def load_session_state(self, arrays: dict, meta: dict) -> None:
        """Restore a ``session_state`` capture (tensor or numpy leaves) into
        this fresh runtime. The layout (seq, rank, mode, samples per tenant,
        logical shards) and the pool (compression, slots, tenant capacity)
        must match the saving session's; the mesh need not: an elastic
        restart restores the same logical layout onto however many devices
        this runtime has, and each shard's engine re-places its cache rows
        under its own budget (written through ``engine.write`` in chunks of
        its capacity). Control state needs a runtime built with a
        ``ControlConfig``. The KV pools' refcounts are rebuilt from their
        radix trees: a fresh session has no rows in flight."""
        if self._tenants:
            raise RuntimeError("restore requires a fresh runtime")
        lay = meta["layout"]
        saved = (lay["seq"], lay["rank"], lay["mode"], lay["samples_per_tenant"], int(lay.get("n_shards", 1)))
        if saved != (self.seq, self.sl.rank, self.sl.mode, self.samples_per_tenant, self.n_shards):
            raise ValueError(f"session layout {lay} != runtime configuration (logical shards {self.n_shards})")
        for k, mine in (("pool_compress", self.pool.compress), ("pool_slots", self.pool.n_slots),
                        ("max_tenants", self.max_tenants)):
            if k in lay and lay[k] != mine:
                raise ValueError(
                    f"checkpoint {k}={lay[k]!r} != this runtime's {mine!r}: "
                    "restore requires an identically-configured session"
                )
        if "control" in meta:
            if self.control is None:
                raise ValueError(
                    "checkpoint carries control-plane state (gate ledger, quarantine set) but this "
                    "runtime was built without a ControlConfig: restoring would silently drop it"
                )
            self.control.load_state(meta["control"])
        for ent in meta["tenants"]:
            st = TenantState(partition=int(ent["partition"]), n_ingested=int(ent["n_ingested"]),
                             epochs_done=int(ent["epochs_done"]), step=int(ent["step"]))
            self._tenants[ent["id"]] = st
            self._free_partitions.remove(st.partition)   # keeps each shard's smallest-first order
        stacked = {name: {k: torch.as_tensor(v) for k, v in arrays[name].items()}
                   for name in ("adapters", "opt_mu", "opt_nu") if name in arrays}
        for i, t in enumerate(meta["trained"]):
            st = self._tenants[t]
            dev = self._shard_device[self._shard_of_partition(st.partition)]
            st.adapters = _to(_slice(stacked["adapters"], i), dev)
            st.opt_mu = _to(_slice(stacked.get("opt_mu"), i), dev)
            st.opt_nu = _to(_slice(stacked.get("opt_nu"), i), dev)
        self.pool.load_state(arrays["pool"], meta["pool_table"])
        by_shard: dict[int, list[tuple[int, int]]] = {}
        for pos, gid in enumerate(int(i) for i in meta["present"]):
            part = gid // self.samples_per_tenant
            local = self._local_ids(part, [gid % self.samples_per_tenant])[0]
            by_shard.setdefault(self._shard_of_partition(part), []).append((pos, local))
        for s, entries in sorted(by_shard.items()):
            eng, dev = self.engines[s], self._shard_device[s]
            chunk = max(1, eng.capacity)
            for lo in range(0, len(entries), chunk):
                sub = entries[lo:lo + chunk]
                pos = torch.tensor([p for p, _ in sub])
                eng.write([l for _, l in sub], {
                    n: torch.as_tensor(v)[pos].to(dev) for n, v in arrays["cache"].items()
                })
        for s_str, pmeta in meta.get("kv_pool", {}).items():
            s = int(s_str)
            if not 0 <= s < self.n_shards:
                raise ValueError(f"checkpoint kv pool of shard {s}: this session has {self.n_shards} shard(s)")
            pool = self.kv_pool(s, block=int(pmeta["block"]), n_blocks=int(pmeta["n_blocks"]))
            pool.load_state(arrays["kv_pool"][s_str], pmeta)
            self.prefix_index(s).load_state(pmeta.get("radix", []))


def _stack(trees: list) -> Optional[Params]:
    """Per-tenant trees -> one stacked tree (optimizer moments may be None)."""
    return None if trees[0] is None else FF.stack_tenant_adapters(trees)


def _slice(tree: Optional[Params], i: int) -> Optional[Params]:
    return None if tree is None else FF.tenant_adapters(tree, i)


def _zeros(tree: Optional[Params]) -> Optional[Params]:
    return None if tree is None else {k: torch.zeros_like(v) for k, v in tree.items()}


def _to(tree: Optional[Params], device) -> Optional[Params]:
    return None if tree is None else {k: v.to(device) for k, v in tree.items()}


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device's queued
    work: a copy from pageable memory waits for it, one from pinned memory
    is ordered on the stream instead."""
    t = torch.as_tensor(arr)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
