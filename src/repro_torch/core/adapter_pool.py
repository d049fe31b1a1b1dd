"""Adapter pool: slot-based registry of per-tenant Skip-LoRA stacks.

Counterpart of ``repro.core.adapter_pool``. Serving applies a
*different* adapter stack per batch row, and the skip topology taps every
layer, so the adapters stay in a stacked device-resident pool

    A: (n_slots, L, D, R)    B: (n_slots, L, R, D)

indexed per row by the grouped skip-sum kernels. A host-side LRU map
assigns tenant -> slot, and registration past capacity evicts the
least-recently-served unpinned tenant. Slot 0 is pinned all-zeros: the "no
adapter" tenant, so base-model rows ride the same batched kernel.

``compress="int8"`` stores the pool rowwise-quantised (int8 payload + fp32
scales over the last axis), fed raw to ``skip_lora_grouped_int8`` (K6).
``compress="int4"`` / ``"nf4"`` halve the payload again: two 4-bit codebook
indices a byte (``kernels.skip_lora.quant``) + the same fp32 rowwise scales,
fed raw to ``skip_lora_grouped_q4`` (K7). Unwritten slots have zero scales,
so they, and the zero slot, dequantise to exact zeros in every layout.

Versioned slots: with ``history > 0`` each re-registration archives the
outgoing payload (storage layout, on the host) with its {"step",
"eval_loss"}; ``rollback`` restores it bitwise. ``register_many`` installs a
fleet's stacks in one batched write per pool tensor, with an optional
write-back ``gate``.

``version`` counts changes of the tenant -> slot map (and rollbacks), as
the reference's does; ``touch`` refreshes recency without a lookup.

``pin`` keeps a tenant with in-flight training state (the session
runtime's trained tenants) out of LRU eviction.

Checkpoint plane: ``slot_table`` (JSON-able LRU map, free list, pins,
version meta and history metadata), ``state_arrays`` (data plane plus
archived payloads keyed ``hist/h{k}``) and ``load_state``, in the
reference's layout, so one session's capture reads like the reference's.

``ShardedAdapterPool`` shards the registry along the session's data axis
by tenant: one ``AdapterPool`` per logical shard on the shard's device,
balanced round-robin placement, sticky afterwards. Its state is keyed
``s<i>`` with the placement in the table, the reference's layout; with one
shard every method is the one pool's.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Optional

import torch

from repro_torch.core.lm_skiplora import quantize_int8
from repro_torch.kernels.skip_lora import quant as q4
from repro_torch.models.config import ModelConfig

Params = Any

#: pinned all-zeros slot: rows with no registered adapter (base model).
ZERO_SLOT = 0

#: Write-back gate decisions. "accept" installs the payload; "reject" and
#: "quarantine" both leave the slot serving its current version.
GATE_DECISIONS = ("accept", "reject", "quarantine")


@dataclasses.dataclass
class PoolStats:
    registrations: int = 0
    evictions: int = 0
    lookups: int = 0
    misses: int = 0
    rollbacks: int = 0
    gate_rejected: int = 0
    gate_quarantined: int = 0

    def as_rows(self, prefix: str = "adapter_pool") -> list[tuple[str, float]]:
        return [(f"{prefix}/{f.name}", float(getattr(self, f.name))) for f in dataclasses.fields(self)]


class AdapterPool:
    """Fixed-capacity device pool of per-tenant adapter stacks.

    Data plane: stacked tensors consumed directly by the grouped kernels.
    Control plane: host-side LRU tenant->slot map and version history."""

    def __init__(
        self,
        n_slots: int,
        cfg: ModelConfig,
        rank: int,
        *,
        compress: Optional[str] = None,
        dtype=torch.float32,
        device="cuda",
        history: int = 0,
    ):
        if n_slots < 2:
            raise ValueError("need >= 2 slots (slot 0 is pinned to zeros)")
        if compress not in (None, "int8") + q4.Q4_KINDS:
            raise ValueError(f"unknown compression {compress!r}")
        if history < 0:
            raise ValueError(f"history depth {history} < 0")
        self.n_slots = n_slots
        self.rank = rank
        self.compress = compress
        self.history_depth = history
        self.device = torch.device(device)
        l, d, r = cfg.n_layers, cfg.d_model, rank
        self._shape_a, self._shape_b = (l, d, r), (l, r, d)

        def z(shape, dt):
            return torch.zeros((n_slots,) + shape, dtype=dt, device=self.device)

        if compress in q4.Q4_KINDS:
            if r % 2 or d % 2:
                raise ValueError(
                    f"4-bit pools pack two indices a byte along the last axis: rank {r} "
                    f"and d_model {d} must both be even"
                )
            # Zero payload is nibble 0, not the zero level, but the zero
            # scales make every unwritten slot dequantise to exact zeros.
            self._arrays = {
                "qa4": z((l, d, r // 2), torch.uint8), "sa": z((l, d), torch.float32),
                "qb4": z((l, r, d // 2), torch.uint8), "sb": z((l, r), torch.float32),
                "code": q4.codebook(compress, self.device),
            }
        elif compress == "int8":
            self._arrays = {
                "qa": z((l, d, r), torch.int8), "sa": z((l, d), torch.float32),
                "qb": z((l, r, d), torch.int8), "sb": z((l, r), torch.float32),
            }
        else:
            self._arrays = {"A": z((l, d, r), dtype), "B": z((l, r, d), dtype)}
        # Slot 0 never enters the LRU / free list: it is the zero tenant.
        self._lru: OrderedDict[Any, int] = OrderedDict()
        self._free: list[int] = list(range(n_slots - 1, 0, -1))
        self._pinned: set = set()
        #: tenant -> oldest..newest previous versions, each {"payload": {name:
        #: host tensor}, "step", "eval_loss"}; at most ``history_depth``.
        self._hist: dict[Any, list[dict]] = {}
        #: tenant -> {"step", "eval_loss"} of the served version.
        self._vmeta: dict[Any, dict] = {}
        #: bumps when the tenant -> slot map changes (a new assignment, an
        #: eviction) and on a rollback; not on a lookup, an LRU touch or a
        #: re-registration into the tenant's own slot. The request scheduler
        #: re-resolves its rows' slots when it moves.
        self.version = 0
        self.stats = PoolStats()

    # -- capacity -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._lru)

    def tenants(self) -> list:
        return list(self._lru.keys())

    def has(self, tenant) -> bool:
        return tenant in self._lru

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self._arrays.values())

    # -- registration -------------------------------------------------------

    def _as_f32(self, x, shape, what: str) -> torch.Tensor:
        t = torch.as_tensor(x).detach().to(self.device, torch.float32)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} shapes {tuple(t.shape)} != pool {tuple(shape)}")
        return t

    def _write(self, slots, a: torch.Tensor, b: torch.Tensor) -> None:
        """Write adapters a, b (one slot's, or stacked with a leading axis
        matching ``slots``) in place into the pool's storage layout."""
        if self.compress in q4.Q4_KINDS:
            # Rowwise (last-axis) quantisation is independent per slot, so a
            # stack quantises as its slots one at a time would.
            (qa, sa), (qb, sb) = q4.quantize_q4(a, self.compress), q4.quantize_q4(b, self.compress)
            vals = {"qa4": qa, "sa": sa, "qb4": qb, "sb": sb}
        elif self.compress == "int8":
            (qa, sa), (qb, sb) = quantize_int8(a), quantize_int8(b)
            vals = {"qa": qa, "sa": sa, "qb": qb, "sb": sb}
        else:
            vals = {"A": a, "B": b}
        for name, val in vals.items():
            self._arrays[name][slots] = val.to(self._arrays[name].dtype)

    def _assign_slot(self, tenant) -> int:
        """LRU bookkeeping: re-registration keeps the tenant's slot; a full
        pool evicts the least-recently-served *unpinned* tenant."""
        if tenant in self._lru:
            self._lru.move_to_end(tenant)
            return self._lru[tenant]
        if self._free:
            slot = self._free.pop()
        else:
            victim = next((t for t in self._lru if t not in self._pinned), None)
            if victim is None:
                raise RuntimeError(
                    f"pool full and all {len(self._lru)} resident tenants "
                    "pinned: cannot evict for a new registration"
                )
            slot = self._lru.pop(victim)
            self._drop_versions(victim)
            self.stats.evictions += 1
        self._lru[tenant] = slot
        self.version += 1
        return slot

    def _set_meta(self, tenant, meta: Optional[dict]) -> None:
        meta = meta or {}
        self._vmeta[tenant] = {"step": int(meta.get("step", 0)), "eval_loss": meta.get("eval_loss")}

    def register(self, tenant, adapters: Params, *, meta: Optional[dict] = None) -> int:
        """Install a tenant's {"A": (L,D,R), "B": (L,R,D)} stack (tensors or
        numpy arrays). Re-registering overwrites the tenant's slot in place,
        archiving the outgoing payload when ``history > 0``; a full pool
        evicts the least-recently-served unpinned tenant. ``meta`` stamps the
        new version's {"step", "eval_loss"}."""
        a = self._as_f32(adapters["A"], self._shape_a, "adapter")
        b = self._as_f32(adapters["B"], self._shape_b, "adapter")
        if tenant in self._lru:
            self._push_history(tenant)
        slot = self._assign_slot(tenant)
        self._write(slot, a, b)
        self._set_meta(tenant, meta)
        self.stats.registrations += 1
        return slot

    def register_many(self, tenants, stacked: Params, *, gate=None, meta: Optional[dict] = None) -> list[int]:
        """Batched registration of a fleet's stacks: tenant ``tenants[i]``
        gets {"A": stacked["A"][i], "B": stacked["B"][i]}, written with one
        indexed write per pool tensor. Slots, evictions and payloads equal
        those of sequential ``register`` calls.

        ``gate`` is a callable tenant -> one of ``GATE_DECISIONS``, asked
        only for re-registrations (a new tenant has no served version to
        protect). A decision other than "accept" leaves the tenant's slot,
        payload and version meta as they were (an LRU touch all the same)
        and counts in ``stats``. ``meta`` maps tenant -> {"step",
        "eval_loss"} for the versions that land."""
        tenants = list(tenants)
        if len(set(tenants)) != len(tenants):
            raise ValueError("duplicate tenants in batched registration")
        if len(tenants) > self.n_slots - 1:
            raise ValueError(f"{len(tenants)} tenants exceed pool capacity {self.n_slots - 1}")
        n = len(tenants)
        a = self._as_f32(stacked["A"], (n,) + self._shape_a, "stacked")
        b = self._as_f32(stacked["B"], (n,) + self._shape_b, "stacked")
        write_idx = []
        for i, t in enumerate(tenants):
            decision = "accept"
            if gate is not None and t in self._lru:
                decision = gate(t)
                if decision not in GATE_DECISIONS:
                    raise ValueError(f"gate decision {decision!r} for {t!r}")
            if decision == "accept":
                if t in self._lru:
                    self._push_history(t)
                write_idx.append(i)
            elif decision == "reject":
                self.stats.gate_rejected += 1
            else:
                self.stats.gate_quarantined += 1
        writes = set(write_idx)
        slots = []
        for i, t in enumerate(tenants):
            if i in writes:
                slots.append(self._assign_slot(t))
                self._set_meta(t, (meta or {}).get(t))
            else:
                self._lru.move_to_end(t)
                slots.append(self._lru[t])
        if write_idx:
            if len(write_idx) < n:
                w = torch.tensor(write_idx, device=self.device)
                a, b = a[w], b[w]
            sv = torch.tensor([slots[i] for i in write_idx], device=self.device)
            self._write(sv, a, b)
            self.stats.registrations += len(write_idx)
        return slots

    def evict(self, tenant) -> None:
        if tenant in self._pinned:
            raise ValueError(f"tenant {tenant!r} is pinned; unpin before evicting")
        self._free.append(self._lru.pop(tenant))
        self._drop_versions(tenant)
        self.version += 1
        self.stats.evictions += 1

    # -- versioned slots ----------------------------------------------------

    def _payload_names(self) -> list[str]:
        """Per-slot pool tensors: everything but the shared 4-bit codebook."""
        return [n for n in self._arrays if n != "code"]

    def slot_payload(self, tenant) -> dict[str, torch.Tensor]:
        """Copies of the tenant's current slot in storage layout (quantised
        pools stay quantised: what a rollback restores bitwise)."""
        slot = self._lru[tenant]
        return {n: self._arrays[n][slot].clone() for n in self._payload_names()}

    def _push_history(self, tenant) -> None:
        """Archive the tenant's outgoing payload (host copies) and version
        meta before an overwrite."""
        if self.history_depth < 1:
            return
        meta = self._vmeta.get(tenant, {})
        h = self._hist.setdefault(tenant, [])
        h.append({
            "payload": {n: v.cpu() for n, v in self.slot_payload(tenant).items()},
            "step": int(meta.get("step", 0)),
            "eval_loss": meta.get("eval_loss"),
        })
        del h[: -self.history_depth]

    def _drop_versions(self, tenant) -> None:
        self._hist.pop(tenant, None)
        self._vmeta.pop(tenant, None)

    def history_len(self, tenant) -> int:
        return len(self._hist.get(tenant, ()))

    def _registered(self, tenant) -> None:
        if tenant not in self._lru:
            raise KeyError(f"tenant {tenant!r} has no registered adapters")

    def version_info(self, tenant) -> dict:
        """{"step", "eval_loss", "history"} of the tenant's served version."""
        self._registered(tenant)
        meta = self._vmeta.get(tenant, {})
        return {"step": int(meta.get("step", 0)), "eval_loss": meta.get("eval_loss"),
                "history": self.history_len(tenant)}

    def set_eval_loss(self, tenant, eval_loss) -> None:
        """Stamp the served version's held-out loss without touching the payload."""
        self._registered(tenant)
        meta = self._vmeta.setdefault(tenant, {"step": 0, "eval_loss": None})
        meta["eval_loss"] = None if eval_loss is None else float(eval_loss)

    def rollback(self, tenant) -> dict:
        """Restore the tenant's previous version into its slot, bitwise.
        Returns the restored {"step", "eval_loss"}; raises KeyError when
        there is no archived version."""
        self._registered(tenant)
        h = self._hist.get(tenant)
        if not h:
            raise KeyError(f"tenant {tenant!r} has no version history")
        rec = h.pop()
        if not h:
            del self._hist[tenant]
        slot = self._lru[tenant]
        for name, val in rec["payload"].items():
            self._arrays[name][slot] = val.to(self.device)
        self._vmeta[tenant] = {"step": rec["step"], "eval_loss": rec["eval_loss"]}
        self.version += 1
        self.stats.rollbacks += 1
        return {"step": rec["step"], "eval_loss": rec["eval_loss"]}

    # -- pinning ------------------------------------------------------------

    def pin(self, tenant) -> None:
        """Exclude a registered tenant's slot from LRU eviction."""
        if tenant not in self._lru:
            raise KeyError(f"tenant {tenant!r} has no registered adapters to pin")
        self._pinned.add(tenant)

    def unpin(self, tenant) -> None:
        self._pinned.discard(tenant)

    def pinned(self) -> set:
        return set(self._pinned)

    # -- lookup -------------------------------------------------------------

    def lookup(self, tenants) -> torch.Tensor:
        """Tenant ids -> (B,) int32 slot indices on the pool's device.

        ``None`` maps to the pinned zero slot (base model); an unknown
        tenant raises KeyError."""
        slots = []
        for t in tenants:
            self.stats.lookups += 1
            if t is None:
                slots.append(ZERO_SLOT)
            elif t in self._lru:
                self._lru.move_to_end(t)
                slots.append(self._lru[t])
            else:
                self.stats.misses += 1
                raise KeyError(f"tenant {t!r} has no registered adapters")
        return torch.tensor(slots, dtype=torch.int32, device=self.device)

    def touch(self, tenants) -> None:
        """LRU refresh only, no slot-index build (and no ``version`` bump):
        recency follows serving traffic that reuses a memoised lookup."""
        for t in tenants:
            if t is not None and t in self._lru:
                self._lru.move_to_end(t)

    # -- data plane ---------------------------------------------------------

    def pools(self) -> dict[str, torch.Tensor]:
        """The stacked tensors the grouped kernels consume, in storage
        layout: float {"A", "B"}; int8 {"qa", "sa", "qb", "sb"}; 4-bit
        {"qa4", "sa", "qb4", "sb", "code"} (``code`` is the 16-entry codebook
        that tells int4 from nf4). Writes go in place, so the dict stays live
        across registrations."""
        return dict(self._arrays)

    # -- session state (checkpoint plane) ------------------------------------

    def slot_table(self) -> dict:
        """JSON-able control plane: LRU-ordered (tenant, slot) pairs, free
        list, pinned tenants, plus the versioning plane: per-tenant version
        meta and history *metadata* ([step, eval_loss] per archived version,
        oldest..newest; payloads travel in ``state_arrays``, keyed
        ``hist/h{k}`` in ``_hist_enumeration`` order). Tenant ids must be
        JSON-serialisable to round-trip through a checkpoint manifest."""
        return {
            "lru": [[t, s] for t, s in self._lru.items()],
            "free": list(self._free),
            "pinned": [t for t in self._lru if t in self._pinned],
            "history_depth": self.history_depth,
            "meta": [
                [t, [m["step"], m["eval_loss"]]]
                for t, m in ((t, self._vmeta[t]) for t in self._lru)
                if t in self._vmeta
            ],
            "history": [
                [t, [[r["step"], r["eval_loss"]] for r in self._hist[t]]]
                for t in self._lru
                if self._hist.get(t)
            ],
        }

    def _hist_enumeration(self) -> list[tuple[Any, int]]:
        """(tenant, depth index) pairs in the order history payloads are
        keyed in ``state_arrays``: LRU order, oldest..newest within a
        tenant, row for row ``slot_table()``'s "history"."""
        return [(t, j) for t in self._lru for j in range(len(self._hist.get(t, ())))]

    def state_arrays(self) -> dict:
        """Everything array-valued a checkpoint carries: the data plane under
        "data" (``pools()`` layout, on the pool's device) and archived version
        payloads under "hist" as ``h{k}/{name}`` (host tensors)."""
        hist = {f"h{k}": dict(self._hist[t][j]["payload"])
                for k, (t, j) in enumerate(self._hist_enumeration())}
        return {"data": self.pools(), "hist": hist}

    def load_state(self, arrays: dict, table: dict) -> None:
        """Restore the data and control planes saved from a pool of the same
        geometry. ``arrays`` is a ``state_arrays()`` layout ({"data",
        "hist"}) with tensor or numpy leaves. The data lands in place, bit
        for bit (4-bit payloads and the codebook included), so live
        ``pools()`` dicts see it; ``version`` moves, so every slot-index memo
        misses."""
        data, hist_payloads = arrays["data"], arrays.get("hist", {})
        want = set(self._arrays)
        if set(data) != want:
            raise ValueError(f"pool arrays {set(data)} != expected {want}")
        for name, arr in data.items():
            cur = self._arrays[name]
            arr = torch.as_tensor(arr)
            if tuple(arr.shape) != tuple(cur.shape):
                raise ValueError(f"pool array {name}: {tuple(arr.shape)} != {tuple(cur.shape)}")
            cur.copy_(arr.to(cur.dtype))
        self._lru = OrderedDict((t, int(s)) for t, s in table["lru"])
        self._free = [int(s) for s in table["free"]]
        self._pinned = set(table.get("pinned", ()))
        self._vmeta = {t: {"step": int(step), "eval_loss": loss} for t, (step, loss) in table.get("meta", [])}
        self._hist = {}
        hist_meta = {t: metas for t, metas in table.get("history", [])}
        k = 0
        for t in self._lru:
            for step, loss in hist_meta.get(t, ()):
                payload = hist_payloads.get(f"h{k}")
                if payload is None:
                    raise ValueError(f"history payload h{k} (tenant {t!r}) missing from checkpoint arrays")
                self._hist.setdefault(t, []).append({
                    "payload": {n: torch.as_tensor(v).detach().cpu().clone() for n, v in payload.items()},
                    "step": int(step),
                    "eval_loss": loss,
                })
                k += 1
        if k != len(hist_payloads):
            raise ValueError(f"{len(hist_payloads)} history payloads in checkpoint, manifest accounts for {k}")
        self.version += 1


class ShardedAdapterPool:
    """Adapter registry sharded along the session's ``data`` axis by tenant.

    Every tenant is *placed* on a logical shard the first time the session
    sees it (balanced round robin: the shard with the fewest placed tenants,
    lowest index on ties), and its slot, cache partition, training state and
    serve rows stay there. Each shard holds its own ``AdapterPool`` on the
    shard's device (``devices[s % len(devices)]``), so grouped serve and
    adapt batches route rows to the shard holding their slot and never
    gather adapters across devices. The shard count is a session-layout
    property carried through checkpoints; the devices are placement only.

    With ``n_shards == 1`` every method is the wrapped ``AdapterPool``'s,
    its state and slot table included: the one-device path, bitwise."""

    def __init__(self, n_slots_per_shard: int, cfg: ModelConfig, rank: int, *, n_shards: int = 1,
                 devices: Optional[list] = None, compress: Optional[str] = None, dtype=torch.float32,
                 history: int = 0):
        if n_shards < 1:
            raise ValueError(f"need >= 1 shard, got {n_shards}")
        devs = list(devices) if devices else ["cuda"]
        self.n_shards = n_shards
        self.compress = compress
        self.history_depth = history
        self.shards = [
            AdapterPool(n_slots_per_shard, cfg, rank, compress=compress, dtype=dtype,
                        device=devs[s % len(devs)], history=history)
            for s in range(n_shards)
        ]
        self.n_slots = self.shards[0].n_slots
        self.rank = rank
        self._placement: dict[Any, int] = {}

    # -- placement ------------------------------------------------------------

    def place(self, tenant) -> int:
        """The tenant's logical shard: balanced round robin at first sight,
        sticky afterwards."""
        s = self._placement.get(tenant)
        if s is None:
            counts = [0] * self.n_shards
            for sh in self._placement.values():
                counts[sh] += 1
            s = self._placement[tenant] = min(range(self.n_shards), key=lambda i: (counts[i], i))
        return s

    def shard_of(self, tenant) -> int:
        """The tenant's placed shard (``None``: shard 0, the zero slot)."""
        if tenant is None or self.n_shards == 1:
            return 0
        s = self._placement.get(tenant)
        if s is None:
            raise KeyError(f"tenant {tenant!r} has no shard placement")
        return s

    def unplace(self, tenant) -> None:
        self._placement.pop(tenant, None)

    def placement(self) -> dict:
        return dict(self._placement)

    def route(self, tenants) -> list[tuple[list[int], list]]:
        """Split a batch by slot shard: per shard, the (row positions,
        tenants) of the rows it owns. Base rows (``None``) ride shard 0's
        zero slot."""
        out: list[tuple[list[int], list]] = [([], []) for _ in range(self.n_shards)]
        for pos, t in enumerate(tenants):
            rows, subs = out[self.shard_of(t)]
            rows.append(pos)
            subs.append(t)
        return out

    # -- lookups --------------------------------------------------------------

    def _only(self) -> AdapterPool:
        if self.n_shards != 1:
            raise RuntimeError("multi-shard pool: use route() / shard_pools(s) / lookup_local()")
        return self.shards[0]

    def pools(self) -> dict[str, torch.Tensor]:
        return self._only().pools()

    def lookup(self, tenants) -> torch.Tensor:
        return self._only().lookup(tenants)

    def shard_pools(self, s: int) -> dict[str, torch.Tensor]:
        return self.shards[s].pools()

    def lookup_local(self, s: int, tenants) -> torch.Tensor:
        """Shard-local slot indices of a routed sub-batch."""
        return self.shards[s].lookup(tenants)

    # -- registry -------------------------------------------------------------

    def _home(self, tenant) -> Optional[AdapterPool]:
        """The pool holding the tenant's placement (None: unplaced)."""
        if self.n_shards == 1:
            return self.shards[0]
        s = self._placement.get(tenant)
        return None if s is None else self.shards[s]

    def has(self, tenant) -> bool:
        p = self._home(tenant)
        return p is not None and p.has(tenant)

    def tenants(self) -> list:
        return [t for p in self.shards for t in p.tenants()]

    def __len__(self) -> int:
        return sum(len(p) for p in self.shards)

    def nbytes(self) -> int:
        return sum(p.nbytes() for p in self.shards)

    @property
    def version(self) -> int:
        """Moves with every shard's slot-map change (a memo key)."""
        return sum(p.version for p in self.shards)

    @property
    def stats(self) -> PoolStats:
        if self.n_shards == 1:
            return self.shards[0].stats
        agg = PoolStats()
        for p in self.shards:
            for f in dataclasses.fields(PoolStats):
                setattr(agg, f.name, getattr(agg, f.name) + getattr(p.stats, f.name))
        return agg

    def register(self, tenant, adapters: Params, *, meta: Optional[dict] = None) -> int:
        return self.shards[self.place(tenant)].register(tenant, adapters, meta=meta)

    def register_many(self, tenants, stacked: Params, *, gate=None, meta: Optional[dict] = None) -> list[int]:
        """Batched write-back routed by placement: one write per shard, on
        the shard's device (a same-shard group, the session's adapt groups,
        is one write). ``gate`` / ``meta`` are tenant-keyed and pass through."""
        tenants = list(tenants)
        by_shard: dict[int, list[int]] = {}
        for i, t in enumerate(tenants):
            by_shard.setdefault(self.place(t), []).append(i)
        slots = [0] * len(tenants)
        for s, rows in by_shard.items():
            if len(rows) == len(tenants):
                sub = stacked
            else:
                sel = torch.tensor(rows)
                sub = {k: v[sel.to(v.device)] for k, v in stacked.items()}
            got = self.shards[s].register_many([tenants[i] for i in rows], sub, gate=gate, meta=meta)
            for i, slot in zip(rows, got):
                slots[i] = slot
        return slots

    def _of(self, tenant) -> AdapterPool:
        return self.shards[self.shard_of(tenant)]

    def rollback(self, tenant) -> dict:
        return self._of(tenant).rollback(tenant)

    def version_info(self, tenant) -> dict:
        return self._of(tenant).version_info(tenant)

    def history_len(self, tenant) -> int:
        return self._of(tenant).history_len(tenant)

    def set_eval_loss(self, tenant, eval_loss) -> None:
        self._of(tenant).set_eval_loss(tenant, eval_loss)

    def slot_payload(self, tenant) -> dict[str, torch.Tensor]:
        return self._of(tenant).slot_payload(tenant)

    def evict(self, tenant) -> None:
        self._of(tenant).evict(tenant)

    def pin(self, tenant) -> None:
        self._of(tenant).pin(tenant)

    def unpin(self, tenant) -> None:
        p = self._home(tenant)
        if p is not None:
            p.unpin(tenant)

    def pinned(self) -> set:
        return set().union(*(p.pinned() for p in self.shards))

    def touch(self, tenants) -> None:
        for t in tenants:
            p = None if t is None else self._home(t)
            if p is not None:
                p.touch([t])

    # -- session state (checkpoint plane) ------------------------------------

    def state_arrays(self) -> dict:
        """One shard: the pool's own. Several: each shard's keyed ``s<i>``."""
        if self.n_shards == 1:
            return self.shards[0].state_arrays()
        return {f"s{i}": p.state_arrays() for i, p in enumerate(self.shards)}

    def slot_table(self) -> dict:
        """One shard: the pool's own table. Several: the placement and each
        shard's table (the reference's layout)."""
        if self.n_shards == 1:
            return self.shards[0].slot_table()
        return {
            "n_shards": self.n_shards,
            "placement": [[t, s] for t, s in self._placement.items()],
            "shards": [p.slot_table() for p in self.shards],
        }

    def load_state(self, arrays: dict, table: dict) -> None:
        """Restore ``state_arrays`` / ``slot_table`` of a pool with the same
        shard count (the count is a layout property: an elastic restart
        changes devices, not shards)."""
        saved = int(table.get("n_shards", 1))
        if saved != self.n_shards:
            raise ValueError(
                f"checkpoint has {saved} pool shards, this session is laid out for {self.n_shards} "
                "(logical shard count is a session-layout property; elastic restarts change devices, not shards)"
            )
        if "n_shards" not in table:
            self.shards[0].load_state(arrays, table)
            self._placement = {t: 0 for t, _ in table["lru"]}
            return
        self._placement = {t: int(s) for t, s in table["placement"]}
        for i, p in enumerate(self.shards):
            p.load_state(arrays[f"s{i}"], table["shards"][i])


def _pool_slots(pools: dict[str, torch.Tensor]) -> int:
    return pools["qa4" if "qa4" in pools else "qa" if "qa" in pools else "A"].shape[0]


def grouped_plan(pools: Optional[dict[str, torch.Tensor]], idx: Optional[torch.Tensor], *,
                 use_kernel: bool = True, fused: bool = False, positions: int = 1, tm: Optional[int] = None):
    """The grouped kernels' plan for rows ``idx`` (B,), ``positions`` each,
    over ``pools`` (``ops.grouped_plan``, at row tile ``tm``, None: the
    default tile), to hand to every ``grouped_skip_sum`` over the same rows
    with the same ``use_kernel`` and ``fused``; None where that sum launches
    no kernel (no pools, the CPU's plain versions, ``use_kernel=False``,
    ``fused``)."""
    from repro_torch.kernels.skip_lora import ops

    if pools is None or not use_kernel or fused or idx.device.type != "cuda":
        return None
    return ops.grouped_plan(idx, _pool_slots(pools), positions, tm=tm)


def grouped_skip_sum(
    acts: torch.Tensor,
    pools: dict[str, torch.Tensor],
    idx: torch.Tensor,
    *,
    use_kernel: bool = True,
    fused: bool = False,
    plan=None,
) -> torch.Tensor:
    """Per-row skip-sum over a stacked pool: picks the float, int8 or 4-bit
    layout and forwards to the grouped wrappers, which own the row
    flattening and the kernel / plain-version dispatch. ``use_kernel=False``
    runs the plain versions on any device instead, as the reference's flag
    sends its sum to its oracle. ``fused=True`` (the reference's decode
    option) skips the grouped kernel and computes the dense per-row gather
    and einsum, the plain version, inline in the decode step. ``plan``
    (``grouped_plan``) spares the kernel launch building its own. acts:
    (L, B, S, D); idx: (B,) -> (B, S, D)."""
    from repro_torch.kernels.skip_lora import ops
    from repro_torch.kernels.skip_lora import ref as R

    if "qa4" in pools:
        wrapper, plain = ops.skip_lora_grouped_q4, R.skip_lora_grouped_q4_ref
        args = (pools["qa4"], pools["sa"], pools["qb4"], pools["sb"], pools["code"])
    elif "qa" in pools:
        wrapper, plain = ops.skip_lora_grouped_int8, R.skip_lora_grouped_int8_ref
        args = (pools["qa"], pools["sa"], pools["qb"], pools["sb"])
    else:
        wrapper, plain = ops.skip_lora_grouped, R.skip_lora_grouped_ref
        args = (pools["A"], pools["B"])
    if use_kernel and not fused:
        return wrapper(acts, *args, idx, plan=plan)
    lnum, bsz, s, d = acts.shape
    rows = plain(acts.detach().reshape(lnum, bsz * s, d), *args, idx.repeat_interleave(s))
    return rows.reshape(bsz, s, d)
