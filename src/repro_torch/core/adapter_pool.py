"""Adapter pool: slot-based registry of per-tenant Skip-LoRA stacks.

Counterpart of ``repro.core.adapter_pool`` on one device. Serving applies a
*different* adapter stack per batch row, and the skip topology taps every
layer, so the adapters stay in a stacked device-resident pool

    A: (n_slots, L, D, R)    B: (n_slots, L, R, D)

indexed per row by the grouped skip-sum kernels. A host-side LRU map
assigns tenant -> slot, and registration past capacity evicts the
least-recently-served unpinned tenant. Slot 0 is pinned all-zeros: the "no
adapter" tenant, so base-model rows ride the same batched kernel.

``compress="int8"`` stores the pool rowwise-quantised (int8 payload + fp32
scales over the last axis), fed raw to ``skip_lora_grouped_int8``, which
dequantises inside the kernel.

Not ported yet: version history and ``rollback``, batched registration,
4-bit pools, the dense ``fused`` skip-sum and ``ShardedAdapterPool``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Optional

import torch

from repro_torch.core.lm_skiplora import quantize_int8
from repro_torch.models.config import ModelConfig

Params = Any

#: pinned all-zeros slot: rows with no registered adapter (base model).
ZERO_SLOT = 0


@dataclasses.dataclass
class PoolStats:
    registrations: int = 0
    evictions: int = 0
    lookups: int = 0
    misses: int = 0


class AdapterPool:
    """Fixed-capacity device pool of per-tenant adapter stacks.

    Data plane: stacked tensors consumed directly by the grouped kernels.
    Control plane: host-side LRU tenant->slot map."""

    def __init__(
        self,
        n_slots: int,
        cfg: ModelConfig,
        rank: int,
        *,
        compress: Optional[str] = None,
        dtype=torch.float32,
        device="cuda",
    ):
        if n_slots < 2:
            raise ValueError("need >= 2 slots (slot 0 is pinned to zeros)")
        if compress not in (None, "int8"):
            raise ValueError(f"unknown or unported compression {compress!r}")
        self.n_slots = n_slots
        self.rank = rank
        self.compress = compress
        self.device = torch.device(device)
        l, d, r = cfg.n_layers, cfg.d_model, rank
        self._shape_a, self._shape_b = (l, d, r), (l, r, d)

        def z(shape, dt):
            return torch.zeros((n_slots,) + shape, dtype=dt, device=self.device)

        if compress == "int8":
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
        self.stats = PoolStats()

    # -- capacity -----------------------------------------------------------

    def tenants(self) -> list:
        return list(self._lru.keys())

    def has(self, tenant) -> bool:
        return tenant in self._lru

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self._arrays.values())

    # -- registration -------------------------------------------------------

    def _write_slot(self, slot: int, adapters: Params) -> None:
        """In-place write of one slot: O(L*D*R), never a pool copy."""
        a = torch.as_tensor(adapters["A"]).to(self.device, torch.float32)
        b = torch.as_tensor(adapters["B"]).to(self.device, torch.float32)
        if tuple(a.shape) != self._shape_a or tuple(b.shape) != self._shape_b:
            raise ValueError(
                f"adapter shapes {tuple(a.shape)}/{tuple(b.shape)} != pool "
                f"{self._shape_a}/{self._shape_b}"
            )
        if self.compress == "int8":
            qa, sa = quantize_int8(a)
            qb, sb = quantize_int8(b)
            for name, val in (("qa", qa), ("sa", sa), ("qb", qb), ("sb", sb)):
                self._arrays[name][slot] = val
        else:
            self._arrays["A"][slot] = a.to(self._arrays["A"].dtype)
            self._arrays["B"][slot] = b.to(self._arrays["B"].dtype)

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
            self.stats.evictions += 1
        self._lru[tenant] = slot
        return slot

    def register(self, tenant, adapters: Params) -> int:
        """Install a tenant's {"A": (L,D,R), "B": (L,R,D)} stack (tensors or
        numpy arrays). Re-registering overwrites the tenant's slot in place;
        a full pool evicts the least-recently-served unpinned tenant."""
        slot = self._assign_slot(tenant)
        self._write_slot(slot, adapters)
        self.stats.registrations += 1
        return slot

    def evict(self, tenant) -> None:
        if tenant in self._pinned:
            raise ValueError(f"tenant {tenant!r} is pinned; unpin before evicting")
        self._free.append(self._lru.pop(tenant))
        self.stats.evictions += 1

    # -- pinning ------------------------------------------------------------

    def pin(self, tenant) -> None:
        """Exclude a registered tenant's slot from LRU eviction."""
        if tenant not in self._lru:
            raise KeyError(f"tenant {tenant!r} has no registered adapters to pin")
        self._pinned.add(tenant)

    def unpin(self, tenant) -> None:
        self._pinned.discard(tenant)

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

    # -- data plane ---------------------------------------------------------

    def pools(self) -> dict[str, torch.Tensor]:
        """The stacked tensors the grouped kernels consume, in storage
        layout: float {"A", "B"}; int8 {"qa", "sa", "qb", "sb"}. Writes go
        in place, so the dict stays live across registrations."""
        return dict(self._arrays)


def grouped_skip_sum(
    acts: torch.Tensor, pools: dict[str, torch.Tensor], idx: torch.Tensor
) -> torch.Tensor:
    """Per-row skip-sum over a stacked pool: picks the float or int8 layout
    and forwards to the grouped wrappers, which own the row flattening and
    the kernel / plain-version dispatch. acts: (L, B, S, D); idx: (B,) ->
    (B, S, D)."""
    from repro_torch.kernels.skip_lora.ops import skip_lora_grouped, skip_lora_grouped_int8

    if "qa" in pools:
        return skip_lora_grouped_int8(
            acts, pools["qa"], pools["sa"], pools["qb"], pools["sb"], idx
        )
    return skip_lora_grouped(acts, pools["A"], pools["B"], idx)
