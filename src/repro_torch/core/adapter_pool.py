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

Not ported yet: the checkpoint plane (``state_arrays`` / ``load_state`` /
``slot_table``), the dense ``fused`` skip-sum and ``ShardedAdapterPool``.
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
        self.stats = PoolStats()

    # -- capacity -----------------------------------------------------------

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
        layout: float {"A", "B"}; int8 {"qa", "sa", "qb", "sb"}; 4-bit
        {"qa4", "sa", "qb4", "sb", "code"} (``code`` is the 16-entry codebook
        that tells int4 from nf4). Writes go in place, so the dict stays live
        across registrations."""
        return dict(self._arrays)


def grouped_skip_sum(
    acts: torch.Tensor, pools: dict[str, torch.Tensor], idx: torch.Tensor
) -> torch.Tensor:
    """Per-row skip-sum over a stacked pool: picks the float, int8 or 4-bit
    layout and forwards to the grouped wrappers, which own the row
    flattening and the kernel / plain-version dispatch. acts: (L, B, S, D);
    idx: (B,) -> (B, S, D)."""
    from repro_torch.kernels.skip_lora.ops import (
        skip_lora_grouped,
        skip_lora_grouped_int8,
        skip_lora_grouped_q4,
    )

    if "qa4" in pools:
        return skip_lora_grouped_q4(
            acts, pools["qa4"], pools["sa"], pools["qb4"], pools["sb"], pools["code"], idx
        )
    if "qa" in pools:
        return skip_lora_grouped_int8(
            acts, pools["qa"], pools["sa"], pools["qb"], pools["sb"], idx
        )
    return skip_lora_grouped(acts, pools["A"], pools["B"], idx)
