"""Tiered Skip-Cache engine: one placement policy over device and host tiers.

Counterpart of ``repro.core.cache_engine``. ``TieredCacheEngine`` puts the
device-resident ``SkipCache`` and the host tiers behind one read / write /
prefetch API:

  - **Device tier**: a fixed-capacity ``SkipCache`` whose rows are *slots*,
    not sample ids; a host-side LRU map assigns sample -> slot, and every
    gather and scatter is ``cache_read`` / ``cache_write``.
  - **Host tier**: takes the LRU spills. In memory (CPU tensors) by default,
    or the crash-safe ``HostCacheStore`` when a directory is given: the same
    bytes either way, so a spilled row reads back bit for bit.
  - **Placement**: ``capacity`` rows, or as many as ``hbm_budget_bytes``
    holds at the per-row footprint. Reads promote host rows back onto the
    device, evicting the least-recently-used resident rows.
  - **Compression**: ``compress="int8"`` stores float slots rowwise-quantised
    (int8 payload + fp32 scales) in both tiers; ``read`` dequantises,
    ``read_raw`` hands the payload over as stored.
  - **Prefetch**: ``prefetch(ids)`` stages the next batch's host rows on a
    background thread, so a step overlapped with it sees a host-to-device
    copy, not disk latency. The thread reads the host tier only and makes no
    CUDA call.

Spills and promotions go through ``cache_read`` / ``cache_write`` and a
``.cpu()`` copy, which waits for the device: a time taken around a spilling
read includes that wait. The engine owns no math.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.cache_store import HostCacheStore, _torch_dtype
from repro_torch.core.skip_cache import SkipCache, cache_read, cache_write

Layout = dict[str, tuple[tuple, Any]]  # name -> (per-sample shape, dtype)


@dataclasses.dataclass
class CacheStats:
    """Per-engine counters (sample granularity, not batch granularity)."""

    hbm_hits: int = 0
    host_hits: int = 0
    staged_hits: int = 0
    spills: int = 0  # rows evicted from the device to the host tier
    writes: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)

    def reads(self) -> int:
        return self.hbm_hits + self.host_hits + self.staged_hits

    def hbm_hit_rate(self) -> float:
        r = self.reads()
        return self.hbm_hits / r if r else 0.0

    def as_rows(self, prefix: str = "cache_engine") -> list[tuple[str, float]]:
        return [
            (f"{prefix}/hbm_hits", float(self.hbm_hits)),
            (f"{prefix}/host_hits", float(self.host_hits)),
            (f"{prefix}/staged_hits", float(self.staged_hits)),
            (f"{prefix}/spills", float(self.spills)),
            (f"{prefix}/hbm_hit_rate", self.hbm_hit_rate()),
        ]


def _ids(idx) -> list[int]:
    """Sample ids from a tensor (any device), an array or a sequence."""
    if isinstance(idx, torch.Tensor):
        return [int(i) for i in idx.reshape(-1).tolist()]
    return [int(i) for i in np.asarray(idx).reshape(-1).tolist()]


# ---------------------------------------------------------------------------
# Host tiers: per-slot batches as CPU tensors
# ---------------------------------------------------------------------------


class MemoryHostTier:
    """In-memory host tier: per-sample CPU tensors (the fast default)."""

    def __init__(self, layout: Layout):
        self.layout = layout
        self._rows: dict[int, dict[str, torch.Tensor]] = {}

    def write(self, ids, values: dict[str, torch.Tensor]) -> None:
        for pos, sid in enumerate(ids):
            self._rows[int(sid)] = {name: values[name][pos].clone() for name in values}

    def read(self, ids) -> dict[str, torch.Tensor]:
        rows = [self._rows[int(i)] for i in ids]
        return {name: torch.stack([r[name] for r in rows]) for name in self.layout}

    def has(self, sample_id: int) -> bool:
        return int(sample_id) in self._rows


class DiskHostTier:
    """Disk-backed host tier: thin adapter over ``HostCacheStore``."""

    def __init__(self, directory: str, layout: Layout):
        self.layout = layout
        self.store = HostCacheStore(directory, layout)

    def write(self, ids, values: dict[str, torch.Tensor]) -> None:
        self.store.flush_batch(np.asarray(list(ids)), values)

    def read(self, ids) -> dict[str, torch.Tensor]:
        return self.store._read_batch_sync(tuple(int(i) for i in ids))

    def has(self, sample_id: int) -> bool:
        return self.store.has(int(sample_id))


# ---------------------------------------------------------------------------
# int8 slot compression (shared by both tiers)
# ---------------------------------------------------------------------------


def _is_compressible(shape: tuple, dtype) -> bool:
    return len(shape) >= 1 and _torch_dtype(dtype).is_floating_point


def storage_layout(layout: Layout, compress: Optional[str]) -> Layout:
    """The physical layout both tiers store. int8: float slot ``x`` becomes
    ``x/q`` (int8 payload) + ``x/s`` (fp32 rowwise scales, last axis dropped)."""
    if compress is None:
        return dict(layout)
    if compress != "int8":
        raise ValueError(f"unknown compression {compress!r}")
    out: Layout = {}
    for name, (shape, dtype) in layout.items():
        if _is_compressible(shape, dtype):
            out[f"{name}/q"] = (tuple(shape), torch.int8)
            out[f"{name}/s"] = (tuple(shape[:-1]), torch.float32)
        else:
            out[name] = (tuple(shape), dtype)
    return out


def _quantize_slot(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.core.lm_skiplora import quantize_int8

    return quantize_int8(x)


def _dequantize_slot(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    from repro_torch.core.lm_skiplora import dequantize_int8

    return dequantize_int8(q, scale, dtype)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class TieredCacheEngine:
    def __init__(
        self,
        num_samples: int,
        layout: Layout,
        *,
        capacity: Optional[int] = None,
        hbm_budget_bytes: Optional[int] = None,
        directory: Optional[str] = None,
        compress: Optional[str] = None,
        device="cuda",
    ):
        if (capacity is None) == (hbm_budget_bytes is None):
            raise ValueError("pass exactly one of capacity / hbm_budget_bytes")
        self.num_samples = num_samples
        self.layout = {n: (tuple(s), _torch_dtype(d)) for n, (s, d) in layout.items()}
        self.compress = compress
        self.device = torch.device(device)
        self._storage = storage_layout(self.layout, compress)
        if capacity is None:
            capacity = max(1, hbm_budget_bytes // self.row_nbytes())
        self.capacity = min(int(capacity), num_samples)

        self._device = SkipCache(
            slots={
                name: torch.zeros((self.capacity,) + shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in self._storage.items()
            },
            valid=torch.zeros((self.capacity,), dtype=torch.bool, device=self.device),
        )
        self._host = (
            DiskHostTier(directory, self._storage)
            if directory is not None
            else MemoryHostTier(self._storage)
        )
        self._lru: OrderedDict[int, int] = OrderedDict()  # sample id -> device row
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        self._present: set[int] = set()

        self._staged: dict[int, dict[str, torch.Tensor]] = {}
        self._prefetch_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.stats = CacheStats()

    def _rows_tensor(self, rows: list[int]) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.long, device=self.device)

    # -- footprint ----------------------------------------------------------

    def row_nbytes(self) -> int:
        return sum(
            math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            for shape, dtype in self._storage.values()
        )

    def hbm_nbytes(self) -> int:
        return self.capacity * self.row_nbytes()

    def resident_ids(self) -> list[int]:
        return list(self._lru.keys())

    def has(self, sample_id: int) -> bool:
        return int(sample_id) in self._present

    # -- compression --------------------------------------------------------

    def _encode(self, values: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Logical batch values -> storage-layout values."""
        if self.compress is None:
            return {n: values[n] for n in self.layout}
        out = {}
        for name, (shape, dtype) in self.layout.items():
            if _is_compressible(shape, dtype):
                q, s = _quantize_slot(values[name])
                out[f"{name}/q"] = q
                out[f"{name}/s"] = s
            else:
                out[name] = values[name]
        return out

    def _decode(self, stored: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Storage-layout batch values -> logical values (dequantised)."""
        if self.compress is None:
            return stored
        out = {}
        for name, (shape, dtype) in self.layout.items():
            if _is_compressible(shape, dtype):
                out[name] = _dequantize_slot(stored[f"{name}/q"], stored[f"{name}/s"], dtype)
            else:
                out[name] = stored[name]
        return out

    def _to_host(self, values: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Storage-layout values as CPU tensors in their slots' dtypes."""
        return {k: torch.as_tensor(v).detach().to("cpu", self._storage[k][1]) for k, v in values.items()}

    # -- placement ----------------------------------------------------------

    def _evict_rows(self, count: int, pinned: set[int]) -> None:
        """Spill the ``count`` least-recently-used unpinned rows to host."""
        victims = [sid for sid in self._lru if sid not in pinned][:count]
        if len(victims) < count:
            raise RuntimeError(
                f"device tier too small: need {count} free rows, capacity "
                f"{self.capacity}, pinned {len(pinned)}"
            )
        vals = cache_read(self._device, self._rows_tensor([self._lru[sid] for sid in victims]))
        self._host.write(victims, self._to_host(vals))
        for sid in victims:
            self._free.append(self._lru.pop(sid))
        self.stats.spills += len(victims)

    def _allocate(self, ids: list[int], pinned: set[int]) -> list[int]:
        need = len(ids) - len(self._free)
        if need > 0:
            self._evict_rows(need, pinned)
        return [self._free.pop() for _ in ids]

    def _ensure_resident(self, ids: list[int]) -> None:
        missing = list(dict.fromkeys(i for i in ids if i not in self._lru))
        if not missing:
            return
        staged_rows, host_ids = {}, []
        with self._lock:
            for i in missing:
                if i in self._staged:
                    staged_rows[i] = self._staged.pop(i)
                else:
                    host_ids.append(i)
        if host_ids:
            self.wait()  # a prefetch in flight may be racing for the same ids
            with self._lock:
                for i in list(host_ids):
                    if i in self._staged:
                        staged_rows[i] = self._staged.pop(i)
                        host_ids.remove(i)
        host_vals = self._host.read(host_ids) if host_ids else None
        self.stats.staged_hits += len(staged_rows)
        self.stats.host_hits += len(host_ids)

        rows = self._allocate(missing, pinned=set(ids))
        batch = {}
        for name in self._storage:
            parts = [
                staged_rows[i][name] if i in staged_rows else host_vals[name][host_ids.index(i)]
                for i in missing
            ]
            batch[name] = torch.stack(parts).to(self.device)
        self._device = cache_write(self._device, self._rows_tensor(rows), batch)
        for i, r in zip(missing, rows):
            self._lru[i] = r

    def _touch(self, ids: list[int]) -> None:
        for i in ids:
            self._lru.move_to_end(i)

    # -- public API ---------------------------------------------------------

    def write(self, idx, values: dict[str, torch.Tensor]) -> None:
        """Place a batch (ingest or populate output). values[name]: (B, *shape).

        New ids land in the device tier; if it is full, LRU rows spill to
        the host first. Ids already resident are overwritten in place.
        """
        ids = _ids(idx)
        stored = self._encode(values)
        # A write supersedes any prefetch staged (or in flight) before it.
        self.wait()
        with self._lock:
            for i in ids:
                self._staged.pop(i, None)
        if len(ids) > self.capacity:
            # The batch can never be resident: write straight to the host tier.
            self._host.write(ids, self._to_host(stored))
            for i in dict.fromkeys(ids):
                if i in self._lru:
                    self._free.append(self._lru.pop(i))  # the host copy is newer
            self._present.update(ids)
            self.stats.writes += len(ids)  # host-direct, not a spill
            return
        resident = [i for i in ids if i in self._lru]
        fresh = list(dict.fromkeys(i for i in ids if i not in self._lru))
        rows_of: dict[int, int] = {i: self._lru[i] for i in resident}
        if fresh:
            for i, r in zip(fresh, self._allocate(fresh, pinned=set(ids))):
                rows_of[i] = r
        stored = {k: torch.as_tensor(v).to(self.device) for k, v in stored.items()}
        self._device = cache_write(self._device, self._rows_tensor([rows_of[i] for i in ids]), stored)
        for i in ids:
            self._lru[i] = rows_of[i]
            self._lru.move_to_end(i)
        self._present.update(ids)
        self.stats.writes += len(ids)

    def _read_oversized(self, ids: list[int]) -> dict[str, torch.Tensor]:
        """A batch larger than the device tier: assemble it without promotion
        (it could never become resident anyway)."""
        resident = [i for i in ids if i in self._lru]
        missing = list(dict.fromkeys(i for i in ids if i not in self._lru))
        self.stats.hbm_hits += len(resident)
        parts: dict[int, dict[str, torch.Tensor]] = {}
        if resident:
            vals = self._to_host(cache_read(self._device, self._rows_tensor([self._lru[i] for i in resident])))
            for pos, i in enumerate(resident):
                parts[i] = {k: v[pos] for k, v in vals.items()}
        if missing:
            self.wait()
            with self._lock:
                for i in list(missing):
                    if i in self._staged:
                        parts[i] = self._staged.pop(i)
                        missing.remove(i)
                        self.stats.staged_hits += 1
        if missing:
            self.stats.host_hits += len(missing)
            vals = self._host.read(missing)
            for pos, i in enumerate(missing):
                parts[i] = {k: vals[k][pos] for k in self._storage}
        return {name: torch.stack([parts[i][name] for i in ids]).to(self.device) for name in self._storage}

    def _read_stored(self, idx) -> dict[str, torch.Tensor]:
        ids = _ids(idx)
        unknown = [i for i in ids if i not in self._present]
        if unknown:
            raise KeyError(f"sample ids never written: {unknown[:8]}")
        if len(ids) > self.capacity:
            return self._read_oversized(ids)
        self.stats.hbm_hits += sum(1 for i in ids if i in self._lru)
        self._ensure_resident(ids)
        self._touch(ids)
        return cache_read(self._device, self._rows_tensor([self._lru[i] for i in ids]))

    def read(self, idx) -> dict[str, torch.Tensor]:
        """Gather a batch in logical layout (dequantised), promoting any
        host-tier rows onto the device."""
        return self._decode(self._read_stored(idx))

    def read_raw(self, idx) -> dict[str, torch.Tensor]:
        """Gather a batch in *storage* layout: with ``compress="int8"`` the
        ``name/q`` / ``name/s`` payload, as an int8 kernel takes it."""
        return self._read_stored(idx)

    def prefetch(self, idx) -> None:
        """Stage host-tier rows for an upcoming batch on a background thread
        (double buffering: overlap with the in-flight adapter step)."""
        ids = _ids(idx)
        with self._lock:
            todo = [i for i in ids if i in self._present and i not in self._lru and i not in self._staged]
        if not todo:
            return

        def work():
            vals = self._host.read(todo)
            with self._lock:
                for pos, i in enumerate(todo):
                    self._staged[i] = {name: vals[name][pos] for name in self._storage}

        self.wait()
        self._prefetch_thread = threading.Thread(target=work, daemon=True)
        self._prefetch_thread.start()

    def wait(self) -> None:
        if self._prefetch_thread is not None:
            self._prefetch_thread.join()

    def flush_to_host(self) -> None:
        """Write every resident row through to the host tier (a persistence
        point; resident rows stay readable from the device)."""
        ids = list(self._lru.keys())
        if not ids:
            return
        vals = cache_read(self._device, self._rows_tensor([self._lru[i] for i in ids]))
        self._host.write(ids, self._to_host(vals))

    def stream_batches(self, idx_mat):
        """Iterate a (steps, batch) id matrix as ``(idx_row, values)`` pairs
        with double-buffered prefetch: batch i+1 is staged on the background
        thread while the caller's step for batch i runs."""
        idx_np = idx_mat.cpu().numpy() if isinstance(idx_mat, torch.Tensor) else np.asarray(idx_mat)
        self.prefetch(idx_np[0])
        for i in range(idx_np.shape[0]):
            vals = self.read(idx_np[i])
            if i + 1 < idx_np.shape[0]:
                self.prefetch(idx_np[i + 1])
            yield idx_np[i], vals

    def tenant_view(self, tenant: int, samples_per_tenant: int) -> "TenantView":
        """Tenant ``t``'s window: the contiguous global id range
        ``[t * samples_per_tenant, (t+1) * samples_per_tenant)``. Views share
        this engine's tiers, LRU and stats (the partition is an id
        convention), so a fleet batch over every tenant is one engine read."""
        if (tenant + 1) * samples_per_tenant > self.num_samples:
            raise ValueError(
                f"tenant {tenant} x {samples_per_tenant} rows exceeds engine size {self.num_samples}"
            )
        return TenantView(self, tenant, samples_per_tenant)

    def export_skipcache(self) -> SkipCache:
        """An id-indexed ``SkipCache`` over all present samples (logical
        layout) on the engine's device: the resident fast path's epochs read
        it directly. It is a second copy of the cache in device memory."""
        out = SkipCache(
            slots={
                name: torch.zeros((self.num_samples,) + shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in self.layout.items()
            },
            valid=torch.zeros((self.num_samples,), dtype=torch.bool, device=self.device),
        )
        ids = sorted(self._present)
        step = max(1, self.capacity)
        for lo in range(0, len(ids), step):
            chunk = ids[lo:lo + step]
            out = cache_write(out, self._rows_tensor(chunk), self.read(chunk))
        return out


# ---------------------------------------------------------------------------
# Fleet partitioning: per-tenant views over one engine
# ---------------------------------------------------------------------------


class TenantView:
    """A tenant's cache partition: local ids ``0..samples_per_tenant-1``
    offset into the owning engine's global id space."""

    def __init__(self, engine: TieredCacheEngine, tenant: int, samples_per_tenant: int):
        self.engine = engine
        self.tenant = tenant
        self.samples_per_tenant = samples_per_tenant
        self.offset = tenant * samples_per_tenant

    def global_ids(self, idx) -> np.ndarray:
        local = np.asarray(_ids(idx), dtype=np.int64)
        if local.size and (local.min() < 0 or local.max() >= self.samples_per_tenant):
            raise IndexError(f"local ids outside tenant partition of {self.samples_per_tenant}")
        return local + self.offset

    def write(self, idx, values) -> None:
        self.engine.write(self.global_ids(idx), values)

    def read(self, idx):
        return self.engine.read(self.global_ids(idx))

    def read_raw(self, idx):
        return self.engine.read_raw(self.global_ids(idx))

    def prefetch(self, idx) -> None:
        self.engine.prefetch(self.global_ids(idx))

    def has(self, sample_id: int) -> bool:
        return self.engine.has(int(sample_id) + self.offset)
