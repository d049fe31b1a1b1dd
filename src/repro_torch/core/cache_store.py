"""Disk-backed host tier of the Skip-Cache, with double-buffered prefetch.

Counterpart of ``repro.core.cache_store``. The device-resident ``SkipCache``
works while the whole activation cache fits device memory. Past that, the
cache lives in host memory or on disk, and ``HostCacheStore`` is that tier
for one host:

  - one binary file a sample (crash-safe: a sample is visible only after an
    fsync'd write and an atomic rename), O(1) random access;
  - ``prefetch(ids)`` reads the *next* batch on a background thread while
    the current step runs, so the step sees a host-to-device copy, never
    disk latency;
  - reads return the per-slot batches the cached step consumes, as CPU
    tensors in the slot's dtype.

Slot dtypes are torch dtypes (``lm_skiplora.lm_cache_layout``). numpy has
no bfloat16, so a bf16 slot goes to disk through its 16-bit integer view
and comes back bit for bit; the background thread touches numpy, files and
CPU tensors only, never a CUDA tensor.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

SlotSpec = dict[str, tuple[tuple, torch.dtype]]


def _torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype or anything numpy reads as one."""
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros((0,), np.dtype(dt))).dtype


def _storage_np_dtype(dt: torch.dtype) -> np.dtype:
    """The numpy dtype a slot's bytes are written in (bf16 through int16)."""
    if dt == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.zeros((0,), dtype=dt).numpy().dtype


def to_host_bytes(t, dt: torch.dtype) -> np.ndarray:
    """``t`` (a tensor on any device, or an array) in ``dt``, as the numpy
    array of its bytes (bf16 as its int16 view)."""
    t = torch.as_tensor(t).detach().to("cpu", dt)
    if dt == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def from_host_bytes(a: np.ndarray, dt: torch.dtype) -> torch.Tensor:
    """Inverse of ``to_host_bytes``: a CPU tensor in ``dt``."""
    t = torch.from_numpy(np.array(a, dtype=_storage_np_dtype(dt)))
    return t.view(torch.bfloat16) if dt == torch.bfloat16 else t


class HostCacheStore:
    def __init__(self, directory: str, slot_spec: dict[str, tuple[tuple, Any]]):
        """slot_spec: name -> (per-sample shape, dtype), torch or numpy
        dtypes (``lm_skiplora.lm_cache_layout`` gives torch ones)."""
        self.directory = directory
        self.slot_spec: SlotSpec = {
            name: (tuple(shape), _torch_dtype(dt)) for name, (shape, dt) in slot_spec.items()
        }
        os.makedirs(directory, exist_ok=True)
        self._write_manifest()
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prefetched: Optional[tuple[tuple[int, ...], dict[str, torch.Tensor]]] = None
        self._lock = threading.Lock()

    # -- layout ------------------------------------------------------------

    def _write_manifest(self) -> None:
        manifest = {
            name: {"shape": list(shape), "dtype": str(dt).removeprefix("torch.")}
            for name, (shape, dt) in self.slot_spec.items()
        }
        path = os.path.join(self.directory, "cache_manifest.json")
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump(manifest, f)

    def _sample_path(self, sample_id: int) -> str:
        return os.path.join(self.directory, f"s{sample_id:08d}.bin")

    def _nbytes(self, name: str) -> int:
        shape, dt = self.slot_spec[name]
        return int(np.prod(shape, dtype=np.int64)) * _storage_np_dtype(dt).itemsize

    # -- write path ---------------------------------------------------------

    def flush_batch(self, ids, values: dict[str, Any]) -> None:
        """Persist a batch. values[name]: (B, *slot shape) tensors (on any
        device: the copy to the host happens here) or arrays."""
        host = {name: to_host_bytes(values[name], dt) for name, (_, dt) in self.slot_spec.items()}
        for row, sample_id in enumerate(np.asarray(ids).reshape(-1).tolist()):
            tmp = self._sample_path(sample_id) + ".tmp"
            with open(tmp, "wb") as f:
                for name in sorted(self.slot_spec):
                    arr = host[name][row]
                    want_shape, _ = self.slot_spec[name]
                    if tuple(arr.shape) != want_shape:
                        raise ValueError(f"slot {name}: row shape {tuple(arr.shape)} != {want_shape}")
                    f.write(np.ascontiguousarray(arr).tobytes())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._sample_path(sample_id))

    def has(self, sample_id: int) -> bool:
        return os.path.exists(self._sample_path(sample_id))

    # -- read path ----------------------------------------------------------

    def _read_one(self, sample_id: int) -> dict[str, np.ndarray]:
        with open(self._sample_path(sample_id), "rb") as f:
            raw = f.read()
        out, off = {}, 0
        for name in sorted(self.slot_spec):
            shape, dt = self.slot_spec[name]
            n = self._nbytes(name)
            out[name] = np.frombuffer(raw[off:off + n], dtype=_storage_np_dtype(dt)).reshape(shape)
            off += n
        return out

    def read_batch(self, ids) -> dict[str, torch.Tensor]:
        """Batch read: takes the prefetched batch when it is these ids."""
        key = tuple(int(i) for i in np.asarray(ids).reshape(-1).tolist())
        with self._lock:
            if self._prefetched is not None and self._prefetched[0] == key:
                vals = self._prefetched[1]
                self._prefetched = None
                return vals
        return self._read_batch_sync(key)

    def _read_batch_sync(self, key: tuple[int, ...]) -> dict[str, torch.Tensor]:
        rows = [self._read_one(i) for i in key]
        return {
            name: from_host_bytes(np.stack([r[name] for r in rows]), self.slot_spec[name][1])
            for name in sorted(self.slot_spec)
        }

    def prefetch(self, ids) -> None:
        """Read the next batch on a background thread (double buffering)."""
        key = tuple(int(i) for i in np.asarray(ids).reshape(-1).tolist())

        def work():
            vals = self._read_batch_sync(key)
            with self._lock:
                self._prefetched = (key, vals)

        self.wait()
        self._prefetch_thread = threading.Thread(target=work, daemon=True)
        self._prefetch_thread.start()

    def wait(self) -> None:
        if self._prefetch_thread is not None:
            self._prefetch_thread.join()

    def nbytes_on_disk(self) -> int:
        return sum(
            os.path.getsize(os.path.join(self.directory, f))
            for f in os.listdir(self.directory)
            if f.endswith(".bin")
        )
