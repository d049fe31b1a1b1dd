"""Fault-tolerant checkpointing, the counterpart of ``repro.checkpoint``.

A checkpoint is a directory ``ckpt_%08d``: ``manifest.json`` (step, time,
per-leaf shape and logical dtype, ``extra``, ``"format": 1``) and one
``host_0.npz`` holding every leaf, named by its path in the tree joined with
"/" (dict keys sorted, list indices), exactly as the reference writes it. So
a checkpoint written by either package loads in the other.

  - Writes are atomic: the directory is written as ``<dir>.tmp`` and then
    renamed, so a crashed write never becomes the latest checkpoint.
  - numpy has no bfloat16: such a tensor is stored as the uint16 view of
    its bits, with its logical dtype ("bfloat16") in the manifest, and read
    back through the int16 view, bit for bit.
    Every other leaf keeps numpy's own dtype name ("float32", "int8",
    "uint8", "int32", "bool").
  - ``CheckpointManager`` keeps the last K checkpoints and reaps ``.tmp``
    directories only once they are older than ``tmp_grace_s``.
  - ``save_runtime_session`` / ``restore_runtime_session`` checkpoint a whole
    ``SessionRuntime`` (``session_state`` / ``load_session_state``), one
    shard or several (pools keyed ``s<i>``, KV pools by shard, cache rows
    under global ids); the session's control plane travels in
    ``extra["session"]``. A session restores onto another device count with
    the same logical shards (the elastic path).
  - ``restore_checkpoint(shardings=)`` takes a tree of ``torch.device``
    shaped like ``like``: the port's form of a data-only mesh's shardings
    (every leaf whole on one device).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

Params = Any



def _flatten_with_names(tree: Params, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) pairs in the reference's order: dict keys sorted, list
    and tuple items by index, names joined with "/"; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten_with_names(v, f"{prefix}/{k}" if prefix else k)
    return out


def _unflatten(tree: Params, leaves: dict[str, Any], prefix: str = "") -> Params:
    """``tree``'s structure with each leaf replaced by ``leaves[name]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree))
    return leaves[prefix]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A tensor (or numpy) leaf as the array stored in the npz and its
    logical dtype name."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, logical: str) -> torch.Tensor:
    """A stored array back as a CPU tensor of its logical dtype."""
    if logical == "bfloat16":
        if arr.dtype != np.uint16:
            raise ValueError(f"bfloat16 leaf stored as {arr.dtype}, not as its uint16 bits")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != logical:
        raise ValueError(f"stored {arr.dtype} for logical dtype {logical!r}: unknown to this loader")
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, tree: Params, *, extra: Optional[dict] = None) -> str:
    """Atomic save of a tree of tensors (or numpy arrays) on any device.
    Returns the final checkpoint path."""
    path = os.path.join(directory, f"ckpt_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays, manifest_leaves = {}, {}
    for name, leaf in _flatten_with_names(tree):
        arr, logical = _to_numpy(leaf)
        arrays[name] = arr
        manifest_leaves[name] = {"shape": list(arr.shape), "dtype": logical}
    np.savez(os.path.join(tmp, "host_0.npz"), **arrays)
    manifest = {
        "step": int(step),
        "time": time.time(),
        "leaves": manifest_leaves,
        "extra": extra or {},
        "format": 1,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    cands = sorted(
        d for d in os.listdir(directory)
        if d.startswith("ckpt_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, "manifest.json"))
    )
    return os.path.join(directory, cands[-1]) if cands else None


def _read(path: str) -> tuple[dict, Any]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return manifest, np.load(os.path.join(path, "host_0.npz"))


def restore_checkpoint(path: str, like: Params, *, shardings: Optional[Params] = None) -> tuple[Params, dict]:
    """Restore into the structure of ``like`` (a tree of tensors): each leaf
    comes back as a tensor in the ``like`` leaf's dtype, on the ``like``
    leaf's device or, with ``shardings`` (a tree of ``torch.device`` of the
    same structure), on its device there: the elastic path, where the saved
    devices do not matter. Returns (tree, manifest)."""
    places = {}
    if shardings is not None:
        places = dict(_flatten_with_names(shardings))
        for name, dev in places.items():
            if not isinstance(dev, torch.device):
                raise ValueError(
                    f"shardings[{name!r}] is {type(dev).__name__}: the port's shardings are a tree of "
                    "torch.device (a data-only mesh places every leaf whole on one device)"
                )
    manifest, data = _read(path)
    leaves = {}
    for name, leaf in _flatten_with_names(like):
        t = _from_numpy(data[name], manifest["leaves"][name]["dtype"])
        leaves[name] = t.to(device=places.get(name, leaf.device), dtype=leaf.dtype)
    return _unflatten(like, leaves), manifest


# ---------------------------------------------------------------------------
# Session checkpoints: one capture of a whole SessionRuntime
# ---------------------------------------------------------------------------


def save_runtime_session(directory: str, step: int, runtime, *, extra: Optional[dict] = None) -> str:
    """Checkpoint a whole session (``core.runtime.SessionRuntime``): stacked
    adapters and optimizer moments, the pool's data plane and slot table,
    every present cache row, the KV pool, so a restart resumes serving and
    training without replaying ingestion. Atomic like ``save_checkpoint``;
    the session's control plane travels in ``extra["session"]``."""
    arrays, meta = runtime.session_state()
    return save_checkpoint(directory, step, arrays, extra={"session": meta, **(extra or {})})


def _load_dict_tree(path: str) -> tuple[dict, dict]:
    """The nested dict tree a session save flattened (its names are all dict
    keys without "/"), as CPU tensors of the manifest's logical dtypes
    (bfloat16 through its integer view). Returns (tree, manifest)."""
    manifest, data = _read(path)
    tree: dict = {}
    for name in data.files:
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _from_numpy(data[name], manifest["leaves"][name]["dtype"])
    return tree, manifest


def restore_runtime_session(path: str, runtime) -> dict:
    """Restore a session checkpoint into a *fresh* ``SessionRuntime`` of the
    same configuration. Returns the manifest. Continuing the restored
    session reproduces the uninterrupted run bitwise."""
    tree, manifest = _load_dict_tree(path)
    runtime.load_session_state(tree, manifest["extra"]["session"])
    return manifest


class CheckpointManager:
    """Keep-K rotation and save / restore-latest."""

    def __init__(self, directory: str, *, keep: int = 3, save_every: int = 100, tmp_grace_s: float = 3600.0):
        self.directory = directory
        self.keep = keep
        self.save_every = save_every
        #: how old (mtime) a ``ckpt_*.tmp`` directory must be before gc reaps
        #: it: a younger one may be a concurrent atomic write between its
        #: ``makedirs`` and its rename, which reaping would corrupt
        self.tmp_grace_s = float(tmp_grace_s)
        os.makedirs(directory, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, tree: Params, *, extra: Optional[dict] = None) -> str:
        path = save_checkpoint(self.directory, step, tree, extra=extra)
        self._gc()
        return path

    def restore_latest(self, like: Params, *, shardings: Optional[Params] = None) -> Optional[tuple[Params, dict]]:
        path = latest_checkpoint(self.directory)
        if path is None:
            return None
        return restore_checkpoint(path, like, shardings=shardings)

    def _gc(self) -> None:
        """Drop stale ``.tmp`` directories (crashed writes) and all but the
        newest ``keep`` checkpoints."""
        cands = sorted(d for d in os.listdir(self.directory) if d.startswith("ckpt_"))
        now = time.time()
        for d in cands:
            if d.endswith(".tmp"):
                full = os.path.join(self.directory, d)
                try:
                    age = now - os.path.getmtime(full)
                except OSError:
                    continue   # renamed or removed under us: its writer finished it
                if age >= self.tmp_grace_s:
                    shutil.rmtree(full, ignore_errors=True)
        cands = [d for d in cands if not d.endswith(".tmp")]
        for d in cands[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
