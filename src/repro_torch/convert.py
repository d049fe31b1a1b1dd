"""Carry the reference's pytrees into the port and the port's caches back.

Everything here takes and returns **numpy** arrays and nested dicts/lists,
never JAX objects: the caller does ``np.asarray`` (or ``jax.tree.map(
np.asarray, ...)``) on the reference side. bfloat16 numpy arrays (the
``ml_dtypes`` type JAX hands out) are carried bit for bit.

Layouts:
  - params: the reference's ``init_lm`` tree keeps the layer stack as
    {"periods": [one stacked tree per pattern position], "remainder": [...]}
    (``repro/models/blocks.py:init_stack``); the port keeps one flat list in
    execution order, layer ``l = p * period + i`` then the remainder.
  - adapters: flat {"A": (L, D, R), "B": (L, R, D)}, or a fleet's stacked
    {"A": (N, L, D, R), "B": (N, L, R, D)}, in both packages.
  - pools: ``AdapterPool.pools()`` dicts, float {"A", "B"}, int8
    {"qa", "sa", "qb", "sb"} or 4-bit {"qa4", "sa", "qb4", "sb", "code"}
    (uint8 payloads carried bit for bit), in both packages.
  - KV caches: the port's per-layer list goes back to the reference's
    periods/remainder layout, as float32 (bf16 values are exact in fp32).
    So do its stacked caches {"k", "v"}: (L, B, S, n_kv, hd) and its paged
    KV pool {"k", "v"}: (L, NB, block, n_kv, hd), whose reference
    (``KVBlockPool.data``) is the serve-cache tree with the batch axis read
    as the block axis.
  - the paper's MLP: backbones and ``init_method`` splits are the same
    nested dicts and lists in both packages; a ``DriftedDataset``'s labels
    come across as int64.
  - Skip-Caches: the reference's ``SkipCache`` (``slots`` dict + ``valid``)
    and the port's have the same slots in the same layouts.
  - optimizer states: ``OptState`` (step, mu, nu) in both packages, with
    dicts of arrays (tensors) for the moments.
  - session captures (``SessionRuntime.session_state``): the reference's
    keeps its pool per shard (arrays under "s0", table under "shards") and
    its KV pool in the periods/remainder layout; ``session_from_reference``
    maps a one-shard capture onto the port's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

Params = Any


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def to_tensor(arr, device="cpu") -> torch.Tensor:
    """numpy array (or tensor) -> tensor of the same dtype (bfloat16
    included)."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy; bfloat16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _flat_layers(stack: Params, cfg: ModelConfig) -> list[Params]:
    layers = []
    for p in range(cfg.n_periods):
        for i in range(cfg.period):
            layers.append(_map(lambda x, p=p: x[p], stack["periods"][i]))
    layers.extend(stack["remainder"])
    return layers


def params_from_reference(tree: Params, cfg: ModelConfig, *, device="cpu") -> Params:
    """The reference's ``init_lm`` params (as numpy) -> the port's params."""
    conv = lambda x: to_tensor(x, device)  # noqa: E731
    params = {
        "embed": _map(conv, tree["embed"]),
        "stack": _map(conv, _flat_layers(tree["stack"], cfg)),
        "final_norm": _map(conv, tree["final_norm"]),
    }
    if "head" in tree:
        params["head"] = _map(conv, tree["head"])
    return params


def adapters_from_reference(adapters: Params, *, device="cpu") -> Params:
    """Flat {"A": (L, D, R), "B": (L, R, D)} or stacked fleet {"A": (N, L,
    D, R), "B": (N, L, R, D)} numpy adapters -> tensors."""
    return {k: to_tensor(adapters[k], device) for k in ("A", "B")}


def pools_from_reference(pools: dict, *, device="cpu") -> dict[str, torch.Tensor]:
    """``AdapterPool.pools()`` dict (float, int8 or 4-bit layout) -> tensors."""
    return {k: to_tensor(v, device) for k, v in pools.items()}


def pools_to_reference(pools: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's ``AdapterPool.pools()`` (any layout) -> numpy, for comparing
    with the reference's pool (integer payloads bit for bit)."""
    return {k: to_numpy(v) for k, v in pools.items()}


def caches_to_reference(caches: list[Params], cfg: ModelConfig) -> Params:
    """The port's per-layer KV caches -> the reference's periods/remainder
    layout, as float32 numpy."""
    flat = [_map(to_numpy, c) for c in caches]
    n_per, period = cfg.n_periods, cfg.period
    periods = []
    for i in range(period):
        per_pos = [flat[p * period + i] for p in range(n_per)]
        periods.append({k: np.stack([c[k] for c in per_pos]) for k in per_pos[0]})
    return {"periods": periods, "remainder": flat[n_per * period :]}


def stacked_to_reference(stacked: dict[str, torch.Tensor], cfg: ModelConfig) -> Params:
    """Stacked caches or KV pool data {"k", "v"} with a leading layer axis ->
    the reference's periods/remainder layout, as float32 numpy."""
    return caches_to_reference([{"k": k, "v": v} for k, v in zip(stacked["k"], stacked["v"])], cfg)


def cache_from_reference(cache, *, device="cpu"):
    """The reference's ``SkipCache`` with numpy leaves (``jax.tree.map(
    np.asarray, cache)``) -> the port's ``SkipCache``."""
    from repro_torch.core.skip_cache import SkipCache

    return SkipCache(
        slots={k: to_tensor(v, device) for k, v in cache.slots.items()},
        valid=to_tensor(cache.valid, device),
    )


def cache_to_numpy(cache) -> dict[str, np.ndarray]:
    """The port's ``SkipCache`` -> {slot name: numpy array, "valid": ...}."""
    return {**{k: to_numpy(v) for k, v in cache.slots.items()}, "valid": to_numpy(cache.valid)}


def adapters_to_reference(adapters: Params) -> dict[str, np.ndarray]:
    """The port's adapters, flat or stacked (or any dict of tensors) ->
    numpy, for comparing with the reference's."""
    return {k: to_numpy(v) for k, v in adapters.items()}


def opt_state_to_numpy(state) -> dict[str, Any]:
    """An ``OptState`` of either package -> {"step": int, "mu": ..., "nu": ...}
    with numpy leaves (``None`` where the optimizer keeps no moment)."""
    def conv(x):
        return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)

    return {
        "step": int(conv(state.step)),
        "mu": None if state.mu is None else _map(conv, state.mu),
        "nu": None if state.nu is None else _map(conv, state.nu),
    }


def _stack_layers(kv: dict, cfg: ModelConfig, device) -> dict[str, torch.Tensor]:
    """The reference's KV pool capture ({"periods": {"i": {"k", "v"}},
    "remainder": {"j": ...}}, period leaves (n_periods, NB, block, n_kv, hd))
    -> the port's {"k", "v"}: (L, NB, block, n_kv, hd). The inverse of
    ``stacked_to_reference``."""
    periods = [kv["periods"][str(i)] for i in range(cfg.period)] if cfg.n_periods else []
    layers = [{n: periods[i][n][p] for n in ("k", "v")} for p in range(cfg.n_periods) for i in range(cfg.period)]
    layers += [kv["remainder"][str(j)] for j in range(len(kv.get("remainder", {})))]
    return {n: torch.stack([to_tensor(layer[n], device) for layer in layers]) for n in ("k", "v")}


def session_from_reference(arrays: dict, meta: dict, cfg: ModelConfig, *, device="cpu") -> tuple[dict, dict]:
    """A reference ``session_state`` capture (its ``_load_dict_tree`` gives
    numpy leaves; the port's gives tensors: either works) -> the port's
    (arrays, meta) for ``SessionRuntime.load_session_state``: the pool's
    arrays and table unwrapped from shard 0, adapters and moments through
    ``adapters_from_reference``, cache rows by slot name (the names match),
    the KV pool mapped to {"k", "v"}. A capture of more than one shard is
    refused: the port's session has one (slice 7)."""
    table = meta["pool_table"]
    n_shards = int(meta["layout"].get("n_shards", 1))
    if n_shards != 1 or int(table["n_shards"]) != 1:
        raise ValueError(f"a capture of {n_shards} shards: the port's session has one (slice 7)")
    out: dict = {}
    for name in ("adapters", "opt_mu", "opt_nu"):
        if name in arrays:
            out[name] = adapters_from_reference(arrays[name], device=device)
    out["pool"] = _map(lambda x: to_tensor(x, device), arrays["pool"]["s0"])
    if "cache" in arrays:
        out["cache"] = {k: to_tensor(v, device) for k, v in arrays["cache"].items()}
    new_meta = dict(meta, pool_table=table["shards"][0])
    if "kv_pool" in arrays:
        if set(arrays["kv_pool"]) != {"0"}:
            raise ValueError(f"kv pools of shards {sorted(arrays['kv_pool'])}: the port's session has one")
        out["kv_pool"] = {"0": _stack_layers(arrays["kv_pool"]["0"], cfg, device)}
    return out, new_meta


def mlp_from_reference(backbone: Params, *, device="cpu") -> Params:
    """The reference's MLP backbone ({"fc": [{"W", "b"}], "bn": [{"gamma",
    "beta", "mean", "var"}]}, numpy leaves) -> the port's, as tensors."""
    return _map(lambda x: to_tensor(x, device), backbone)


def method_params_from_reference(trainable: Params, frozen: Params, *, device="cpu") -> tuple[Params, Params]:
    """A reference ``methods.init_method`` split (numpy leaves) -> the port's
    (trainable, frozen): the same nested dicts and lists, as tensors."""
    conv = lambda x: to_tensor(x, device)  # noqa: E731
    return _map(conv, trainable), _map(conv, frozen)


def method_params_to_reference(trainable: Params, frozen: Params) -> tuple[Params, Params]:
    """The port's (trainable, frozen) -> numpy trees in the reference's
    layout. The inverse of ``method_params_from_reference``."""
    return _map(to_numpy, trainable), _map(to_numpy, frozen)


def dataset_from_reference(ds, *, device="cpu"):
    """The reference's ``DriftedDataset`` (arrays or numpy) -> the port's:
    float32 features as they are, labels as int64."""
    from repro_torch.data.synthetic import DriftedDataset

    conv = lambda x, dtype: to_tensor(np.asarray(x), device).to(dtype)  # noqa: E731
    return DriftedDataset(
        ds.name,
        *(conv(getattr(ds, f"{kind}_{split}"), torch.float32 if kind == "x" else torch.long)
          for split in ("pre", "ft", "test") for kind in ("x", "y")),
    )
