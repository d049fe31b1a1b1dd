"""Architecture registry + reduced-config factory for smoke tests."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig, XLSTMConfig

#: arch id -> config module
ARCH_IDS: dict[str, str] = {
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
}

#: archs whose attention is sub-quadratic end-to-end (run long_500k).
SUBQUADRATIC_ARCHS = ("xlstm-350m", "jamba-1.5-large-398b")


def list_archs() -> list[str]:
    return sorted(ARCH_IDS)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; options: {list_archs()}")
    return importlib.import_module(ARCH_IDS[arch]).CONFIG


def reduce_config(cfg: ModelConfig, *, n_periods: int = 2) -> ModelConfig:
    """Shrink a config for CPU smoke tests while preserving its *family
    structure* (pattern, GQA ratio, gating, softcaps, MoE top-k, frontend).
    """
    period = cfg.period
    heads = max(2, min(4, cfg.n_heads))
    kv_ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    kv = max(1, heads // kv_ratio)
    d_model = 16 * heads
    updates: dict = dict(
        n_layers=period * n_periods + len(cfg.remainder_pattern),
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=(32 if cfg.head_dim else 0),
        d_ff=(64 if cfg.d_ff else 0),
        vocab_size=503,
        sliding_window=(8 if cfg.sliding_window else 0),
        frontend_seq=(8 if cfg.frontend else 0),
        dtype="float32",
    )
    if cfg.moe is not None:
        updates["moe"] = MoEConfig(
            n_experts=min(8, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k),
            d_ff_expert=32,
            n_shared=min(1, cfg.moe.n_shared),
            shared_d_ff=(64 if cfg.moe.n_shared else 0),
            capacity_factor=2.0,
            every_k_layers=cfg.moe.every_k_layers,
        )
    if cfg.mamba is not None:
        updates["mamba"] = MambaConfig(d_state=4, d_conv=4, expand=2)
    if cfg.xlstm is not None:
        updates["xlstm"] = cfg.xlstm
    return dataclasses.replace(cfg, **updates)
