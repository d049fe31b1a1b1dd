"""Assigned input shapes and per-cell support rules.

A copy of ``repro.launch.shapes`` over the port's own config registry (the
port imports nothing of the JAX package); ``tests/test_torch_launch.py``
holds every cell equal to the reference's.

LM transformer shapes are seq_len x global_batch. ``decode_*`` / ``long_*``
lower ``serve_decode`` (one new token against a KV/state cache of seq_len),
``prefill_32k`` lowers ``serve_prefill``, ``train_4k`` lowers ``train_step``.
``long_500k`` requires sub-quadratic attention: only the SSM/hybrid archs
run it (DESIGN.md §5 records the 8 documented skips).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.registry import SUBQUADRATIC_ARCHS, get_config


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    """(supported, reason-if-not)."""
    if shape == "long_500k" and arch not in SUBQUADRATIC_ARCHS:
        cfg = get_config(arch)
        return False, (
            f"{arch} has full global attention layers (family={cfg.family}); "
            "long_500k needs sub-quadratic attention — documented skip"
        )
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    from repro_torch.configs.registry import list_archs

    return [(a, s) for a in list_archs() for s in SHAPES]


def live_cells() -> list[tuple[str, str]]:
    return [(a, s) for a, s in all_cells() if cell_supported(a, s)[0]]
