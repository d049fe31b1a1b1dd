"""Analytic compute/memory cost model for FC layers and LoRA adapters.

A copy of ``repro.core.compute_model`` (framework-free), so the port
predicts the same FLOPs as the reference.

Implements the taxonomy of Table 1 of the paper (the paper omits the
closed-form costs "due to the page limitation"; we derive them from
Equations 1-16):

FC layer, input N, output M, batch B (MACs counted as 2 FLOPs):
    y  = G(x W + b)        : 2 B N M            (Eq. 1)
    gW = x^T gy            : 2 B N M            (Eq. 2)
    gb = sum_B gy          : B M                (Eq. 3)
    gx = gy W^T            : 2 B N M            (Eq. 4)
    update W,b             : 2 (N M + M)        (Eq. 5-6)

LoRA adapter rank R on that FC:
    y_A = x W_A            : 2 B N R            (Eq. 7)
    y_B = y_A W_B ; y+=y_B : 2 B R M + B M      (Eq. 8-9)
    gW_B = y_A^T gy        : 2 B R M            (Eq. 10)
    gx_B = gy W_B^T        : 2 B R M            (Eq. 11)
    gW_A = x^T gx_B        : 2 B N R            (Eq. 12)
    gx_A = gx_B W_A^T      : 2 B N R            (Eq. 13)
    gx += gx_A             : B N                (Eq. 14)
    update W_A,W_B         : 2 (N R + R M)      (Eq. 15-16)

Compute types (Table 1) select which of these terms a layer pays under a
given fine-tuning method. These closed forms back the Table-2/6/7 ratio
reproduction in benchmarks/ and the roofline sanity checks.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence


class FCType(enum.Enum):
    """Compute types of FC layers (upper half of Table 1)."""

    Y = "fc_y"          # forward only
    YWBX = "fc_ywbx"    # y, gW, gb, gx
    YWB = "fc_ywb"      # y, gW, gb      (first layer: gx not propagated)
    YBX = "fc_ybx"      # y, gb, gx
    YB = "fc_yb"        # y, gb
    YX = "fc_yx"        # y, gx
    NONE = "fc_none"    # layer skipped entirely (cache hit)


class LoRAType(enum.Enum):
    """Compute types of LoRA adapters (lower half of Table 1)."""

    NONE = "lora_none"   # no adapter (phi in the paper)
    Y = "lora_y"         # forward only (serving with adapters)
    YWX = "lora_ywx"     # yA, yB, gWB, gWA, gxB, gxA
    YW = "lora_yw"       # yA, yB, gWB, gWA, gxB (no gx propagation needed)


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """FLOPs for one layer under one compute type, split by phase."""

    forward: float
    backward: float
    update: float

    @property
    def total(self) -> float:
        return self.forward + self.backward + self.update

    def __add__(self, other: "LayerCost") -> "LayerCost":
        return LayerCost(
            self.forward + other.forward,
            self.backward + other.backward,
            self.update + other.update,
        )


ZERO_COST = LayerCost(0.0, 0.0, 0.0)


def fc_cost(fc_type: FCType, batch: int, n: int, m: int) -> LayerCost:
    """FLOPs of an FC layer of shape (n -> m) under ``fc_type``."""
    b = float(batch)
    fwd_y = 2.0 * b * n * m
    bwd_gw = 2.0 * b * n * m
    bwd_gb = b * m
    bwd_gx = 2.0 * b * n * m
    upd = 2.0 * (n * m + m)
    if fc_type is FCType.NONE:
        return ZERO_COST
    if fc_type is FCType.Y:
        return LayerCost(fwd_y, 0.0, 0.0)
    if fc_type is FCType.YWBX:
        return LayerCost(fwd_y, bwd_gw + bwd_gb + bwd_gx, upd)
    if fc_type is FCType.YWB:
        return LayerCost(fwd_y, bwd_gw + bwd_gb, upd)
    if fc_type is FCType.YBX:
        return LayerCost(fwd_y, bwd_gb + bwd_gx, 2.0 * m)
    if fc_type is FCType.YB:
        return LayerCost(fwd_y, bwd_gb, 2.0 * m)
    if fc_type is FCType.YX:
        return LayerCost(fwd_y, bwd_gx, 0.0)
    raise ValueError(f"unknown fc type {fc_type}")


def lora_cost(lora_type: LoRAType, batch: int, n: int, m: int, rank: int) -> LayerCost:
    """FLOPs of a rank-``rank`` LoRA adapter on an (n -> m) FC."""
    b = float(batch)
    fwd = 2.0 * b * n * rank + 2.0 * b * rank * m + b * m
    bwd_gwb = 2.0 * b * rank * m
    bwd_gxb = 2.0 * b * rank * m
    bwd_gwa = 2.0 * b * n * rank
    bwd_gxa = 2.0 * b * n * rank + b * n
    upd = 2.0 * (n * rank + rank * m)
    if lora_type is LoRAType.NONE:
        return ZERO_COST
    if lora_type is LoRAType.Y:
        return LayerCost(fwd, 0.0, 0.0)
    if lora_type is LoRAType.YWX:
        return LayerCost(fwd, bwd_gwb + bwd_gxb + bwd_gwa + bwd_gxa, upd)
    if lora_type is LoRAType.YW:
        return LayerCost(fwd, bwd_gwb + bwd_gxb + bwd_gwa, upd)
    raise ValueError(f"unknown lora type {lora_type}")


def bn_cost(batch: int, m: int, trainable: bool, needs_gx: bool) -> LayerCost:
    """Inference-mode batchnorm: y = gamma * (x - mu) / sigma + beta."""
    b = float(batch)
    fwd = 4.0 * b * m
    bwd = 0.0
    if needs_gx:
        bwd += 2.0 * b * m          # gx = gy * gamma / sigma
    if trainable:
        bwd += 3.0 * b * m          # g_gamma = sum(gy * xhat), g_beta = sum(gy)
    upd = 4.0 * m if trainable else 0.0
    return LayerCost(fwd, bwd, upd)


def act_cost(batch: int, m: int, needs_gx: bool) -> LayerCost:
    """ReLU: 1 FLOP/elt forward, 1 FLOP/elt backward mask."""
    b = float(batch)
    return LayerCost(b * m, (b * m) if needs_gx else 0.0, 0.0)


# ---------------------------------------------------------------------------
# Method-level compositions (Section 3 of the paper).
# ---------------------------------------------------------------------------

#: method name -> (fc types per layer position, lora types per layer position)
#: Layer positions are described for an n-layer net as first / middle / last.


def method_layer_types(
    method: str, n_layers: int
) -> tuple[list[FCType], list[LoRAType]]:
    """FC/LoRA compute types per layer for each fine-tuning method.

    Mirrors Section 3 / Figure 1 of the paper for arbitrary depth n:
    e.g. FT-All is {FC_ywb, FC_ywbx, ..., FC_ywbx}.
    """
    n = n_layers
    if method == "ft_all":
        fcs = [FCType.YWB] + [FCType.YWBX] * (n - 1)
        loras = [LoRAType.NONE] * n
    elif method == "ft_last":
        fcs = [FCType.Y] * (n - 1) + [FCType.YWB]
        loras = [LoRAType.NONE] * n
    elif method == "ft_bias":
        fcs = [FCType.YB] + [FCType.YBX] * (n - 1)
        loras = [LoRAType.NONE] * n
    elif method == "ft_all_lora":
        # FT-All + LoRA-All (the paper's full-cost upper bound, Table 2).
        fcs = [FCType.YWB] + [FCType.YWBX] * (n - 1)
        loras = [LoRAType.YW] + [LoRAType.YWX] * (n - 1)
    elif method == "lora_all":
        fcs = [FCType.Y] + [FCType.YX] * (n - 1)
        loras = [LoRAType.YW] + [LoRAType.YWX] * (n - 1)
    elif method == "lora_last":
        fcs = [FCType.Y] * n
        loras = [LoRAType.NONE] * (n - 1) + [LoRAType.YW]
    elif method in ("skip_lora", "skip2_lora"):
        fcs = [FCType.Y] * n
        loras = [LoRAType.YW] * n
    else:
        raise ValueError(f"unknown method {method!r}")
    return fcs, loras


def method_cost(
    method: str,
    batch: int,
    dims: Sequence[int],
    rank: int,
    *,
    bn: bool = True,
    cache_hit_rate: float = 0.0,
) -> LayerCost:
    """Total per-batch FLOPs for ``method`` on an MLP with layer ``dims``.

    ``dims`` is (d0, d1, ..., dn): layer k maps dims[k-1] -> dims[k].
    ``cache_hit_rate`` only affects skip2_lora: a hit skips the FC forward of
    all layers; the last layer's base output is reused from cache and only
    the adapter sum + re-add is recomputed (Section 4.2).
    """
    n = len(dims) - 1
    fcs, loras = method_layer_types(method, n)
    total = ZERO_COST
    for k in range(n):
        nk, mk = dims[k], dims[k + 1]
        fck = fc_cost(fcs[k], batch, nk, mk)
        if method == "skip2_lora":
            # Expected cost: miss fraction pays full FC forward; hits skip it.
            fck = LayerCost(
                fck.forward * (1.0 - cache_hit_rate), fck.backward, fck.update
            )
        total = total + fck
        # Skip-LoRA adapters map layer-k INPUT -> last-layer output: (nk -> dims[n]).
        if method in ("skip_lora", "skip2_lora"):
            total = total + lora_cost(loras[k], batch, nk, dims[n], rank)
        else:
            total = total + lora_cost(loras[k], batch, nk, mk, rank)
        if bn and k < n - 1:
            # Hidden layers have BN + ReLU (Table 2 structure).
            trainable = method == "ft_bias"
            needs_gx = fcs[k + 1] not in (FCType.Y, FCType.YB, FCType.NONE) or (
                loras[k + 1] in (LoRAType.YWX,)
            )
            bnk = bn_cost(batch, mk, trainable, needs_gx)
            actk = act_cost(batch, mk, needs_gx)
            if method == "skip2_lora":
                bnk = LayerCost(bnk.forward * (1.0 - cache_hit_rate), bnk.backward, bnk.update)
                actk = LayerCost(actk.forward * (1.0 - cache_hit_rate), actk.backward, actk.update)
            total = total + bnk + actk
    return total


def expected_hit_rate(epochs: int) -> float:
    """Expected cache hit rate over an E-epoch run: epoch 1 misses, rest hit."""
    if epochs <= 0:
        return 0.0
    return (epochs - 1.0) / float(epochs)


def trainable_param_count(method: str, dims: Sequence[int], rank: int) -> int:
    """Number of trainable parameters for a method (paper parity checks)."""
    n = len(dims) - 1
    total = 0
    if method == "ft_all":
        total = sum(dims[k] * dims[k + 1] + dims[k + 1] for k in range(n))
        total += sum(2 * dims[k + 1] for k in range(n - 1))  # BN gamma/beta
    elif method == "ft_last":
        total = dims[n - 1] * dims[n] + dims[n]
    elif method == "ft_bias":
        total = sum(dims[k + 1] for k in range(n))
        total += sum(2 * dims[k + 1] for k in range(n - 1))
    elif method == "ft_all_lora":
        total = trainable_param_count("ft_all", dims, rank) + trainable_param_count(
            "lora_all", dims, rank
        )
    elif method == "lora_all":
        total = sum(dims[k] * rank + rank * dims[k + 1] for k in range(n))
    elif method == "lora_last":
        total = dims[n - 1] * rank + rank * dims[n]
    elif method in ("skip_lora", "skip2_lora"):
        total = sum(dims[k] * rank + rank * dims[n] for k in range(n))
    else:
        raise ValueError(f"unknown method {method!r}")
    return int(total)
