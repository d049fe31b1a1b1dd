"""Synthetic drifted classification datasets (Section 5.1 stand-ins).

Counterpart of ``repro.data.synthetic``. The paper's Damage1/Damage2 (fan
vibration, 256 features, 3 classes) and HAR (561 features, 6 classes)
datasets are not redistributable offline, so we synthesize *structural
twins*: Gaussian-mixture classification with a controlled distribution
drift between the pre-train and fine-tune/test splits. The drift is
composed of
  (1) a random partial rotation of the class-mean geometry,
  (2) a class-conditional mean shift, and
  (3) a covariate noise-scale change,
which mimics "same task, shifted sensing conditions". The *claims*
reproduced on these twins are relational (accuracy collapses before
fine-tuning and recovers after; method ordering and cost ratios), not
absolute accuracies.

The draws come from a ``torch.Generator``; JAX's PRNG cannot be matched, so
a twin made here has the reference's shapes, sizes and drift parameters,
not its numbers. ``convert.dataset_from_reference`` carries the reference's
arrays across where both packages must see the same data.
"""

from __future__ import annotations

import dataclasses
import math
import zlib

import torch


@dataclasses.dataclass(frozen=True)
class DriftedDataset:
    name: str
    x_pre: torch.Tensor
    y_pre: torch.Tensor
    x_ft: torch.Tensor
    y_ft: torch.Tensor
    x_test: torch.Tensor
    y_test: torch.Tensor

    @property
    def n_features(self) -> int:
        return self.x_pre.shape[1]

    @property
    def n_classes(self) -> int:
        return int(torch.max(self.y_pre)) + 1


#: name -> (n_features, n_classes, n_pretrain, n_finetune, n_test)
DATASET_SPECS: dict[str, tuple[int, int, int, int, int]] = {
    "damage1": (256, 3, 470, 470, 470),
    "damage2": (256, 3, 470, 470, 470),
    "har": (561, 6, 5894, 1050, 694),
}


def _sample_mixture(g: torch.Generator, means: torch.Tensor, noise_scale: float, n: int, n_classes: int):
    y = torch.randint(0, n_classes, (n,), generator=g)
    eps = torch.randn((n, means.shape[1]), generator=g) * noise_scale
    return means[y] + eps, y


def _random_rotation(g: torch.Generator, d: int, strength: float) -> torch.Tensor:
    """Partial random rotation: R = exp(strength * (S - S^T)) approximated by
    orthogonalising I + strength*skew (QR)."""
    s = torch.randn((d, d), generator=g) / math.sqrt(d)
    skew = (s - s.T) / 2.0
    q, _ = torch.linalg.qr(torch.eye(d) + strength * skew)
    return q


def make_drifted_dataset(
    generator: torch.Generator,
    name: str = "damage1",
    *,
    class_sep: float = 2.8,
    noise_pre: float = 0.9,
    noise_post: float = 1.0,
    rotation_strength: float = 0.75,
    shift_strength: float = 1.3,
    device="cuda",
) -> DriftedDataset:
    """Build a drifted twin of a paper dataset (see DATASET_SPECS), float32
    features and int64 labels on ``device``. One draw from ``generator``,
    mixed with the name, seeds a CPU generator that makes every array, so
    the same generator state gives the same dataset on any device."""
    if name not in DATASET_SPECS:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(DATASET_SPECS)}")
    d, c, n_pre, n_ft, n_test = DATASET_SPECS[name]
    # Distinct twin per dataset name (damage1 vs damage2 share a spec but
    # must differ in geometry, like the paper's two damage types).
    # zlib.crc32 is stable across processes (str hash is randomised).
    base = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
    g = torch.Generator().manual_seed((base + zlib.crc32(name.encode())) % 2**63)

    means = torch.randn((c, d), generator=g) * class_sep / math.sqrt(d) * math.sqrt(d)
    means = means / torch.linalg.norm(means, dim=1, keepdim=True) * class_sep

    rot = _random_rotation(g, d, rotation_strength)
    shift = torch.randn((c, d), generator=g)
    shift = shift / torch.linalg.norm(shift, dim=1, keepdim=True) * shift_strength
    means_drift = means @ rot + shift

    x_pre, y_pre = _sample_mixture(g, means, noise_pre, n_pre, c)
    x_ft, y_ft = _sample_mixture(g, means_drift, noise_post, n_ft, c)
    x_test, y_test = _sample_mixture(g, means_drift, noise_post, n_test, c)
    arrays = [t.to(device) for t in (x_pre, y_pre, x_ft, y_ft, x_test, y_test)]
    return DriftedDataset(name, *arrays)
