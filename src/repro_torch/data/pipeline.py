"""Deterministic, resumable token data pipeline.

A copy of ``repro.data.pipeline`` (numpy only), so both packages draw the
same tokens and the same epoch orders from one seed.

Production shape: an index-based sampler (deterministic in (seed, step)) over
a memory-mappable token store, yielding host-sharded batches. Here the store
is a synthetic corpus generator (offline container), but the contract is the
real one:

  - O(1) random access by sample id (the Skip-Cache needs stable ids!),
  - iterator state = (seed, step) only -> checkpointable / restartable,
  - per-host slicing for multi-host launches (each host feeds its devices).

The Skip2-LoRA fine-tune loop additionally needs *epoch-partitioned*
visitation (populate epoch sees each sample exactly once), provided by
``epoch_permutation``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_samples: int
    seed: int = 0
    host_count: int = 1
    host_index: int = 0


class SyntheticTokenStore:
    """Deterministic synthetic corpus with O(1) access by sample id.

    Samples are Zipf-ish token sequences with a per-sample Markov flavour so
    the LM loss actually decreases during the examples' fine-tuning runs.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def __len__(self) -> int:
        return self.cfg.num_samples

    def get(self, idx: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ idx)
        # Zipf-distributed tokens, clipped to vocab.
        toks = rng.zipf(1.3, size=cfg.seq_len + 1).astype(np.int64)
        toks = (toks - 1) % cfg.vocab_size
        # Inject per-sample periodic structure (learnable signal).
        period = 3 + idx % 5
        anchor = (idx * 2654435761) % cfg.vocab_size
        toks[::period] = (anchor + np.arange(len(toks[::period]))) % cfg.vocab_size
        return toks.astype(np.int32)

    def batch(self, ids: np.ndarray) -> dict[str, np.ndarray]:
        toks = np.stack([self.get(int(i)) for i in ids])
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "sample_ids": ids.astype(np.int32),
        }


@dataclasses.dataclass
class SamplerState:
    """Fully describes the iterator position — checkpoint this."""

    seed: int
    step: int
    epoch: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    return np.random.default_rng((seed << 10) ^ epoch).permutation(n)


class BatchSampler:
    """Deterministic batch-id sampler with host sharding + resume."""

    def __init__(self, cfg: DataConfig, state: Optional[SamplerState] = None):
        self.cfg = cfg
        self.state = state or SamplerState(seed=cfg.seed, step=0)

    @property
    def steps_per_epoch(self) -> int:
        return self.cfg.num_samples // self.cfg.global_batch

    def next_ids(self) -> np.ndarray:
        """Global batch ids for the current step (then advances)."""
        cfg = self.cfg
        spe = max(1, self.steps_per_epoch)
        epoch = self.state.step // spe
        pos = self.state.step % spe
        perm = epoch_permutation(self.state.seed, epoch, cfg.num_samples)
        ids = perm[pos * cfg.global_batch : (pos + 1) * cfg.global_batch]
        self.state = SamplerState(self.state.seed, self.state.step + 1, epoch)
        return ids

    def host_slice(self, ids: np.ndarray) -> np.ndarray:
        """This host's shard of the global batch."""
        per_host = len(ids) // self.cfg.host_count
        lo = self.cfg.host_index * per_host
        return ids[lo : lo + per_host]

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next_ids()


def make_pipeline(cfg: DataConfig, state: Optional[SamplerState] = None):
    """(store, sampler) pair — the canonical construction."""
    return SyntheticTokenStore(cfg), BatchSampler(cfg, state)
