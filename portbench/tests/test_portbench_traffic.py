"""The traffic generators: deterministic per seed, the parameters the
cells state, the same work for every seed."""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from portbench import harness as H
from portbench.drivers.sched import PER_CLIENT, Traffic, client_tenants, lognormal_lengths
from portbench.drivers.train import Driver as TrainDriver


#: clients sharing a per-tenant system prompt: the chat mix with a 448-token
#: prefix, turns of 16-64 tokens and answers of 4-32 (a cell for later)
SHARED_PROMPT = {"base_rank": None, "shared_prefix": 448, "prompt": {"mean": 40, "std": 24, "lo": 16},
                 "new_tokens": {"mean": 18, "std": 10, "lo": 4}}


def _traffic(name: str, seed: int, vocab: int = 151936) -> Traffic:
    tr = H.read_json(H.HERE / "traffic" / "chat_closed.json")
    if name == "shared_prompt":
        tr.update(SHARED_PROMPT)
        tr["scheduler"] = dict(tr["scheduler"], admit_bucket=8, max_new_cap=32)
    return Traffic(tr, vocab, seed)


def test_same_seed_same_requests():
    a, b = _traffic("chat_closed", 2**31 + 7), _traffic("chat_closed", 2**31 + 7)
    for c, k in [(0, 0), (5, 3), (47, 11)]:
        ta, pa, na = a.request(c, k)
        tb, pb, nb = b.request(c, k)
        assert ta == tb and na == nb and np.array_equal(pa, pb)
    assert a.tenant_of == b.tenant_of


def test_request_order_does_not_change_a_request():
    t = _traffic("chat_closed", 99)
    first = t.request(3, 2)
    t.request(1, 0), t.request(7, 5)
    again = t.request(3, 2)
    assert first[0] == again[0] and np.array_equal(first[1], again[1])


def test_every_seed_gets_the_same_work():
    """Lengths, their order and the clients' tenants are the seed's to keep;
    only the token ids change."""
    a, b = _traffic("chat_closed", 1), _traffic("chat_closed", 2)
    assert np.array_equal(a.own, b.own) and np.array_equal(a.new, b.new) and a.tenant_of == b.tenant_of
    ra, rb = a.request(4, 2), b.request(4, 2)
    assert len(ra[1]) == len(rb[1]) and ra[2] == rb[2] and not np.array_equal(ra[1], rb[1])


def test_chat_parameters():
    """LMSYS-Chat-1M's per-turn lengths cut at the scheduler's caps, and
    Punica's Zipf 1.5 over 8 adapters and the base model at rank 9."""
    t = _traffic("chat_closed", 5)
    assert len(t.tenant_of) == 48 and len(t.own) == 48 * PER_CLIENT
    assert t.own.min() >= 1 and t.own.max() == 512 and t.new.min() >= 1 and t.new.max() == 128
    assert 25 <= np.median(t.own) <= 35 and 55 <= t.own.mean() <= 70      # median 30.3 of the uncut law
    assert 0.55 <= (t.new == 128).mean() <= 0.7 and 0.01 <= (t.own == 512).mean() <= 0.02
    counts = Counter(t.tenant_of)
    assert [counts[i] for i in range(8)] + [counts[None]] == [24, 9, 5, 3, 2, 2, 1, 1, 1]
    _, prompt, new = t.request(0, 0)
    assert 1 <= len(prompt) <= 512 and 1 <= new <= 128


def test_shared_prompt_parameters():
    t = _traffic("shared_prompt", 5, vocab=100352)
    assert None not in t.tenant_of and set(t.tenant_of) == set(range(8))
    for c in range(48):
        tenant, prompt, new = t.request(c, 1)
        assert np.array_equal(prompt[:448], t.prefix[tenant])
        assert 16 <= len(prompt) - 448 <= 64 and 4 <= new <= 32 and len(prompt) <= 512


@pytest.mark.parametrize("mean,std", [(69.5, 143.3), (214.5, 188.8)])
def test_lognormal_lengths_and_counts(mean, std):
    g = lognormal_lengths(mean, std, 1, 10**9, 20000)
    assert abs(g.mean() - mean) < 0.03 * mean and abs(g.std() - std) < 0.15 * std
    assert np.array_equal(g, np.sort(g)) and lognormal_lengths(69.5, 143.3, 5, 9, 100).tolist()[::99] == [5, 9]
    assert Counter(client_tenants(48, 8, None, 1.1)).total() == 48
    assert client_tenants(10, 2, 1, 1.0) == [None] * 5 + [0] * 3 + [1] * 2


def test_warmup_reaches_both_ends():
    t = _traffic("shared_prompt", 3, vocab=100352)
    waves = t.warmup()
    lens = [len(p) - 448 for w in waves for _, p, _ in w]
    assert min(lens) == 16 and max(lens) == 64
    assert {tn for tn, _, _ in waves[0]} == set(t.tenant_of)


def test_training_rows_are_seeded():
    tr = H.read_json(H.HERE / "traffic" / "fleet_adapt.json")
    cfg = {"vocab_size": 1000}
    a = TrainDriver(cfg, tr, 2**32 + 3, "cpu", None).rows(4, 8)
    b = TrainDriver(cfg, tr, 2**32 + 3, "cpu", None).rows(4, 8)
    c = TrainDriver(cfg, tr, 2**32 + 4, "cpu", None).rows(4, 8)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert a[0].shape == (8, 128) and torch.equal(a[0][:, 1:], a[1][:, :-1].long())
