"""The model axis on the card: a backbone split over a group of CUDA
devices (``models.tp``) and the 2-D session.

Every test needs a CUDA device; without one they skip, and the two-card
tests skip below two cards. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_model_axis_gpu.py

A small float32 attention stack (4 layers, d 16, 4 heads over 2 KV heads,
vocab 64) and reduced qwen2-moe-a2.7b (float32, vocab 512), seeded
weights. The session takes ``use_kernel=False``, as a model axis must.

  - one card: the group ``[cuda:0, cuda:0]`` (``tp.group_params``, the
    one-card form ``make_mesh`` refuses) against the unsplit backbone on
    the same card: train forward, serve prefill and a decode step (the
    caches split by heads) within 1e-4 of the largest value, greedy tokens
    equal;
  - two cards: a (1 data x 2 model) session over ``[cuda:0, cuda:1]`` (built
    through ``make_mesh``), with ``pipeline_stages=2`` and without, against
    the same session over ``["cpu", "cpu"]``: adapters within rtol 1e-4 /
    atol 1e-6 (the CPU tests' bar), slot tables and serve and scheduler
    tokens equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import lm_skiplora as SL  # noqa: E402
from repro_torch.core.runtime import SessionRuntime  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.runtime.sharding import make_mesh  # noqa: E402

pytestmark = pytest.mark.gpu

CFG = ModelConfig(name="t", family="test", n_layers=4, d_model=16, n_heads=4, n_kv_heads=2, d_ff=32,
                  vocab_size=64, pattern=("attn",), dtype="float32")


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _live(params, cfg):
    for p in [params["final_norm"]] + [v for layer in params["stack"] for k, v in layer.items()
                                       if k.startswith("norm")]:
        p["scale"].fill_(1.0 if not cfg.rmsnorm_unit_offset else 0.0)
    return params


def _close(got, want, tol=1e-4):
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("arch", ["small", "qwen2-moe-a2.7b"])
def test_one_card_group_matches_the_unsplit_backbone(arch):
    cfg = CFG if arch == "small" else dataclasses.replace(reduce_config(get_config(arch)), vocab_size=512)
    params = _live(TL.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg), cfg)
    gp = TP.group_params(params, ["cuda:0", "cuda:0"])
    tokens = torch.randint(0, cfg.vocab_size, (2, 7), generator=torch.Generator().manual_seed(1)).cuda()
    _close(TL.lm_forward(gp, cfg, tokens)["h"], TL.lm_forward(params, cfg, tokens)["h"])
    c1, c2 = (TL.init_serve_caches(cfg, 2, 9, device="cuda", params=p) for p in (params, gp))
    l1, _ = TL.serve_prefill(params, cfg, tokens, c1)
    l2, _ = TL.serve_prefill(gp, cfg, tokens, c2)
    _close(l2, l1)
    assert torch.equal(l1.argmax(-1), l2.argmax(-1))
    d1, _ = TL.serve_decode(params, cfg, l1.argmax(-1), 7, c1)
    d2, _ = TL.serve_decode(gp, cfg, l2.argmax(-1), 7, c2)
    _close(d2, d1)


def _session(devices, stages):
    params = _live(TL.init_lm(torch.Generator().manual_seed(0), CFG), CFG)
    mesh = make_mesh((1, 2), ("data", "model"), devices=devices)
    if devices[0] != "cpu":
        from repro_torch.runtime.sharding import _to

        params = _to(params, torch.device(devices[0]))
    rt = SessionRuntime(CFG, SL.SkipLoRAConfig(rank=2, mode="full"), params, max_tenants=2, samples_per_tenant=4,
                        seq=6, use_kernel=False, mesh=mesh, pipeline_stages=stages, seed=0)
    g = np.random.default_rng(5)
    for t in ("a", "b"):
        rt.ingest(t, g.integers(0, 64, (4, 6)), g.integers(0, 64, (4, 6)))
    rt.adapt(["a", "b"], epochs=2, batch_per_tenant=2, generator=torch.Generator().manual_seed(7))
    prompts = g.integers(0, 64, (3, 5))
    toks = rt.serve([None, "a", "b"], prompts, max_new=4).cpu()
    rt.attach_scheduler(max_batch=4, max_prompt=5, max_new_cap=6, admit_bucket=2, chunk=2)
    reqs = [rt.enqueue_serve(t, prompts[j, :4 - j], max_new=5) for j, t in enumerate(("a", None, "b"))]
    rt.drain()
    return rt, toks, [r.result().tolist() for r in reqs]


@pytest.mark.parametrize("stages", [0, 2])
def test_two_card_session_matches_the_cpu_group(stages):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    card, toks_card, sched_card = _session(["cuda:0", "cuda:1"], stages)
    cpu, toks_cpu, sched_cpu = _session(["cpu", "cpu"], stages)
    assert [str(d) for d in card._group(0)] == ["cuda:0", "cuda:1"]
    for t in ("a", "b"):
        for k in ("A", "B"):
            np.testing.assert_allclose(card.tenant(t).adapters[k].cpu().numpy(),
                                       cpu.tenant(t).adapters[k].numpy(), rtol=1e-4, atol=1e-6)
    assert card.pool.slot_table() == cpu.pool.slot_table()
    assert torch.equal(toks_card, toks_cpu) and sched_card == sched_cpu
    if stages:
        assert card.scheduler.counters["dispatch/admit_pipe"] >= 1
