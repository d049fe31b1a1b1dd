"""GPipe pipelining of the admission prefill (``runtime.pipeline_par``,
``lm.pipeline_stage_params`` / ``lm.pipeline_sched_prefill``) on the CPU:

  - ``split_stages`` and ``bubble_fraction`` against the reference's,
    in-process (the stages are the caller's own layer dicts, the pads the
    last layer again);
  - ``pipeline_apply`` over ``["cpu"] * 2`` (and 3 stages, 4 microbatches)
    bitwise the sequential stack;
  - ``pipeline_sched_prefill``: 1 stage against the reference's 1-stage run
    (a one-device mesh) and against the reference's ``sched_prefill``,
    float32 logits within 1e-4; the port's 2 and 3 stages against its 1
    stage, the K/V caches equal; the stack refusals.

Reduced stablelm-1.6b (and a 3-layer variant), float32, one intra-op
thread."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro.runtime import pipeline_par as JPP  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.runtime import pipeline_par as PP  # noqa: E402

CFG = dataclasses.replace(reduce_config(get_config("stablelm-1.6b")), n_layers=3)
RANK = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_layers,n_stages", [(8, 4), (6, 4), (3, 2), (5, 1), (4, 4)])
def test_split_stages_matches_the_reference(n_layers, n_stages):
    layers = [{"w": torch.full((3,), float(i))} for i in range(n_layers)]
    stages, valid = PP.split_stages(layers, n_stages)
    j_st, j_valid = JPP.split_stages([{"w": jnp.full((3,), float(i))} for i in range(n_layers)], n_stages)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    per = len(stages[0])
    assert len(stages) == n_stages and all(len(s) == per for s in stages)
    for s in range(n_stages):
        for j in range(per):
            np.testing.assert_array_equal(stages[s][j]["w"].numpy(), np.asarray(j_st["w"][s, j]))
            want = layers[min(s * per + j, n_layers - 1)]
            assert stages[s][j] is want             # the caller's dict, never a copy


def test_split_stages_refusals_and_bubble_fraction():
    for bad in (([], 2), ([{"w": torch.zeros(2)}] * 3, 4), ([{"w": torch.zeros(2)}], 0)):
        with pytest.raises(ValueError):
            PP.split_stages(*bad)
    with pytest.raises(ValueError, match="identically-structured"):
        PP.split_stages([{"w": torch.zeros(2)}, {"v": torch.zeros(2)}], 2)
    for m, p in ((1, 1), (4, 2), (16, 4), (2, 2), (3, 5)):
        assert PP.bubble_fraction(m, p) == JPP.bubble_fraction(m, p)
    assert PP.bubble_fraction(2, 2) == 1 / 3


@pytest.mark.parametrize("n_layers,n_stages,n_micro", [(4, 2, 3), (5, 3, 4), (2, 2, 1)])
def test_pipeline_apply_is_the_sequential_stack(n_layers, n_stages, n_micro):
    g = torch.Generator().manual_seed(0)
    layers = [{"w": torch.randn((6, 6), generator=g) / 3, "b": torch.randn((6,), generator=g)}
              for _ in range(n_layers)]

    def layer_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    x = torch.randn((n_micro, 2, 6), generator=g)
    stages, valid = PP.split_stages(layers, n_stages)
    got = PP.pipeline_apply(stages, x, layer_fn, devices=["cpu"] * n_stages, valid=valid)
    want = x
    for p in layers:
        want = layer_fn(p, want)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="stages over"):
        PP.pipeline_apply(stages, x, layer_fn, devices=["cpu"], valid=valid)


@pytest.fixture(scope="module")
def model():
    jp = JL.init_lm(jax.random.key(0), CFG)
    tp = C.params_from_reference(jax.tree.map(np.asarray, jp), CFG)
    rng = np.random.default_rng(4)
    pools = {
        "A": np.concatenate([np.zeros((1, CFG.n_layers, CFG.d_model, RANK), np.float32),
                             rng.normal(size=(2, CFG.n_layers, CFG.d_model, RANK)).astype(np.float32)
                             / np.sqrt(CFG.d_model)]),
        "B": np.concatenate([np.zeros((1, CFG.n_layers, RANK, CFG.d_model), np.float32),
                             rng.normal(size=(2, CFG.n_layers, RANK, CFG.d_model)).astype(np.float32) * 0.1]),
    }
    rng = np.random.default_rng(5)
    inputs = (rng.integers(0, CFG.vocab_size, (4, 9)).astype(np.int32), np.array([9, 4, 1, 7], np.int32),
              np.array([2, 0, 1, 2], np.int32))
    return jp, tp, pools, inputs


def _port(tp, pools, inputs, n_stages, n_micro):
    tokens, lens, idx = (torch.as_tensor(x) for x in inputs)
    stages, valid = TL.pipeline_stage_params(tp, CFG, n_stages)
    caches = TL.init_serve_caches(CFG, tokens.shape[0], tokens.shape[1], device="cpu")
    logits, caches = TL.pipeline_sched_prefill(
        tp, CFG, stages, valid, tokens, lens, {k: torch.as_tensor(v) for k, v in pools.items()}, idx,
        devices=["cpu"] * n_stages, n_micro=n_micro, caches=caches)
    return logits, caches


def test_one_stage_matches_the_reference_one_stage_run_and_its_sched_prefill(model):
    jp, tp, pools, inputs = model
    tokens, lens, idx = (jnp.asarray(x) for x in inputs)
    jpools = {k: jnp.asarray(v) for k, v in pools.items()}
    mesh = jax.make_mesh((1,), ("model",))
    blocks, valid = JL.pipeline_stage_params(jp, CFG, 1)
    want_pipe, _ = JL.pipeline_sched_prefill(jp, CFG, blocks, valid, tokens, lens, jpools, idx, mesh=mesh,
                                             n_micro=2)
    want, _ = JL.sched_prefill(jp, CFG, tokens, lens, jpools, idx, use_kernel=False)
    got, _ = _port(tp, pools, inputs, 1, 2)
    assert tuple(got.shape) == (4, 1, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pipe), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 2), (2, 4), (3, 1), (3, 2)])
def test_stages_match_one_stage_and_sched_prefill(model, n_stages, n_micro):
    jp, tp, pools, inputs = model
    one, c1 = _port(tp, pools, inputs, 1, n_micro)
    got, cn = _port(tp, pools, inputs, n_stages, n_micro)
    assert torch.equal(got, one)
    for a, b in zip(c1, cn):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    tokens, lens, idx = (torch.as_tensor(x) for x in inputs)
    dense, cd = TL.sched_prefill(tp, CFG, tokens, lens, {k: torch.as_tensor(v) for k, v in pools.items()}, idx)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-4)
    assert torch.equal(got.argmax(-1), dense.argmax(-1))
    for a, b in zip(cd, cn):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_pipeline_refuses_what_the_reference_refuses(model):
    _, tp, pools, inputs = model
    with pytest.raises(NotImplementedError, match="uniform attention-only"):
        TL.pipeline_stage_params(None, t_get_config("jamba-1.5-large-398b"), 2)
    with pytest.raises(ValueError, match="not divisible"):
        _port(tp, pools, inputs, 2, 3)
    stages, valid = TL.pipeline_stage_params(tp, CFG, 2)
    tokens, lens, idx = (torch.as_tensor(x) for x in inputs)
    int8 = {"qa": torch.zeros(1), "sa": torch.zeros(1), "qb": torch.zeros(1), "sb": torch.zeros(1)}
    with pytest.raises(NotImplementedError, match="float adapter pool"):
        TL.pipeline_sched_prefill(tp, CFG, stages, valid, tokens, lens, int8, idx, devices=["cpu"] * 2,
                                  n_micro=2)
