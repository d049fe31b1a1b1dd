"""The recurrent mixers on a model group (``models.tp``: mamba, mLSTM,
sLSTM) on the CPU, for reduced float32 xlstm-350m (mLSTM + sLSTM) and
jamba-1.5-large (attention + mamba, MoE FFNs) over ``["cpu"] * 2`` and
``["cpu"] * 4``, against the unsplit port and the reference's forward:

  - the prefill's logits within 1e-5 of their largest value, of the
    unsplit port and of the reference's ``lm_forward`` on the same weights
    (the port's draw in the reference's layout, norm scales around 1);
    three decode steps within 1e-3 (the conv windows and sLSTM's ``h`` are
    bf16 serve state, one bf16 ulp apart between the two runs at most);
    temperature-0 tokens equal;
  - the serve states: each split leaf's parts on their members with the
    split's shape (mamba's ``ssm`` / ``conv`` and mLSTM's ``conv`` by
    ``d_inner``, mLSTM's ``c`` by heads), gathering to the unsplit states
    (fp32 within 1e-5, bf16 within an ulp at the leaf's scale);
  - the Skip2-LoRA populate and cached losses and their adapter gradients
    within 1e-5, with a vocabulary that splits (512);
  - a (1, 2) ``SessionRuntime`` with a float32 Skip-Cache: ingest, adapt
    and serve equal to the (1, 1) session's (tokens equal, adapters within
    rtol 1e-4 / atol 1e-6); its scheduler refused, as the reference's is.

One intra-op thread."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_config as j_reduce_config  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.core.runtime import SessionRuntime  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402

ARCHS = ["xlstm-350m", "jamba-1.5-large-398b"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, vocab=512):
    """One period (xlstm: 7 mLSTM + 1 sLSTM; jamba: its 8-layer period and a
    mamba remainder) at a vocabulary that splits over 2 and 4."""
    if arch == "xlstm-350m":
        pair = reduce_config(get_config(arch), n_periods=1), j_reduce_config(j_get_config(arch), n_periods=1)
    else:
        pair = (dataclasses.replace(reduce_config(get_config(arch), n_periods=1), n_layers=9),
                dataclasses.replace(j_reduce_config(j_get_config(arch), n_periods=1), n_layers=9))
    return tuple(dataclasses.replace(c, vocab_size=vocab) for c in pair)


def _live(params, seed=0):
    g = torch.Generator().manual_seed(seed)

    def draw(path, t):
        if path.endswith("scale"):
            t.copy_(1 + 0.1 * torch.randn(t.shape, generator=g))
        return t

    SH._map_path(draw, params)
    return params


def _to_reference(params, cfg):
    """The port's params in the reference's periods / remainder layout."""
    flat = [C._map(C.to_numpy, layer) for layer in params["stack"]]
    n, per = cfg.n_periods, cfg.period
    stack = {"periods": [jax.tree.map(lambda *xs: np.stack(xs), *flat[i:n * per:per]) for i in range(per)],
             "remainder": flat[n * per:]}
    return {**{k: C._map(C.to_numpy, v) for k, v in params.items() if k != "stack"}, "stack": stack}


_MODELS: dict = {}


def _model(arch):
    if arch not in _MODELS:
        cfg, jcfg = _cfgs(arch)
        params = _live(TL.init_lm(torch.Generator().manual_seed(0), cfg))
        _MODELS[arch] = cfg, jcfg, params
    return _MODELS[arch]


def _rel(got, want):
    got, want = C.to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tokens(seed, shape, vocab):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int64))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_tokens(arch, n):
    cfg, jcfg, params = _model(arch)
    gp = TP.group_params(params, ["cpu"] * n)
    assert gp.specs["stack"][0][cfg.layer_kinds()[0]]["conv_w"] == (None, "model")
    tokens = _tokens(1, (2, 7), cfg.vocab_size)
    c1 = TL.init_serve_caches(cfg, 2, 16, device="cpu")
    c2 = TL.init_serve_caches(cfg, 2, 16, device="cpu", params=gp)
    l1, _ = TL.serve_prefill(params, cfg, tokens, c1)
    l2, _ = TL.serve_prefill(gp, cfg, tokens, c2)
    assert _rel(l2, l1) <= 1e-5
    jout = JL.lm_forward(_to_reference(params, cfg), jcfg, jnp.asarray(tokens.numpy().astype(np.int32)))
    want = JL.readout(_to_reference(params, cfg), jcfg, jout["h"][:, -1:])
    assert _rel(l2, want) <= 1e-5
    for step, tok in enumerate(_tokens(2, (3, 2, 1), cfg.vocab_size)):
        d1, _ = TL.serve_decode(params, cfg, tok, 7 + step, c1)
        d2, _ = TL.serve_decode(gp, cfg, tok, 7 + step, c2)
        assert _rel(d2, d1) <= 1e-3
    outs = []
    for p in (params, gp):
        caches = TL.init_serve_caches(cfg, 2, 16, device="cpu", params=p)
        logits, caches = TL.serve_prefill(p, cfg, tokens, caches)
        toks, _ = TL.decode_scan(p, cfg, torch.argmax(logits, -1), 7, caches, max_new=6)
        outs.append(toks)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_member_states_gather_to_the_unsplit_ones(arch, n):
    cfg, _, params = _model(arch)
    gp = TP.group_params(params, ["cpu"] * n)
    tokens = _tokens(3, (2, 5), cfg.vocab_size)
    c1 = TL.init_serve_caches(cfg, 2, 8, device="cpu")
    c2 = TL.init_serve_caches(cfg, 2, 8, device="cpu", params=gp)
    TL.serve_prefill(params, cfg, tokens, c1)
    TL.serve_prefill(gp, cfg, tokens, c2)
    split_axes = {"mamba": {"ssm": -2, "conv": -1}, "mlstm": {"conv": -1, "c": -3}, "slstm": {}}
    kv_axis = -2 if cfg.n_kv_heads % n == 0 else -3      # jamba's one KV head: split by sequence
    for kind, a, b in zip(cfg.layer_kinds(), c1, c2):
        for name, want in a.items():
            got = b[name]
            axis = split_axes.get(kind, {"k": kv_axis, "v": kv_axis}).get(name)
            if kind in split_axes:
                assert isinstance(got, TP.HeadSplit) == (axis is not None), (kind, name)
            if isinstance(got, TP.HeadSplit):
                assert got.axis == axis and len(got.parts) == n
                assert all(p.shape[axis] * n == want.shape[axis] for p in got.parts)
                got = got.whole()
            assert got.shape == want.shape and got.dtype == want.dtype
            tol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 1e-5
            assert _rel(got.float(), want.float()) <= tol, (kind, name)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_skiplora_losses_and_gradients(arch, n):
    cfg, _, params = _model(arch)
    gp = TP.group_params(params, ["cpu"] * n)
    assert gp.specs["embed"]["table"][0] == "model"
    sl = TSL.SkipLoRAConfig(rank=4, mode="full", cache_dtype="float32")
    adapters = TSL.init_adapters(torch.Generator().manual_seed(4), cfg, sl)
    adapters["B"] = 0.1 * torch.randn(adapters["B"].shape, generator=torch.Generator().manual_seed(5))
    batch = {"tokens": _tokens(6, (2, 6), cfg.vocab_size), "labels": _tokens(7, (2, 6), cfg.vocab_size)}
    got = []
    for p in (params, gp):
        loss, (acts, y_base, labels), grads = TSL.value_and_grad(
            lambda t: TSL.populate_loss_fn(p, cfg, t, batch), adapters)
        vals = {"acts": acts.transpose(0, 1), "y_base": y_base, "labels": labels}
        closs, _, cgrads = TSL.value_and_grad(
            lambda t: (TSL.cached_loss_fn(p, cfg, sl, t, vals, torch.float32), None), adapters)
        got.append((loss, grads, closs, cgrads, acts))
    (l1, g1, c1, cg1, a1), (l2, g2, c2, cg2, a2) = got
    assert _rel(a2, a1) <= 1e-5
    for x, y in ((l2, l1), (c2, c1)):
        np.testing.assert_allclose(float(x), float(y), rtol=1e-5)
    for gx, gy in ((g2, g1), (cg2, cg1)):
        for k in ("A", "B"):
            assert _rel(gx[k], gy[k]) <= 1e-5, k


@pytest.mark.parametrize("arch", ARCHS)
def test_session_1x2_equals_1x1_and_refuses_the_scheduler(arch):
    cfg, _, params = _model(arch)
    # a float32 cache: in bf16 a cached activation one ulp apart between
    # the runs (the members' partial sums round differently) moves Adam's
    # first steps on near-zero gradients by up to 1.3e-5 (jamba)
    sl = TSL.SkipLoRAConfig(rank=2, mode="full", cache_dtype="float32")
    mesh = SH.make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    kw = dict(max_tenants=2, samples_per_tenant=4, seq=6, use_kernel=False, seed=0)
    one = SessionRuntime(cfg, sl, params, device="cpu", **kw)
    two = SessionRuntime(cfg, sl, params, mesh=mesh, **kw)
    assert two.model_parallel == 2 and TP.is_group(two.params)
    tokens, labels = _tokens(8, (4, 6), cfg.vocab_size), _tokens(9, (4, 6), cfg.vocab_size)
    for rt in (one, two):
        rt.ingest("a", tokens.numpy().astype(np.int32), labels.numpy().astype(np.int32))
        rt.adapt(["a"], epochs=2, batch_per_tenant=2, generator=torch.Generator().manual_seed(7))
    for k in ("A", "B"):
        np.testing.assert_allclose(two.tenant("a").adapters[k].numpy(), one.tenant("a").adapters[k].numpy(),
                                   rtol=1e-4, atol=1e-6)
    assert not torch.equal(one.tenant("a").adapters["B"], torch.zeros_like(one.tenant("a").adapters["B"]))
    prompts = _tokens(10, (2, 5), cfg.vocab_size).numpy().astype(np.int32)
    assert torch.equal(two.serve([None, "a"], prompts, max_new=4), one.serve([None, "a"], prompts, max_new=4))
    with pytest.raises(NotImplementedError, match="attention"):
        two.attach_scheduler(max_batch=2, max_prompt=5, max_new_cap=4)
