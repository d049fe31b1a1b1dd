"""The paper-scale slice of the port (``models/mlp.py``, ``core/methods.py``,
``core/finetune.py``, ``data/synthetic.py``) against the reference's.

The same numpy inputs go through both packages via ``repro_torch.convert``:
the backbone's forward, each method's split, forward and SGD step, three
epochs of every method on the reference's own index matrices, Skip2-LoRA's
populate and cached epochs with their cache, the streaming populate step's
hit accounting and pre-training. Then the port against itself, at the bars
of the reference's ``tests/test_methods_mlp.py``: Skip2-LoRA equals
Skip-LoRA, the cache is fully populated after epoch 0 (a remainder batch
included), and a drifted dataset's accuracy collapses and recovers. The
reduced width is the reference tests' 32-24-3, plus Fan width (256-96-96-3).
On the CPU every epoch runs the eager loop; the graph replays are held to
it on the card (``tests/test_torch_mlp_graph_gpu.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import finetune as RF  # noqa: E402
from repro.core import methods as RM  # noqa: E402
from repro.core import skip_cache as RC  # noqa: E402
from repro.data import synthetic as RS  # noqa: E402
from repro.models import mlp as RMLP  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import finetune as F  # noqa: E402
from repro_torch.core import methods as M  # noqa: E402
from repro_torch.core import skip_cache as C  # noqa: E402
from repro_torch.core.cache_engine import TieredCacheEngine  # noqa: E402
from repro_torch.data import synthetic as S  # noqa: E402
from repro_torch.models import mlp as TMLP  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

CPU = torch.device("cpu")
WIDTHS = {"reduced": (32, 24, 3), "fan": (256, 96, 3)}
LR = 0.05


@pytest.fixture(autouse=True)
def one_thread():
    """These products are tiny: one intra-op thread runs them fastest, and
    spares a machine whose cores other test processes share the threads'
    contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(width):
    d_in, hidden, out = WIDTHS[width]
    return RMLP.MLPConfig(d_in, hidden, out, lora_rank=4), TMLP.MLPConfig(d_in, hidden, out, lora_rank=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _backbone(cfg_r, seed=0):
    """The reference's ``init_mlp`` with its BN affine and statistics moved
    off identity, so every BN term of both forwards is exercised: numpy."""
    bb = _np(RMLP.init_mlp(jax.random.key(seed), cfg_r))
    rng = np.random.default_rng(seed + 100)
    for layer in bb["bn"]:
        m = layer["gamma"].shape[0]
        layer["gamma"] = (1 + 0.1 * rng.standard_normal(m)).astype(np.float32)
        layer["beta"] = (0.1 * rng.standard_normal(m)).astype(np.float32)
        layer["mean"] = (0.1 * rng.standard_normal(m)).astype(np.float32)
        layer["var"] = (1 + 0.2 * np.abs(rng.standard_normal(m))).astype(np.float32)
    return bb


def _batch(cfg_r, n=16, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, cfg_r.in_dim)).astype(np.float32),
            rng.integers(0, cfg_r.out_dim, n).astype(np.int32))


def _split(cfg_r, bb, method, seed=2):
    """The reference's split for ``method`` (numpy), every LoRA B moved off
    zero so the adapters' forward and both of their gradients are nonzero."""
    t, f = _np(RM.init_method(jax.random.key(seed), cfg_r, _jnp(bb), method))
    rng = np.random.default_rng(seed + 7)

    def bump(tree):
        if isinstance(tree, dict):
            return {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32) if k == "B" else bump(v)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [bump(v) for v in tree]
        return tree

    return bump(t), f


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return tuple(tree.shape)


def _close(got, want, tol, what=""):
    """Leaf by leaf within ``tol``, both trees in the reference's (sorted-key) order."""
    g = jax.tree.leaves(convert._map(convert.to_numpy, got))
    w = jax.tree.leaves(_np(want))
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def _t(a, dtype=None):
    t = convert.to_tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train_bn", [False, True])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_mlp_forward_matches_reference(width, train_bn):
    cfg_r, cfg = _cfgs(width)
    bb = _backbone(cfg_r)
    x, _ = _batch(cfg_r)
    want_logits, want_xs = RMLP.mlp_forward(_jnp(bb), jnp.asarray(x), cfg_r, train_bn=train_bn)
    logits, xs = TMLP.mlp_forward(convert.mlp_from_reference(bb), _t(x), cfg, train_bn=train_bn)
    _close(logits, want_logits, 1e-5, "logits")
    assert len(xs) == len(want_xs) == cfg.n_layers
    for got, want in zip(xs, want_xs):
        _close(got, want, 1e-5, "xs")
    assert float(TMLP.cross_entropy(logits, _t(_batch(cfg_r)[1], torch.long))) == pytest.approx(
        float(RMLP.cross_entropy(want_logits, jnp.asarray(_batch(cfg_r)[1]))), rel=1e-5)


def test_init_mlp_shapes_match_reference():
    cfg_r, cfg = _cfgs("fan")
    bb = TMLP.init_mlp(torch.Generator().manual_seed(0), cfg, device=CPU)
    assert _structure(bb) == _structure(_np(RMLP.init_mlp(jax.random.key(0), cfg_r)))
    assert cfg.dims == cfg_r.dims == (256, 96, 96, 3)
    w = bb["fc"][0]["W"]
    assert 0.8 < float(w.std()) / (2.0 / 256) ** 0.5 < 1.2 and all(float(b["var"].min()) == 1.0 for b in bb["bn"])


@pytest.mark.parametrize("method", M.METHODS)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_method_split_forward_and_step_match_reference(width, method):
    cfg_r, cfg = _cfgs(width)
    bb = _backbone(cfg_r)
    x, y = _batch(cfg_r)
    fwd = "skip_lora" if method == "skip2_lora" else method

    # init_method's split has the reference's structure
    t_port, f_port = M.init_method(torch.Generator().manual_seed(0), cfg, convert.mlp_from_reference(bb), method)
    t_ref, f_ref = _np(RM.init_method(jax.random.key(0), cfg_r, _jnp(bb), method))
    assert _structure(convert._map(convert.to_numpy, t_port)) == _structure(t_ref)
    assert _structure(convert._map(convert.to_numpy, f_port)) == _structure(f_ref)

    # forward and one SGD step on the same (perturbed) split
    t_np, f_np = _split(cfg_r, bb, method)
    t, f = convert.method_params_from_reference(t_np, f_np)
    frozen_before = [v.clone() for v in tree_leaves(f)]
    want_logits, _ = RM.forward(fwd, _jnp(t_np), _jnp(f_np), jnp.asarray(x), cfg_r)
    logits, xs = M.forward(fwd, t, f, _t(x), cfg)
    _close(logits, want_logits, 1e-5, "logits")
    assert len(xs) == cfg.n_layers
    want_t, want_loss = RM.train_step(fwd, cfg_r, _jnp(t_np), _jnp(f_np), jnp.asarray(x), jnp.asarray(y), LR)
    new_t, loss = M.train_step(fwd, cfg, t, f, _t(x), _t(y, torch.long), LR)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    _close(new_t, _np(want_t), 1e-5, "trainable after one step")
    assert all(torch.equal(a, b) for a, b in zip(frozen_before, tree_leaves(f)))
    # convert's inverse gives the port's split back bit for bit
    back = convert.method_params_from_reference(*convert.method_params_to_reference(t, f))
    _close(back, _np(convert.method_params_to_reference(t, f)), 0.0, "round trip")


@pytest.mark.parametrize("method", M.METHODS)
def test_step_leaves_the_backbone_untouched(method):
    """The steps update the trainable leaves in place; ``init_method`` cloned
    the backbone's, so the backbone a caller holds never changes."""
    cfg_r, cfg = _cfgs("reduced")
    bb = convert.mlp_from_reference(_backbone(cfg_r))
    before = [v.clone() for v in tree_leaves(bb)]
    x, y = _batch(cfg_r)
    t, f = M.init_method(torch.Generator().manual_seed(0), cfg, bb, method)
    fwd = "skip_lora" if method == "skip2_lora" else method
    for _ in range(3):
        M.train_step(fwd, cfg, t, f, _t(x), _t(y, torch.long), 0.5)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(bb)))


def test_gradient_scoping_skip_lora():
    """Skip-LoRA's first step from B = 0: gB != 0, gA == 0 exactly (as the
    reference's test holds), and autograd records no backbone op."""
    cfg_r, cfg = _cfgs("reduced")
    bb = convert.mlp_from_reference(_backbone(cfg_r))
    x, y = _batch(cfg_r)
    t, f = M.init_method(torch.Generator().manual_seed(4), cfg, bb, "skip_lora")
    a0 = [lora["A"].clone() for lora in t["lora"]]
    M.train_step("skip_lora", cfg, t, f, _t(x), _t(y, torch.long), 0.1)
    for k in range(cfg.n_layers):
        assert not torch.all(t["lora"][k]["B"] == 0) and torch.equal(t["lora"][k]["A"], a0[k])
    with torch.enable_grad():
        _, xs = M.forward("skip_lora", t, f, _t(x), cfg)
    assert all(not v.requires_grad for v in xs)


def test_skip_forward_cached_equals_forward():
    cfg_r, cfg = _cfgs("reduced")
    bb = _backbone(cfg_r)
    t, f = convert.method_params_from_reference(*_split(cfg_r, bb, "skip_lora"))
    x = _t(_batch(cfg_r)[0])
    full, xs = M.forward("skip_lora", t, f, x, cfg)
    skip = sum(M.lora_apply(lora, xk) for lora, xk in zip(t["lora"], xs))
    cached = M.skip_forward_cached(t, full - skip, xs)
    torch.testing.assert_close(cached, full, rtol=0, atol=1e-5)


def _ref_orders(n, batch, seeds):
    return [np.asarray(RF.epoch_index_matrix(jax.random.key(s), n, batch)) for s in seeds]


@pytest.mark.parametrize("method", [m for m in M.METHODS if m != "skip2_lora"])
def test_three_epochs_match_reference(method):
    """Three epochs on the reference's own index matrices (n 47, batch 20: a
    wrapped last batch): per-step losses and trainable leaves within 1e-4."""
    cfg_r, cfg = _cfgs("reduced")
    bb = _backbone(cfg_r)
    x, y = _batch(cfg_r, n=47, seed=3)
    t_np, f_np = _split(cfg_r, bb, method)
    t_r, f_r = _jnp(t_np), _jnp(f_np)
    t, f = convert.method_params_from_reference(t_np, f_np)
    ref_epoch = RF.make_epoch_fn(method, cfg_r)
    epoch = F.make_epoch_fn(method, cfg)
    for e, idx in enumerate(_ref_orders(47, 20, (5, 6, 7))):
        t_r, ls_r = ref_epoch(t_r, f_r, jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx), LR)
        t, ls = epoch(t, f, _t(x), _t(y, torch.long), _t(idx, torch.long), LR)
        _close(ls, ls_r, 1e-4, f"losses, epoch {e}")
        _close(t, _np(t_r), 1e-4, f"trainable, epoch {e}")


@pytest.mark.parametrize("width", list(WIDTHS))
def test_skip2_epochs_and_cache_match_reference(width):
    """Skip2-LoRA's populate epoch and two cached epochs on the reference's
    index matrices: losses, adapters and every cache slot within 1e-4, the
    validity bitmap equal."""
    cfg_r, cfg = _cfgs(width)
    bb = _backbone(cfg_r)
    n = 47
    x, y = _batch(cfg_r, n=n, seed=3)
    t_np, f_np = _split(cfg_r, bb, "skip2_lora")
    t_r, f_r = _jnp(t_np), _jnp(f_np)
    t, f = convert.method_params_from_reference(t_np, f_np)
    cache_r = RC.cache_for_mlp(n, cfg_r.dims)
    cache = C.cache_for_mlp(n, cfg.dims, device=CPU)
    ref_pop, ref_cached = RF.make_skip2_epoch_fns(cfg_r, donate=False)
    pop, cached = F.make_skip2_epoch_fns(cfg)
    xr, yr, xt, yt = jnp.asarray(x), jnp.asarray(y), _t(x), _t(y, torch.long)
    for e, idx in enumerate(_ref_orders(n, 20, (8, 9, 10))):
        if e == 0:
            t_r, cache_r, ls_r = ref_pop(t_r, f_r, cache_r, xr, yr, jnp.asarray(idx), LR)
            t, new_cache, ls = pop(t, f, cache, xt, yt, _t(idx, torch.long), LR)
            assert int(cache.hit_count()) == 0, "the epoch wrote into its argument"
            cache = new_cache
        else:
            t_r, ls_r = ref_cached(t_r, cache_r, xr, yr, jnp.asarray(idx), LR)
            t, ls = cached(t, cache, xt, yt, _t(idx, torch.long), LR)
        _close(ls, ls_r, 1e-4, f"losses, epoch {e}")
        _close(t, _np(t_r), 1e-4, f"adapters, epoch {e}")
    got = convert.cache_to_numpy(cache)
    for name, slot in _np(cache_r.slots).items():
        np.testing.assert_allclose(got[name], slot, rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got["valid"], np.asarray(cache_r.valid))
    assert int(cache.hit_count()) == n


def test_masked_populate_step_hits_match_reference():
    """The reference's streaming case: a window of 4 new rows, then one that
    overlaps it by 2. Hit counts, validity, cache slots (hit rows keep their
    first values) and adapters as the reference's."""
    cfg_r, cfg = _cfgs("reduced")
    bb = _backbone(cfg_r)
    t_np, f_np = _split(cfg_r, bb, "skip2_lora")
    t_r, f_r = _jnp(t_np), _jnp(f_np)
    t, f = convert.method_params_from_reference(t_np, f_np)
    cache_r, cache = RC.cache_for_mlp(8, cfg_r.dims), C.cache_for_mlp(8, cfg.dims, device=CPU)
    ref_step, step = RF.masked_populate_step(cfg_r), F.masked_populate_step(cfg)
    y = np.zeros(4, np.int32)
    for seed, ids in ((13, [0, 1, 2, 3]), (14, [2, 3, 4, 5])):
        x = _batch(cfg_r, n=4, seed=seed)[0]
        t_r, cache_r, loss_r = ref_step(t_r, f_r, cache_r, jnp.asarray(ids), jnp.asarray(x), jnp.asarray(y), LR)
        t, cache, loss = step(t, f, cache, _t(np.array(ids), torch.long), _t(x), _t(y, torch.long), LR)
        assert int(cache.hit_count()) == int(cache_r.hit_count())
        np.testing.assert_array_equal(convert.to_numpy(cache.valid), np.asarray(cache_r.valid))
        assert float(loss) == pytest.approx(float(loss_r), rel=1e-5)
    assert int(cache.hit_count()) == 6
    got = convert.cache_to_numpy(cache)
    for name, slot in _np(cache_r.slots).items():
        np.testing.assert_allclose(got[name], slot, rtol=1e-5, atol=1e-5, err_msg=name)
    _close(t, _np(t_r), 1e-5, "adapters")


def test_cached_epoch_via_engine_equals_resident_epoch():
    """A cached epoch streamed out of a tiered engine holding 16 of 47 rows
    (the rest in its host tier) gives the resident cached epoch's adapters
    and last loss."""
    cfg_r, cfg = _cfgs("reduced")
    bb = _backbone(cfg_r)
    n = 47
    x, y = (_t(a) for a in _batch(cfg_r, n=n, seed=3))
    y = y.long()
    t, f = convert.method_params_from_reference(*_split(cfg_r, bb, "skip2_lora"))
    pop, cached = F.make_skip2_epoch_fns(cfg)
    idx0, idx1 = (_t(i, torch.long) for i in _ref_orders(n, 20, (8, 9)))
    t, cache, _ = pop(t, f, C.cache_for_mlp(n, cfg.dims, device=CPU), x, y, idx0, LR)
    layout = {name: (tuple(v.shape[1:]), v.dtype) for name, v in cache.slots.items()}
    engine = TieredCacheEngine(n, layout, capacity=16, device=CPU)
    for rows in torch.arange(n).split(8):
        engine.write(rows, C.cache_read(cache, rows))
    want_t, want_ls = cached(t, cache, x, y, idx1, LR)
    got_t, got_loss = F.cached_epoch_via_engine(cfg, t, engine, x, y, idx1, LR)
    assert engine.stats.spills > 0
    for a, b in zip(tree_leaves(got_t), tree_leaves(want_t)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert float(got_loss) == pytest.approx(float(want_ls[-1]), rel=1e-6)


def test_pretrain_step_matches_reference():
    """n == batch: each epoch is one step over every sample, whatever the
    permutation (a mean over the batch is order-invariant up to rounding), so
    the reference's ``pretrain`` and the port's ``pretrain_step`` from the
    same init agree: weights, BN affine and running statistics."""
    cfg_r, cfg = _cfgs("fan")
    x, y = _batch(cfg_r, n=20, seed=5)
    want = _np(RMLP.pretrain(jax.random.key(3), cfg_r, jnp.asarray(x), jnp.asarray(y), epochs=3, batch_size=20))
    params = convert.mlp_from_reference(_np(RMLP.init_mlp(jax.random.key(3), cfg_r)))
    for _ in range(3):
        params = TMLP.pretrain_step(params, _t(x), _t(y, torch.long), cfg, 0.05)
    _close(params, want, 1e-5, "pre-trained backbone")


# ---------------------------------------------------------------------------
# The port against itself (the reference's own bars)
# ---------------------------------------------------------------------------


def _data(n, seed, cfg):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, cfg.in_dim), generator=g), torch.randint(0, cfg.out_dim, (n,), generator=g)


def test_skip2_equals_skip_first_epochs():
    _, cfg = _cfgs("reduced")
    bb = TMLP.init_mlp(torch.Generator().manual_seed(0), cfg, device=CPU)
    x, y = _data(40, 8, cfg)
    r_skip = F.finetune(torch.Generator().manual_seed(9), "skip_lora", cfg, bb, x, y, epochs=3)
    r_skip2 = F.finetune(torch.Generator().manual_seed(9), "skip2_lora", cfg, bb, x, y, epochs=3)
    for a, b in zip(tree_leaves(r_skip.trainable), tree_leaves(r_skip2.trainable)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert r_skip.cache is None and len(r_skip2.epoch_times_s) == 3


@pytest.mark.parametrize("n,epochs", [(40, 1), (47, 2)])
def test_cache_fully_populated_after_first_epoch(n, epochs):
    """Every sample in the cache after epoch 0, also when batch 20 leaves a
    remainder (47): the last batch wraps, so no later epoch gathers a zero row."""
    _, cfg = _cfgs("reduced")
    bb = TMLP.init_mlp(torch.Generator().manual_seed(0), cfg, device=CPU)
    x, y = _data(n, 10 + n, cfg)
    res = F.finetune(torch.Generator().manual_seed(11), "skip2_lora", cfg, bb, x, y, epochs=epochs)
    assert int(res.cache.hit_count()) == n


def test_epoch_index_matrix_covers_every_sample():
    g = torch.Generator().manual_seed(0)
    idx = F.epoch_index_matrix(g, 47, 20, device=CPU)
    assert idx.shape == (3, 20) and idx.dtype == torch.long
    assert sorted(set(idx.flatten().tolist())) == list(range(47))
    assert not torch.equal(idx, F.epoch_index_matrix(g, 47, 20, device=CPU))


def _drift_check(ds, cfg):
    bb = TMLP.pretrain(torch.Generator().manual_seed(1), cfg, ds.x_pre, ds.y_pre, epochs=25, lr=0.05)
    logits, _ = TMLP.mlp_forward(bb, ds.x_test, cfg)
    before = float(TMLP.accuracy(logits, ds.y_test))
    res = F.finetune(torch.Generator().manual_seed(2), "skip2_lora", cfg, bb, ds.x_ft, ds.y_ft, epochs=25, lr=0.05)
    after = F.evaluate("skip2_lora", cfg, res, ds.x_test, ds.y_test)
    assert before < 0.5
    assert after > 0.8
    assert after - before > 0.3


def test_drift_gap_and_recovery_on_the_ports_twin():
    _drift_check(S.make_drifted_dataset(torch.Generator().manual_seed(0), "damage1", device=CPU),
                 TMLP.MLPConfig(in_dim=256, hidden_dim=96, out_dim=3))


def test_drift_gap_and_recovery_on_the_references_arrays():
    ds = convert.dataset_from_reference(RS.make_drifted_dataset(jax.random.key(0), "damage1"))
    assert ds.y_ft.dtype == torch.long and ds.x_ft.dtype == torch.float32
    _drift_check(ds, TMLP.MLPConfig(in_dim=256, hidden_dim=96, out_dim=3))


@pytest.mark.parametrize("name", list(S.DATASET_SPECS))
def test_drifted_dataset_shapes_match_reference(name):
    assert S.DATASET_SPECS[name] == RS.DATASET_SPECS[name]
    d, c, n_pre, n_ft, n_test = S.DATASET_SPECS[name]
    ds = S.make_drifted_dataset(torch.Generator().manual_seed(0), name, device=CPU)
    assert (ds.n_features, ds.n_classes) == (d, c)
    for split, n in (("pre", n_pre), ("ft", n_ft), ("test", n_test)):
        x, y = getattr(ds, f"x_{split}"), getattr(ds, f"y_{split}")
        assert x.shape == (n, d) and x.dtype == torch.float32 and y.shape == (n,) and y.dtype == torch.long
        assert int(y.min()) >= 0 and int(y.max()) < c
    again = S.make_drifted_dataset(torch.Generator().manual_seed(0), name, device=CPU)
    assert torch.equal(ds.x_ft, again.x_ft) and torch.equal(ds.y_test, again.y_test)


def test_damage_twins_differ_and_unknown_names_raise():
    a = S.make_drifted_dataset(torch.Generator().manual_seed(0), "damage1", device=CPU)
    b = S.make_drifted_dataset(torch.Generator().manual_seed(0), "damage2", device=CPU)
    assert not torch.equal(a.x_pre, b.x_pre)
    with pytest.raises(ValueError, match="unknown dataset"):
        S.make_drifted_dataset(torch.Generator().manual_seed(0), "mnist", device=CPU)


def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert [f"=== {k}." in printed for k in range(1, 6)] == [True] * 5
    assert out["before"] < 0.5 and out["after"]["skip2_lora"] > 0.8
    assert all(v > 0 for k, v in out.items() if k.endswith("_ms"))
