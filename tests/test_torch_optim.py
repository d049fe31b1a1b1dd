"""The port's optimizers (``repro_torch.optim``) against ``repro.optim``:
several steps of SGD (with and without momentum), Adam and AdamW (with
weight decay) from the same params and gradients, on fp32 and bf16 params.

Tolerances: fp32 params, moments and updates within atol 1e-7 / rtol 1e-6
(the bias-correction powers and square roots round differently in the two
frameworks); bf16 params may round one bf16 ulp apart."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as JO  # noqa: E402
from repro_torch.convert import opt_state_to_numpy, to_numpy  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402

OPTS = [
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("adam", {}),
    ("adamw", {"weight_decay": 0.1}),
]


def _params(rng):
    return {"A": rng.normal(size=(3, 5)).astype(np.float32),
            "B": {"w": rng.normal(size=(4,)).astype(np.float32)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", OPTS)
def test_steps_match_reference(name, kw, dtype):
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jp = jax.tree.map(lambda x: jnp.asarray(x).astype(jd), p0)
    tp = TO.tree_map(lambda x: torch.as_tensor(x).to(td), p0)
    jopt, topt = JO.make_optimizer(name, 1e-2, **kw), TO.make_optimizer(name, 1e-2, **kw)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = _params(rng)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(TO.tree_map(torch.as_tensor, g), ts, tp)
        for a, b in zip(jax.tree.leaves(ju), TO.tree_leaves(tu)):
            np.testing.assert_allclose(to_numpy(b), np.asarray(a), atol=1e-7, rtol=1e-6)
        jp, tp = JO.apply_updates(jp, ju), TO.apply_updates(tp, tu)
        # compare from the reference's params, so a one-ulp bf16 difference
        # does not carry into the next step
        tp = TO.tree_map(lambda x: torch.as_tensor(np.array(x, np.float32)).to(td), jp)
    for a, b in zip(jax.tree.leaves(jp), TO.tree_leaves(tp)):
        assert b.dtype == td
        np.testing.assert_array_equal(to_numpy(b), np.asarray(a, np.float32))
    jn, tn = opt_state_to_numpy(js), opt_state_to_numpy(ts)
    assert jn["step"] == tn["step"] == 5
    for key in ("mu", "nu"):
        assert (jn[key] is None) == (tn[key] is None)
        if jn[key] is not None:
            for a, b in zip(jax.tree.leaves(jn[key]), TO.tree_leaves(tn[key])):
                np.testing.assert_allclose(b, a, atol=1e-7, rtol=1e-6)


def test_global_norm_and_clip_match_reference():
    g = _params(np.random.default_rng(1))
    jg, tg = jax.tree.map(jnp.asarray, g), TO.tree_map(torch.as_tensor, g)
    np.testing.assert_allclose(float(TO.global_norm(tg)), float(JO.global_norm(jg)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        want = JO.clip_by_global_norm(jg, max_norm)
        got = TO.clip_by_global_norm(tg, max_norm)
        for a, b in zip(jax.tree.leaves(want), TO.tree_leaves(got)):
            np.testing.assert_allclose(to_numpy(b), np.asarray(a), rtol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        TO.make_optimizer("lion", 1e-3)
