"""``repro_torch.optim.quantized`` against ``repro.optim.quantized`` on the
CPU: blockwise int8 codes and scales bitwise (sizes that are not multiples
of the 128-element block too), five ``int8_adamw`` steps (updates within
1e-6 relative, moment codes within one step), rowwise gradient compression
and the error-feedback residual bitwise, ``topk_sparsify``'s kept values
equal as sets; then the reference's own bars (``tests/test_substrate.py``,
``tests/test_properties.py``) on the port. Inputs come from numpy with a
seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as JO  # noqa: E402
from repro.optim import quantized as JQ  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402
from repro_torch.optim import quantized as Q  # noqa: E402


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", [1, 127, 128, 300, 1000, 4096])
def test_blockwise_codes_and_scales_bitwise(n):
    x = (np.random.default_rng(n).normal(size=(n,)) * 5).astype(np.float32)
    want, got = JQ.quantize_blockwise(jnp.asarray(x)), Q.quantize_blockwise(_t(x))
    assert got["q"].dtype == torch.int8 and got["q"].shape == (-(-n // 128), 128)
    np.testing.assert_array_equal(got["q"].numpy(), _np(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), _np(want["scale"]))
    back = Q.dequantize_blockwise(got, (n,))
    np.testing.assert_array_equal(back.numpy(), _np(JQ.dequantize_blockwise(want, (n,))))


def test_blockwise_of_a_matrix_and_bf16():
    x = np.random.default_rng(1).normal(size=(7, 50)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = JQ.quantize_blockwise(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    got = Q.quantize_blockwise(xb)
    np.testing.assert_array_equal(got["q"].numpy(), _np(want["q"]))
    back = Q.dequantize_blockwise(got, (7, 50), torch.bfloat16)
    assert back.dtype == torch.bfloat16 and back.shape == (7, 50)


def _grads(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_int8_adamw_five_steps_against_the_reference(wd):
    rng = np.random.default_rng(3)
    shapes = {"w": (300,), "b": (16, 40)}
    p0 = _grads(rng, shapes)
    jopt, opt = JQ.int8_adamw(1e-2, weight_decay=wd), Q.int8_adamw(1e-2, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), opt.init(tp)
    code_steps = 0
    for step in range(5):
        g = _grads(rng, shapes)
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = opt.update({k: _t(v) for k, v in g.items()}, ts, tp)
        for k in shapes:
            want, got = _np(ju[k]), tu[k].numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
            for mom, jmom in ((ts.mu, js.mu), (ts.nu, js.nu)):
                assert mom[k]["q"].dtype == torch.int8
                d = np.abs(mom[k]["q"].numpy().astype(np.int32) - _np(jmom[k]["q"]).astype(np.int32))
                assert d.max() <= 1
                code_steps += int((d > 0).sum())
                np.testing.assert_allclose(mom[k]["scale"].numpy(), _np(jmom[k]["scale"]), rtol=1e-6)
        jp = JO.apply_updates(jp, ju)
        tp = O.apply_updates(tp, tu)
        assert int(ts.step) == step + 1
    # the codes may differ by one step where a value sits on a rounding
    # boundary; nearly all of them are equal
    assert code_steps <= 0.01 * 2 * 5 * (300 + 640)


def test_int8_adamw_without_params():
    g = {"w": _t(np.ones(200, np.float32))}
    opt = Q.int8_adamw(0.1, weight_decay=0.5)
    u, s = opt.update(g, opt.init(g))
    ju, _ = JQ.int8_adamw(0.1, weight_decay=0.5).update({"w": jnp.ones(200)}, JQ.int8_adamw(0.1).init({"w": jnp.ones(200)}))
    np.testing.assert_allclose(u["w"].numpy(), _np(ju["w"]), rtol=1e-6)


def test_compress_decompress_bitwise():
    rng = np.random.default_rng(5)
    g = {"w": rng.normal(size=(64, 128)).astype(np.float32), "v": [rng.normal(size=(3, 5, 33)).astype(np.float32)]}
    jg = {"w": jnp.asarray(g["w"]), "v": [jnp.asarray(g["v"][0])]}
    tg = {"w": _t(g["w"]), "v": [_t(g["v"][0])]}
    jc, tc = JQ.compress_grads(jg), Q.compress_grads(tg)
    for got, want in ((tc.q["w"], jc.q["w"]), (tc.q["v"][0], jc.q["v"][0]),
                      (tc.scale["w"], jc.scale["w"]), (tc.scale["v"][0], jc.scale["v"][0])):
        np.testing.assert_array_equal(got.numpy(), _np(want))
    assert tc.q["w"].dtype == torch.int8 and tc.scale["w"].shape == (64, 1)
    back, jback = Q.decompress_grads(tc, tg), JQ.decompress_grads(jc, jg)
    np.testing.assert_array_equal(back["w"].numpy(), _np(jback["w"]))
    np.testing.assert_array_equal(back["v"][0].numpy(), _np(jback["v"][0]))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_and_error_feedback(frac):
    g = np.random.default_rng(7).normal(size=(32, 32)).astype(np.float32)
    jv, ji = JQ.topk_sparsify(jnp.asarray(g), frac)
    tv, ti = Q.topk_sparsify(_t(g), frac)
    assert sorted(tv.tolist()) == sorted(_np(jv).tolist())
    assert sorted(ti.tolist()) == sorted(_np(ji).tolist())
    r, jr = Q.error_feedback_residual(_t(g), tv, ti), JQ.error_feedback_residual(jnp.asarray(g), jv, ji)
    np.testing.assert_array_equal(r.numpy(), _np(jr))
    recon = r.reshape(-1).clone()
    recon[ti] += _t(g).reshape(-1)[ti]
    np.testing.assert_allclose(recon.numpy(), g.reshape(-1), atol=1e-6)


# ---------------------------------------------------------------------------
# The reference's own bars, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [lambda: O.adamw(0.1), lambda: Q.int8_adamw(0.1)])
def test_converges_on_quadratic(make):
    opt = make()
    params = {"w": torch.zeros((256,))}
    state = opt.init(params)
    for _ in range(150):
        updates, state = opt.update({"w": 2 * (params["w"] - 3.0)}, state, params)
        params = O.apply_updates(params, updates)
    assert float(torch.sum((params["w"] - 3.0) ** 2)) < 1e-2


def test_int8_state_is_int8_and_matches_fp32_adamw_closely():
    opt = Q.int8_adamw(0.1)
    state = opt.init({"w": torch.zeros((300,))})
    _, state = opt.update({"w": torch.ones((300,))}, state, {"w": torch.zeros((300,))})
    assert state.mu["w"]["q"].dtype == torch.int8 and state.nu["w"]["q"].dtype == torch.int8
    p0 = {"w": torch.linspace(-1, 1, 512)}
    g = {"w": torch.sin(torch.arange(512.0))}
    o1, o2 = O.adamw(0.01), Q.int8_adamw(0.01)
    s1, s2, p1, p2 = o1.init(p0), o2.init(p0), p0, p0
    for _ in range(10):
        u1, s1 = o1.update(g, s1, p1)
        p1 = O.apply_updates(p1, u1)
        u2, s2 = o2.update(g, s2, p2)
        p2 = O.apply_updates(p2, u2)
    assert float(torch.max(torch.abs(p1["w"] - p2["w"]))) < 0.08
    agree = torch.mean((torch.sign(p1["w"] - p0["w"]) == torch.sign(p2["w"] - p0["w"])).float())
    assert float(agree) > 0.97


@pytest.mark.parametrize("n,scale", [(1, 1e-3), (129, 1.0), (1000, 5.0), (2000, 1e3)])
def test_blockwise_error_bound_and_compress_roundtrip(n, scale):
    x = torch.from_numpy(np.random.default_rng(n).normal(size=(n,)).astype(np.float32)) * scale
    xr = Q.dequantize_blockwise(Q.quantize_blockwise(x), x.shape)
    assert float(torch.max(torch.abs(xr - x))) <= (float(torch.max(torch.abs(x))) / 127.0 + 1e-6) * 1.01
    g = {"w": torch.from_numpy(np.random.default_rng(n + 1).normal(size=(64, 128)).astype(np.float32))}
    r = Q.decompress_grads(Q.compress_grads(g), g)
    assert float(torch.max(torch.abs(r["w"] - g["w"])) / torch.max(torch.abs(g["w"]))) < 0.02


def test_moment_bytes_against_fp32():
    """int8 codes plus one fp32 scale a block: 3.6x fewer bytes than fp32
    moments at 128-element blocks (4 / (1 + 4 / 128) = 3.88; 3.6 once the
    padding of small leaves counts), the reference's figure."""
    params = {"w": torch.zeros((2048, 64)), "b": torch.zeros((300,))}
    st = Q.int8_adamw(0.1).init(params)
    q8 = sum(t.numel() * t.element_size() for t in O.tree_leaves(st.mu))
    f32 = sum(p.numel() * 4 for p in params.values())
    assert 3.6 <= f32 / q8 <= 4.0
