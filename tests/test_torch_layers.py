"""Port layers (``repro_torch.models.layers``, ``.ffn``) against
``repro.models.layers`` / ``.ffn`` on the same numpy inputs.

Tolerance: float32 on both sides, the same operations in the same order up
to the libraries' own kernels -> atol 1e-6, rtol 1e-5. bf16 results are
compared after both are widened to float32, to one bf16 ulp."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import ffn as JF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.convert import to_numpy, to_tensor  # noqa: E402
from repro_torch.models import ffn as TF  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ATOL, RTOL = 1e-6, 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rmsnorm(unit_offset):
    rng = _rng()
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    p = {"scale": rng.normal(size=(32,)).astype(np.float32)}
    want = JL.rmsnorm({"scale": jnp.asarray(p["scale"])}, jnp.asarray(x), eps=1e-6, unit_offset=unit_offset)
    got = TL.rmsnorm({"scale": to_tensor(p["scale"])}, to_tensor(x), eps=1e-6, unit_offset=unit_offset)
    _close(got, want)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm(norm_type):
    rng = _rng(1)
    x = (rng.normal(size=(3, 4, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=(48,)).astype(np.float32), "bias": rng.normal(size=(48,)).astype(np.float32)}
    if norm_type == "rmsnorm":
        p.pop("bias")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: to_tensor(v) for k, v in p.items()}
    want = JL.apply_norm(norm_type, jp, jnp.asarray(x), eps=1e-5)
    got = TL.apply_norm(norm_type, tp, to_tensor(x), eps=1e-5)
    _close(got, want)


@pytest.mark.parametrize("rope_pct,head_dim", [(0.25, 64), (1.0, 32), (0.5, 30)])
def test_partial_rope(rope_pct, head_dim):
    rng = _rng(2)
    x = rng.normal(size=(2, 7, 3, head_dim)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 100]).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10_000.0, rope_pct=rope_pct)
    got = TL.apply_rope(to_tensor(x), to_tensor(pos), theta=10_000.0, rope_pct=rope_pct)
    _close(got, want, atol=2e-5)


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed(scale, dtype):
    rng = _rng(3)
    table = rng.normal(size=(50, 24)).astype(np.float32) * 0.02
    ids = rng.integers(0, 50, (2, 6)).astype(np.int32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = JL.embed({"table": jnp.asarray(table)}, jnp.asarray(ids), scale_by_sqrt_dim=scale, dtype=jdt)
    got = TL.embed({"table": to_tensor(table)}, to_tensor(ids).long(), scale_by_sqrt_dim=scale, dtype=tdt)
    assert got.dtype == tdt
    # Both round the same fp32 products to bf16: equal.
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want, np.float32))


def test_unembed_is_fp32():
    rng = _rng(4)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    h = rng.normal(size=(2, 3, 16)).astype(np.float32)
    want = JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(h))
    got = TL.unembed({"table": to_tensor(table)}, to_tensor(h).to(torch.bfloat16))
    assert got.dtype == torch.float32
    want_bf = JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(h, jnp.bfloat16))
    _close(got, want_bf, atol=1e-5)
    assert want.shape == tuple(got.shape)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation(name):
    x = _rng(5).normal(size=(4, 33)).astype(np.float32) * 4
    _close(TL.activation(name, to_tensor(x)), JL.activation(name, jnp.asarray(x)))


def test_softcap():
    x = _rng(6).normal(size=(5, 7)).astype(np.float32) * 80
    _close(TL.softcap(to_tensor(x), 50.0), JL.softcap(jnp.asarray(x), 50.0), atol=1e-5)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (True, "gelu"), (False, "gelu")])
def test_ffn(gated, act):
    rng = _rng(7)
    d, f = 32, 64
    p = {"w_up": rng.normal(size=(d, f)) / np.sqrt(d), "w_down": rng.normal(size=(f, d)) / np.sqrt(f)}
    if gated:
        p["w_gate"] = rng.normal(size=(d, f)) / np.sqrt(d)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    want = JF.ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act=act, gated=gated)
    got = TF.ffn({k: to_tensor(v) for k, v in p.items()}, to_tensor(x), act=act, gated=gated)
    _close(got, want, atol=1e-5)
