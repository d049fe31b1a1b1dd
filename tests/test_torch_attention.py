"""Port attention (``repro_torch.models.attention``) against
``repro.models.attention``: ``attn_prefill`` then several scalar-position
``attn_decode`` steps, outputs and bf16 KV caches.

Configs: reduced stablelm-1.6b (MHA, partial rotary), reduced gemma2-9b
(GQA 4/2; its ``attn_local`` layers add a sliding window of 8 and an
attention softcap of 50), reduced gemma-7b (head_dim 32 != d / heads).

Tolerances: outputs are float32 on both sides -> atol 1e-5, rtol 1e-4
(different GEMM summation orders). Cached K/V are bf16: the two sides round
float32 values that differ in the last bits, so a cached value may land one
bf16 ulp away, measured at the scale of its (position, head) vector."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.convert import to_numpy, to_tensor  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

CASES = [
    ("stablelm-1.6b", False),
    ("gemma2-9b", True),     # sliding window + softcap, GQA
    ("gemma2-9b", False),    # global GQA layer
    ("gemma-7b", False),
]


def assert_within_bf16_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    # ulp at the scale of each cached (position, head) vector: a value near
    # zero from cancellation carries the error of its vector's scale
    mag = np.maximum(np.abs(got), np.abs(want)).max(axis=-1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), f"{bad.sum()} cached values differ by more than one bf16 ulp"


@pytest.mark.parametrize("arch,local", CASES)
def test_prefill_then_decode_matches_reference(arch, local):
    cfg = reduce_config(get_config(arch))
    spec_j = JA.AttnSpec.from_config(cfg, local=local)
    spec_t = TA.AttnSpec.from_config(cfg, local=local)
    assert (spec_j.window > 0) == local and (spec_j.softcap > 0) == (arch == "gemma2-9b")
    params = jax.tree.map(np.asarray, JA.init_attn(jax.random.key(1), cfg))
    tparams = {k: to_tensor(v) for k, v in params.items()}
    rng = np.random.default_rng(0)
    b, s, steps = 2, 12, 4
    xs = rng.normal(size=(b, s + steps, cfg.d_model)).astype(np.float32)

    jc = JA.init_kv_cache(b, s + steps, spec_j)
    tc = TA.init_kv_cache(b, s + steps, spec_t)
    yj, jc = JA.attn_prefill(params, jnp.asarray(xs[:, :s]), spec_j, jc)
    yt, tc = TA.attn_prefill(tparams, to_tensor(xs[:, :s]), spec_t, tc)
    np.testing.assert_allclose(to_numpy(yt), np.asarray(yj), atol=1e-5, rtol=1e-4)
    for i in range(steps):
        pos = s + i
        x = xs[:, pos : pos + 1]
        yj, jc = JA.attn_decode(params, jnp.asarray(x), jnp.asarray(pos, jnp.int32), spec_j, jc)
        yt, tc = TA.attn_decode(tparams, to_tensor(x), pos, spec_t, tc)
        np.testing.assert_allclose(to_numpy(yt), np.asarray(yj), atol=1e-5, rtol=1e-4)
    for k in ("k", "v"):
        assert tc[k].dtype == torch.bfloat16
        assert_within_bf16_ulp(to_numpy(tc[k]), jc[k])


def test_causal_mask_matches_reference():
    for window in (0, 3):
        want = np.asarray(JA.causal_mask(5, 9, 4, window))
        got = TA.causal_mask(5, 9, 4, window).numpy()
        np.testing.assert_array_equal(got, want)
