"""Flash attention of the port (K4) against the reference, on the CPU.

On CPU tensors ``ops.flash_attention`` runs its plain version
(``kernels/flash_attn/ref.py``); it is held against the reference's
``flash_attention`` (the Pallas kernel in interpret mode) and its jnp oracle
at S = 128 and 256 with GQA, a sliding window and a softcap. The model-level
``attn_train(use_flash=True)`` is held against the reference's
``attn_train`` with and without its flash path on reduced stablelm-1.6b and
gemma2-9b (a local layer with window and softcap, and a global layer). The
CUDA kernel is held against the plain version by
``test_torch_kernels_gpu.py`` and ``chip_smoke.py``.

Tolerances, relative to the largest output magnitude: float32 -> 1e-5
against the oracle (the same operations in another summation order) and
1e-4 against the Pallas kernel, which applies the scale after the product
instead of before it; bf16 -> 2^-6 (probabilities round to bf16 at
different points: one ulp of a probability moves an output by up to one
ulp of the largest value). Model-level outputs, float32: atol 1e-5, rtol
1e-4, as for the port's other attention tests."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.kernels.flash_attn.ops import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attn.ref import flash_attention_ref as j_flash_ref  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.convert import to_numpy, to_tensor  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as TK  # noqa: E402
from repro_torch.kernels.flash_attn import ops as TO  # noqa: E402
from repro_torch.kernels.flash_attn import ref as TR  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

CASES = [
    # (b, h, hkv, s, hd, window, softcap)
    (1, 2, 2, 128, 32, 0, 0.0),        # causal MHA
    (2, 4, 2, 256, 64, 0, 0.0),        # GQA 2:1
    (1, 4, 2, 256, 32, 100, 50.0),     # window + softcap + GQA (gemma2-like)
    (1, 2, 1, 128, 64, 0, 30.0),       # MQA + softcap
]
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(case, dtype, seed=0):
    b, h, hkv, s, hd, _, _ = case
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd))]
    jd, td = DT[dtype]
    return [jnp.asarray(x).astype(jd) for x in arrs], [torch.as_tensor(x).to(td) for x in arrs]


def _assert_close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max abs err {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_flash_attention_matches_reference(case, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(case, dtype)
    window, cap = case[5], case[6]
    got = TO.flash_attention(tq, tk, tv, window=window, softcap=cap)
    assert got.dtype == DT[dtype][1] and got.shape == tq.shape
    want_ref = j_flash_ref(jq, jk, jv, window=window, softcap=cap)
    want_kernel = j_flash(jq, jk, jv, window=window, softcap=cap)
    rel = 1e-5 if dtype == "float32" else 2.0**-6
    _assert_close(to_numpy(got), want_ref, rel)
    _assert_close(to_numpy(got), want_kernel, 1e-4 if dtype == "float32" else rel)
    _assert_close(to_numpy(TR.flash_attention_ref(tq, tk, tv, window=window, softcap=cap)), want_ref, rel)


def test_custom_scale_and_cpu_launches_nothing():
    case = CASES[1]
    (jq, jk, jv), (tq, tk, tv) = _qkv(case, "float32", seed=1)
    TK.reset_launches()
    got = TO.flash_attention(tq, tk, tv, scale=0.3)
    _assert_close(to_numpy(got), j_flash_ref(jq, jk, jv, scale=0.3), 1e-5)
    assert TK.LAUNCHES == {"flash_attn_fwd": 0}


def test_kernel_launcher_checks_its_inputs():
    _, (tq, tk, tv) = _qkv(CASES[1], "float32")
    with pytest.raises(ValueError, match="CUDA device"):
        TK.flash_attn_fwd(tq, tk, tv, window=0, softcap=0.0, scale=0.125)
    with pytest.raises(ValueError, match="head_dim"):
        TK.flash_attn_fwd(torch.zeros(1, 1, 8, 300), torch.zeros(1, 1, 8, 300),
                          torch.zeros(1, 1, 8, 300), window=0, softcap=0.0, scale=0.1)
    with pytest.raises(ValueError, match="divide"):
        TK.flash_attn_fwd(torch.zeros(1, 4, 8, 16), torch.zeros(1, 3, 8, 16),
                          torch.zeros(1, 3, 8, 16), window=0, softcap=0.0, scale=0.1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        TO.flash_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"))


@pytest.mark.parametrize("arch,local", [("stablelm-1.6b", False), ("gemma2-9b", True), ("gemma2-9b", False)])
def test_attn_train_matches_reference(arch, local):
    cfg = reduce_config(get_config(arch))
    spec_j = JA.AttnSpec.from_config(cfg, local=local)
    spec_t = TA.AttnSpec.from_config(cfg, local=local)
    assert (spec_t.window > 0) == local
    params = jax.tree.map(np.asarray, JA.init_attn(jax.random.key(2), cfg))
    tparams = {k: to_tensor(v) for k, v in params.items()}
    x = np.random.default_rng(3).normal(size=(2, 128, cfg.d_model)).astype(np.float32)
    want = np.asarray(JA.attn_train(params, jnp.asarray(x), spec_j))
    want_flash = np.asarray(JA.attn_train(params, jnp.asarray(x), spec_j, use_flash=True))
    for use_flash in (False, True):
        got = to_numpy(TA.attn_train(tparams, to_tensor(x), spec_t, use_flash=use_flash))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(got, want_flash, atol=1e-5, rtol=1e-4)
