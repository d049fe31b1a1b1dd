"""Single-stack skip-LoRA wrappers of the port (K1, K2, K3) against the
reference, on the CPU.

On CPU tensors ``skip_lora_fused`` / ``skip_lora_fused_int8`` run their
plain versions (``ref.py``) forward and backward; they are held against the
reference's ``repro.kernels.skip_lora.ops`` wrappers, whose Pallas kernels
run in interpret mode here, against ``jax.grad`` through their custom VJPs,
and against the reference's jnp oracles. Row counts are not multiples of
the reference's 128-row tile. The CUDA kernels themselves are held against
these plain versions by ``test_torch_kernels_gpu.py`` and ``chip_smoke.py``.

Tolerances, relative to the largest magnitude of the expected value:
float32 -> 1e-5 (summation order over D or M); bf16 activations -> 2^-7 for
outputs (z and the output may each round one bf16 ulp apart) and 2^-6 for
gradients (a z or gz element one ulp apart moves a whole sum over M)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.kernels.skip_lora import ops as JO  # noqa: E402
from repro.kernels.skip_lora import ref as JR  # noqa: E402
from repro_torch.convert import to_numpy  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.kernels.skip_lora import kernel as TK  # noqa: E402
from repro_torch.kernels.skip_lora import ops as TO  # noqa: E402
from repro_torch.kernels.skip_lora import ref as TR  # noqa: E402

SHAPES = [  # (L, B, S, D, R): M = B * S rows, never a multiple of 128
    (2, 2, 48, 64, 4),
    (3, 1, 130, 32, 8),
]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=0):
    lnum, bsz, s, d, r = shape
    rng = np.random.default_rng(seed)
    acts = rng.normal(size=(lnum, bsz, s, d)).astype(np.float32)
    a = (rng.normal(size=(lnum, d, r)) / np.sqrt(d)).astype(np.float32)
    b = (rng.normal(size=(lnum, r, d)) * 0.1).astype(np.float32)
    tgt = rng.normal(size=(bsz, s, d)).astype(np.float32)
    return acts, a, b, tgt


def _both(x, dtype):
    """The same values as a jnp array and a tensor of ``dtype`` (bf16 rounds
    to nearest even in both frameworks)."""
    _, jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.as_tensor(x).to(td)


def _assert_close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max abs err {err:.3e} > {tol:.3e}"


def _rel(dtype, grad=False):
    return 1e-5 if dtype == "float32" else (2.0**-6 if grad else 2.0**-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_forward_and_grads_match_reference(shape, dtype):
    acts, a, b, tgt = _inputs(shape)
    ja, ta = _both(acts, dtype)

    def j_loss(ab):
        out = JO.skip_lora_fused(ja, ab["A"], ab["B"])
        return jnp.sum(out.astype(jnp.float32) * tgt), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        {"A": jnp.asarray(a), "B": jnp.asarray(b)})
    ta_ = torch.as_tensor(a).requires_grad_(True)
    tb_ = torch.as_tensor(b).requires_grad_(True)
    t_out = TO.skip_lora_fused(ta, ta_, tb_)
    assert t_out.dtype == DTYPES[dtype][2] and t_out.shape == tgt.shape
    torch.sum(t_out.float() * torch.as_tensor(tgt)).backward()
    _assert_close(to_numpy(t_out), j_out, _rel(dtype))
    _assert_close(to_numpy(t_out), JSL.skip_sum_ref(ja, jnp.asarray(a), jnp.asarray(b)), _rel(dtype))
    _assert_close(to_numpy(ta_.grad), j_grads["A"], _rel(dtype, grad=True))
    _assert_close(to_numpy(tb_.grad), j_grads["B"], _rel(dtype, grad=True))
    assert ta_.grad.dtype == torch.float32 and tb_.grad.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_reference_oracles(shape, dtype):
    acts, a, b, tgt = _inputs(shape, seed=1)
    lnum, bsz, s, d, r = shape
    jx, tx = _both(acts.reshape(lnum, bsz * s, d), dtype)
    jg, tg = _both(tgt.reshape(bsz * s, d), dtype)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    _assert_close(to_numpy(TR.skip_lora_fwd_ref(tx, ta, tb)), JR.skip_lora_fwd_ref(jx, ja, jb), _rel(dtype))
    got_a, got_b = TR.skip_lora_bwd_ref(tx, ta, tb, tg)
    want_a, want_b = JR.skip_lora_bwd_ref(jx, ja, jb, jg)
    _assert_close(to_numpy(got_a), want_a, _rel(dtype, grad=True))
    _assert_close(to_numpy(got_b), want_b, _rel(dtype, grad=True))


def _int8_inputs(shape, seed=2):
    acts, a, b, tgt = _inputs(shape, seed)
    q, scale = JSL.quantize_int8(jnp.asarray(acts))
    return np.array(q), np.array(scale), a, b, tgt


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_int8_forward_and_grads_match_reference(shape):
    q, scale, a, b, tgt = _int8_inputs(shape)

    def j_loss(ab):
        out = JO.skip_lora_fused_int8(jnp.asarray(q), jnp.asarray(scale), ab["A"], ab["B"])
        return jnp.sum(out.astype(jnp.float32) * tgt), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        {"A": jnp.asarray(a), "B": jnp.asarray(b)})
    ta_ = torch.as_tensor(a).requires_grad_(True)
    tb_ = torch.as_tensor(b).requires_grad_(True)
    t_out = TO.skip_lora_fused_int8(torch.as_tensor(q), torch.as_tensor(scale), ta_, tb_)
    assert t_out.dtype == torch.bfloat16
    torch.sum(t_out.float() * torch.as_tensor(tgt)).backward()
    _assert_close(to_numpy(t_out), j_out, _rel("bfloat16"))
    _assert_close(to_numpy(ta_.grad), j_grads["A"], _rel("bfloat16", grad=True))
    _assert_close(to_numpy(tb_.grad), j_grads["B"], _rel("bfloat16", grad=True))
    lnum, bsz, s, d, _ = shape
    want = JR.skip_lora_int8_fwd_ref(jnp.asarray(q).reshape(lnum, -1, d), jnp.asarray(scale).reshape(lnum, -1),
                                     jnp.asarray(a), jnp.asarray(b))
    got = TR.skip_lora_int8_fwd_ref(torch.as_tensor(q).reshape(lnum, -1, d),
                                    torch.as_tensor(scale).reshape(lnum, -1), torch.as_tensor(a), torch.as_tensor(b))
    _assert_close(to_numpy(got), want, _rel("bfloat16"))


def test_cached_activations_get_no_gradient():
    acts, a, b, _ = _inputs(SHAPES[0])
    x = torch.as_tensor(acts).requires_grad_(True)
    out = TO.skip_lora_fused(x, torch.as_tensor(a).requires_grad_(True), torch.as_tensor(b))
    out.sum().backward()
    assert x.grad is None


def test_cpu_runs_the_plain_versions_and_launches_nothing():
    acts, a, b, _ = _inputs(SHAPES[1])
    TK.reset_launches()
    out = TO.skip_lora_fused(torch.as_tensor(acts), torch.as_tensor(a), torch.as_tensor(b))
    assert out.shape == (1, 130, 32)
    assert sum(TK.LAUNCHES.values()) == 0


def test_other_devices_raise():
    acts, a, b, _ = _inputs(SHAPES[0])
    with pytest.raises(ValueError, match="cpu or cuda"):
        TO.skip_lora_fused(torch.as_tensor(acts).to("meta"), torch.as_tensor(a).to("meta"),
                           torch.as_tensor(b).to("meta"))


def test_kernel_launchers_refuse_cpu_tensors():
    acts, a, b, _ = _inputs(SHAPES[0])
    x = torch.as_tensor(np.ascontiguousarray(acts[:, 0]))
    with pytest.raises(ValueError, match="CUDA device"):
        TK.skip_lora_fwd(x, torch.as_tensor(a), torch.as_tensor(b))
    with pytest.raises(ValueError, match="rank"):
        TK.skip_lora_fwd(x, torch.zeros((2, 64, 65)), torch.zeros((2, 65, 64)))


def test_skip_sum_routes_match():
    """``lm_skiplora.skip_sum`` with and without the fused route agree."""
    acts, a, b, _ = _inputs(SHAPES[0], seed=3)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    x = torch.as_tensor(acts)
    want = TSL.skip_sum_ref(x, ta, tb)
    _assert_close(to_numpy(TSL.skip_sum(x, ta, tb, use_kernel=True)), to_numpy(want), 1e-5)
