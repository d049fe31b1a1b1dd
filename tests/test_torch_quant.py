"""The port's packed 4-bit quantisation (``kernels/skip_lora/quant.py``)
against ``repro.kernels.skip_lora.quant`` on the CPU: codebooks, nibble
packing and ``quantize_q4`` bitwise on the same numpy input, and the
zero-row contract (the exact-zero code with scale 0 dequantises to exact
zeros)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.skip_lora import quant as JQ  # noqa: E402
from repro_torch.convert import to_numpy, to_tensor  # noqa: E402
from repro_torch.kernels.skip_lora import quant as TQ  # noqa: E402


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


@pytest.mark.parametrize("kind", TQ.Q4_KINDS)
def test_codebooks_are_bitwise_the_reference(kind):
    got = TQ.codebook(kind)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(JQ.codebook(kind)))
    assert TQ.Q4_KINDS == JQ.Q4_KINDS


def test_pack_and_unpack_are_bitwise_the_reference_and_inverse():
    rng = np.random.default_rng(0)
    nib = rng.integers(0, 16, size=(3, 5, 8)).astype(np.uint8)
    packed = TQ.pack_nibbles(to_tensor(nib))
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (3, 5, 4)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JQ.pack_nibbles(jnp.asarray(nib))))
    np.testing.assert_array_equal(packed.numpy()[..., 0] & 0x0F, nib[..., 0])   # even -> low nibble
    np.testing.assert_array_equal(TQ.unpack_nibbles(packed).numpy(), nib)
    np.testing.assert_array_equal(TQ.unpack_nibbles(packed).numpy(),
                                  np.asarray(JQ.unpack_nibbles(jnp.asarray(packed.numpy()))))
    with pytest.raises(ValueError, match="even"):
        TQ.pack_nibbles(torch.zeros((2, 3), dtype=torch.uint8))


@pytest.mark.parametrize("kind", TQ.Q4_KINDS)
@pytest.mark.parametrize("shape", [(4, 6, 8), (2, 3, 5, 32)])
def test_quantize_q4_is_bitwise_the_reference(kind, shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0                         # an all-zero row
    x.reshape(-1, shape[-1])[1, :4] = [1.0, -1.0, 0.5, -0.5]  # ties on the levels
    x.reshape(-1, shape[-1])[2] = np.linspace(-1, 1, shape[-1])
    qt, st = TQ.quantize_q4(to_tensor(x), kind)
    qj, sj = JQ.quantize_q4(jnp.asarray(x), kind)
    assert qt.dtype == torch.uint8 and st.dtype == torch.float32
    assert tuple(qt.shape) == shape[:-1] + (shape[-1] // 2,) and tuple(st.shape) == shape[:-1]
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
    code = TQ.codebook(kind)
    got = TQ.dequantize_q4(qt, st, code)
    want = JQ.dequantize_q4(qj, sj, JQ.codebook(kind))
    np.testing.assert_array_equal(_bits(to_numpy(got)), _bits(want))


@pytest.mark.parametrize("kind,zero_index", [("int4", 8), ("nf4", 7)])
def test_zero_row_dequantises_to_exact_zeros(kind, zero_index):
    q, s = TQ.quantize_q4(torch.zeros((3, 6)), kind)
    assert not s.any()
    np.testing.assert_array_equal(TQ.unpack_nibbles(q).numpy(), np.full((3, 6), zero_index))
    assert float(TQ.codebook(kind)[zero_index]) == 0.0
    out = TQ.dequantize_q4(q, s, TQ.codebook(kind))
    assert not out.any()
    # the never-written payload (nibble 0) with scale 0 is exact zeros too
    assert not TQ.dequantize_q4(torch.zeros((2, 3), dtype=torch.uint8), torch.zeros(2),
                                TQ.codebook(kind)).any()


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="4-bit kind"):
        TQ.quantize_q4(torch.ones((1, 2)), "int3")
    with pytest.raises(ValueError, match="4-bit kind"):
        TQ.codebook("fp4")
