"""Grouped skip-LoRA wrappers of the port against the reference.

On CPU tensors ``skip_lora_grouped`` / ``skip_lora_grouped_int8`` run their
plain versions; they are held against the reference's Pallas kernels in
interpret mode (``repro.kernels.skip_lora.ops._grouped_rows[_int8]``) and its
jnp oracles, for 1/4/8 slots with ragged groups and row counts that are not a
multiple of the tile. The port's grouping plan must equal the reference's
and cover each row exactly once; ``quantize_int8`` must be bitwise the
reference's. The CUDA kernels themselves are held against these plain
versions by ``test_torch_kernels_gpu.py``, which skips without a card.

Tolerances: float32 -> atol 1e-5 (summation order); bf16 activations -> two
bf16 ulps of the output's largest magnitude (z and the output may each
round one ulp apart when sums are taken in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.kernels.skip_lora import ops as JO  # noqa: E402
from repro.kernels.skip_lora import ref as JR  # noqa: E402
from repro_torch.convert import to_numpy, to_tensor  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.kernels.skip_lora import kernel as TK  # noqa: E402
from repro_torch.kernels.skip_lora import ops as TO  # noqa: E402

L, D, R = 3, 32, 4


def _inputs(n, groups, seed=0):
    rng = np.random.default_rng(seed)
    m = sum(groups)
    x = rng.normal(size=(L, m, D)).astype(np.float32)
    a = (rng.normal(size=(n, L, D, R)) / np.sqrt(D)).astype(np.float32)
    b = (rng.normal(size=(n, L, R, D)) * 0.1).astype(np.float32)
    idx = np.repeat(np.arange(len(groups)), groups).astype(np.int32)
    idx = idx[rng.permutation(m)]
    return x, a, b, idx


def _tol(want, dtype):
    if dtype == "float32":
        return 1e-5
    return 2.0**-7 * float(np.abs(np.asarray(want, np.float32)).max())


CASES = [  # (n slots, rows per slot): ragged groups, M % tm != 0
    (1, (5,)),
    (4, (3, 0, 7, 1)),
    (8, (1, 2, 0, 9, 4, 0, 3, 1)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,groups", CASES)
def test_grouped_matches_reference_kernel_and_oracle(n, groups, dtype):
    x, a, b, idx = _inputs(n, groups)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    xj = jnp.asarray(x, jdt)
    want_k = JO._grouped_rows(xj, jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx), tm=8)
    want_o = JR.skip_lora_grouped_ref(xj, jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx))
    acts = to_tensor(np.asarray(xj))[:, :, None]                 # (L, M, 1, D)
    got = TO.skip_lora_grouped(acts, to_tensor(a), to_tensor(b), to_tensor(idx))[:, 0]
    assert got.dtype == acts.dtype
    for want in (want_k, want_o):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), atol=_tol(want, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,groups", CASES)
def test_grouped_int8_matches_reference_kernel_and_oracle(n, groups, dtype):
    x, a, b, idx = _inputs(n, groups, seed=1)
    qa, sa = JSL.quantize_int8(jnp.asarray(a))
    qb, sb = JSL.quantize_int8(jnp.asarray(b))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    xj = jnp.asarray(x, jdt)
    want_k = JO._grouped_rows_int8(xj, qa, sa, qb, sb, jnp.asarray(idx), tm=8)
    want_o = JR.skip_lora_grouped_int8_ref(xj, qa, sa, qb, sb, jnp.asarray(idx))
    t = [to_tensor(np.asarray(v)) for v in (qa, sa, qb, sb)]
    got = TO.skip_lora_grouped_int8(to_tensor(np.asarray(xj))[:, :, None], *t, to_tensor(idx))[:, 0]
    for want in (want_k, want_o):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), atol=_tol(want, dtype))


def test_batch_rows_share_their_slot_over_the_sequence():
    """(L, B, S, D) acts: every position of row b uses slot idx[b]."""
    rng = np.random.default_rng(2)
    acts = rng.normal(size=(L, 3, 4, D)).astype(np.float32)
    _, a, b, _ = _inputs(4, (1, 1, 1, 1))
    a[0], b[0] = 0.0, 0.0                            # the pinned zero slot
    idx = np.array([2, 0, 3], np.int32)
    want = JO.skip_lora_grouped(jnp.asarray(acts), jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx),
                                use_kernel=False)
    got = TO.skip_lora_grouped(to_tensor(acts), to_tensor(a), to_tensor(b), to_tensor(idx))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5)
    assert not to_numpy(got[1]).any()              # zero slot -> exact zeros


@pytest.mark.parametrize("tm", [1, 4, 16])
@pytest.mark.parametrize("n,groups", CASES)
def test_grouping_plan_equals_reference_and_covers_each_row_once(n, groups, tm):
    _, _, _, idx = _inputs(n, groups)
    m = len(idx)
    dest_j, tiles_j, m_pad_j = JO._grouping_plan(jnp.asarray(idx), n, m, tm)
    dest, tiles, m_pad = TO._grouping_plan(to_tensor(idx), n, m, tm)
    assert m_pad == m_pad_j
    np.testing.assert_array_equal(dest.numpy(), np.asarray(dest_j))
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(tiles_j))
    dest = dest.numpy()
    assert len(set(dest.tolist())) == m and dest.min() >= 0 and dest.max() < m_pad
    np.testing.assert_array_equal(tiles.numpy()[dest // tm], idx)   # row's tile holds its slot
    row_src = TO._row_sources(torch.as_tensor(dest), m_pad).numpy()
    assert row_src.dtype == np.int32 and (row_src >= 0).sum() == m
    np.testing.assert_array_equal(row_src[dest], np.arange(m))


def test_quantize_int8_is_bitwise_the_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 6, 33)).astype(np.float32)
    x[0, 0] = 0.0                                   # all-zero row: scale 1e-8/127
    x[1, 1, :3] = [1.0, -0.5, 0.25]                 # exact ties after scaling
    x[2, 2, :] = np.linspace(-127, 127, 33) / 127.0
    qj, sj = JSL.quantize_int8(jnp.asarray(x))
    qt, st = TSL.quantize_int8(to_tensor(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), np.asarray(sj).view(np.uint32))
    np.testing.assert_array_equal(
        to_numpy(TSL.dequantize_int8(qt, st)), np.asarray(JSL.dequantize_int8(qj, sj), np.float32)
    )


def test_wrapper_inputs_are_detached():
    x, a, b, idx = _inputs(4, (1, 2, 3, 4))
    ta = to_tensor(a).requires_grad_()
    out = TO.skip_lora_grouped(to_tensor(x)[:, :, None], ta, to_tensor(b), to_tensor(idx))
    assert not out.requires_grad


def test_wrapper_refuses_devices_other_than_cpu_and_cuda():
    x, a, b, idx = _inputs(4, (1, 1, 1, 1))
    with pytest.raises(ValueError, match="cpu or cuda"):
        TO.skip_lora_grouped(torch.empty((L, 4, 1, D), device="meta"), to_tensor(a), to_tensor(b),
                             to_tensor(idx))


def test_launch_functions_refuse_cpu_tensors():
    """The kernel entry never takes the plain path itself."""
    x, a, b, idx = _inputs(4, (1, 1, 1, 1))
    row_src, tile_slot = TO._plan(to_tensor(idx), 4, 4, TO.TM)
    with pytest.raises(ValueError, match="CUDA"):
        TK.grouped_skip_sum_fwd(to_tensor(x), to_tensor(a), to_tensor(b), row_src, tile_slot, TO.TM)
