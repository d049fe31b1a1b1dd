"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit's ``nvcc`` (the
kernels are built from ``src/repro_torch/kernels/skip_lora/csrc`` at first
use); without a device they skip. The file imports no JAX, so it also runs
on a machine that has only PyTorch (``--noconftest`` skips
``tests/conftest.py``, which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: fp32 activations -> 1e-5 of the output's largest magnitude
(summation order over D); bf16 -> two bf16 ulps of it (z and the output may
each round one ulp apart)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.lm_skiplora import quantize_int8  # noqa: E402
from repro_torch.kernels.skip_lora import kernel as K  # noqa: E402
from repro_torch.kernels.skip_lora import ops  # noqa: E402
from repro_torch.kernels.skip_lora import ref as R  # noqa: E402

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(cuda, groups, rank, dtype, lnum=4, d=200, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    n, m = len(groups), sum(groups)
    x = torch.randn((lnum, m, d), generator=g, device=cuda).to(DTYPES[dtype])
    a = torch.randn((n, lnum, d, rank), generator=g, device=cuda) / d**0.5
    b = torch.randn((n, lnum, rank, d), generator=g, device=cuda) * 0.1
    idx = torch.repeat_interleave(torch.arange(n, device=cuda), torch.tensor(groups, device=cuda))
    idx = idx[torch.randperm(m, generator=g, device=cuda)].to(torch.int32)
    return x, a, b, idx


def _close(got, want, dtype):
    scale = want.float().abs().max().item()
    tol = (2.0**-7 if dtype == "bfloat16" else 1e-5) * scale
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, f"max |kernel - plain| {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("tm", [1, 7, 16, 32])
@pytest.mark.parametrize("rank", [4, 8, 24, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions(cuda, tm, rank, dtype):
    x, a, b, idx = _inputs(cuda, (2, 0, 19, 1, 33), rank, dtype)
    for pool_dtype in (torch.float32, torch.bfloat16):
        ap, bp = a.to(pool_dtype), b.to(pool_dtype)
        got = ops.skip_lora_grouped(x[:, :, None], ap, bp, idx, tm=tm)[:, 0]
        _close(got, R.skip_lora_grouped_ref(x, ap, bp, idx), dtype)
    qa, sa = quantize_int8(a)
    qb, sb = quantize_int8(b)
    got = ops.skip_lora_grouped_int8(x[:, :, None], qa, sa, qb, sb, idx, tm=tm)[:, 0]
    _close(got, R.skip_lora_grouped_int8_ref(x, qa, sa, qb, sb, idx), dtype)


@pytest.mark.parametrize("groups", [(1,), (0, 0, 1), (1, 1, 1, 1), (64, 0, 3)])
def test_small_and_empty_groups(cuda, groups):
    x, a, b, idx = _inputs(cuda, groups, 8, "bfloat16", lnum=24, d=2048)
    got = ops.skip_lora_grouped(x[:, :, None], a, b, idx)[:, 0]
    _close(got, R.skip_lora_grouped_ref(x, a, b, idx), "bfloat16")


def test_each_wrapper_call_counts_one_launch(cuda):
    x, a, b, idx = _inputs(cuda, (3, 2), 8, "float32")
    qa, sa = quantize_int8(a)
    qb, sb = quantize_int8(b)
    K.reset_launches()
    ops.skip_lora_grouped(x[:, :, None], a, b, idx)
    ops.skip_lora_grouped(x[:, :, None], a, b, idx)
    ops.skip_lora_grouped_int8(x[:, :, None], qa, sa, qb, sb, idx)
    R.skip_lora_grouped_ref(x, a, b, idx)
    assert K.LAUNCHES == {"grouped_skip_sum_fwd": 2, "grouped_skip_sum_fwd_int8": 1}


def test_kernel_refuses_what_it_cannot_take(cuda):
    x, a, b, idx = _inputs(cuda, (3, 2), 72, "float32")
    with pytest.raises(ValueError, match="rank"):
        ops.skip_lora_grouped(x[:, :, None], a, b, idx)
    x, a, b, idx = _inputs(cuda, (3, 2), 8, "float32")
    with pytest.raises(ValueError, match="row tile"):
        ops.skip_lora_grouped(x[:, :, None], a, b, idx, tm=33)
    with pytest.raises(ValueError, match="dtype"):
        ops.skip_lora_grouped(x[:, :, None], a.half(), b.half(), idx)
