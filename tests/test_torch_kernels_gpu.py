"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit's ``nvcc`` (the
kernels are built from ``src/repro_torch/kernels/*/csrc`` at first use);
without a device they skip. The file imports no JAX, so it also runs
on a machine that has only PyTorch (``--noconftest`` skips
``tests/conftest.py``, which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: fp32 activations -> 1e-5 of the output's largest magnitude
(summation order over D or M); bf16 -> two bf16 ulps of it (z and the
output may each round one ulp apart), four for gradients (a z or gz element
one ulp apart moves a whole sum over M) and for flash attention
(probabilities round to bf16 before the value product in the kernel, after
normalisation in the plain version)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.lm_skiplora import quantize_int8  # noqa: E402
from repro_torch.kernels.skip_lora import kernel as K  # noqa: E402
from repro_torch.kernels.skip_lora import ops  # noqa: E402
from repro_torch.kernels.skip_lora import quant as Q  # noqa: E402
from repro_torch.kernels.skip_lora import ref as R  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attn import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attn import ref as FR  # noqa: E402

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


def _close(got, want, dtype, bf16_rel=2.0**-7):
    scale = want.float().abs().max().item()
    tol = (bf16_rel if dtype == "bfloat16" else 1e-5) * scale
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
    a1, b1 = a[0].requires_grad_(True), b[0].requires_grad_(True)
    ops.skip_lora_fused(x[:, :, None], a1, b1).float().sum().backward()
    R.skip_lora_fwd_ref(x, a1, b1).float().sum().backward()
    assert K.LAUNCHES == {"grouped_skip_sum_fwd": 2, "grouped_skip_sum_fwd_int8": 1,
                          "skip_lora_fwd": 1, "skip_lora_bwd": 1, "skip_lora_fwd_int8": 0,
                          "grouped_skip_sum_fwd_q4": 0, "grouped_skip_sum_fwd_actint8": 0,
                          "grouped_skip_sum_bwd": 0}


def test_kernel_refuses_what_it_cannot_take(cuda):
    x, a, b, idx = _inputs(cuda, (3, 2), 72, "float32")
    with pytest.raises(ValueError, match="rank"):
        ops.skip_lora_grouped(x[:, :, None], a, b, idx)
    x, a, b, idx = _inputs(cuda, (3, 2), 8, "float32")
    with pytest.raises(ValueError, match="row tile"):
        ops.skip_lora_grouped(x[:, :, None], a, b, idx, tm=33)
    with pytest.raises(ValueError, match="dtype"):
        ops.skip_lora_grouped(x[:, :, None], a.half(), b.half(), idx)


# ---------------------------------------------------------------------------
# K7, K8, K9: packed 4-bit pool, int8 activations, grouped backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", Q.Q4_KINDS)
@pytest.mark.parametrize("tm", [1, 7, 16, 32])
@pytest.mark.parametrize("rank", [4, 8, 24, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q4_kernel_matches_plain_version(cuda, kind, tm, rank, dtype):
    x, a, b, idx = _inputs(cuda, (2, 0, 19, 1, 33), rank, dtype)
    a[0], b[0] = 0.0, 0.0                               # a zero slot: scale 0
    qa, sa = Q.quantize_q4(a, kind)
    qb, sb = Q.quantize_q4(b, kind)
    code = Q.codebook(kind, cuda)
    got = ops.skip_lora_grouped_q4(x[:, :, None], qa, sa, qb, sb, code, idx, tm=tm)[:, 0]
    _close(got, R.skip_lora_grouped_q4_ref(x, qa, sa, qb, sb, code, idx), dtype)


def test_q4_zero_slot_is_exactly_zero(cuda):
    x, a, b, idx = _inputs(cuda, (3, 5), 8, "bfloat16", lnum=24, d=2048)
    a[0], b[0] = 0.0, 0.0
    for kind in Q.Q4_KINDS:
        qa, sa = Q.quantize_q4(a, kind)
        qb, sb = Q.quantize_q4(b, kind)
        got = ops.skip_lora_grouped_q4(x[:, :, None], qa, sa, qb, sb, Q.codebook(kind, cuda), idx)[:, 0]
        want = ops.skip_lora_grouped(x[:, :, None], a, b, idx)[:, 0]
        zero = idx == 0
        assert torch.equal(got[zero], want[zero]) and not got[zero].any()


@pytest.mark.parametrize("tm", [1, 7, 16, 32])
@pytest.mark.parametrize("rank", [4, 8, 24, 64])
def test_actint8_kernel_matches_plain_version(cuda, tm, rank):
    x, a, b, idx = _inputs(cuda, (2, 0, 19, 1, 33), rank, "float32")
    q, s = quantize_int8(x)
    for pool_dtype in (torch.float32, torch.bfloat16):
        ap, bp = a.to(pool_dtype), b.to(pool_dtype)
        row_src, tile_slot = ops._plan(idx, ap.shape[0], x.shape[1], tm)
        got = K.grouped_skip_sum_fwd_actint8(q, s, ap, bp, row_src, tile_slot, tm)
        assert got.dtype == torch.bfloat16
        _close(got, R.skip_lora_grouped_actint8_ref(q, s, ap, bp, idx), "bfloat16")


@pytest.mark.parametrize("groups", [(2, 0, 19, 1, 33), (1,), (0, 0, 40), (64, 0, 3)])
@pytest.mark.parametrize("tm", [1, 7, 16, 32])
@pytest.mark.parametrize("rank", [4, 8, 24, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_backward_matches_plain_version(cuda, groups, tm, rank, dtype):
    x, a, b, idx = _inputs(cuda, groups, rank, dtype)
    g = torch.randn(x.shape[1:], generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda).to(x.dtype)
    for pool_dtype in (torch.float32, torch.bfloat16):
        ap, bp = a.to(pool_dtype), b.to(pool_dtype)
        row_src, tile_slot = ops._plan(idx, ap.shape[0], x.shape[1], tm)
        ga, gb = K.grouped_skip_sum_bwd(x, ap, bp, g, row_src, tile_slot, tm)
        wa, wb = R.skip_lora_grouped_bwd_ref(x, ap, bp, g, idx)
        _close(ga, wa, dtype, 2.0**-6)
        _close(gb, wb, dtype, 2.0**-6)
        empty = [n for n, c in enumerate(groups) if c == 0]
        assert not ga[empty].any() and not gb[empty].any()


def test_grouped_backward_is_deterministic(cuda):
    x, a, b, idx = _inputs(cuda, (300, 200, 0, 524), 8, "bfloat16", lnum=24, d=2048)
    g = torch.randn(x.shape[1:], device=cuda).to(x.dtype)
    row_src, tile_slot = ops._plan(idx, 4, x.shape[1], ops.TM)
    first = K.grouped_skip_sum_bwd(x, a, b, g, row_src, tile_slot, ops.TM)
    for _ in range(3):
        again = K.grouped_skip_sum_bwd(x, a, b, g, row_src, tile_slot, ops.TM)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_trainable_wrappers_give_the_kernel_gradients(cuda):
    x, a, b, idx = _inputs(cuda, (5, 0, 9, 3), 8, "bfloat16")
    g = torch.randn(x.shape[1:], device=cuda).to(x.dtype)
    freeze = torch.tensor([False, False, True, False], device=cuda)
    ap, bp = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    K.reset_launches()
    out = ops.skip_lora_grouped_train(x[:, :, None], ap, bp, idx, freeze_mask=freeze)[:, 0]
    (out.float() * g.float()).sum().backward()
    assert K.LAUNCHES["grouped_skip_sum_fwd"] == 1 and K.LAUNCHES["grouped_skip_sum_bwd"] == 1
    row_src, tile_slot = ops._plan(idx, 4, x.shape[1], ops.TM)
    wa, wb = K.grouped_skip_sum_bwd(x, a, b, g, row_src, tile_slot, ops.TM)
    wa[1:3], wb[1:3] = 0.0, 0.0                        # slot 1 empty, slot 2 frozen
    assert torch.equal(ap.grad, wa) and torch.equal(bp.grad, wb)
    q, s = quantize_int8(x.float())
    ap.grad = bp.grad = None
    out = ops.skip_lora_grouped_train_int8(q[:, :, None], s[:, :, None], ap, bp, idx)[:, 0]
    (out.float() * g.float()).sum().backward()
    wa, wb = K.grouped_skip_sum_bwd(ops._dequant_rows(q, s), a, b, g, row_src, tile_slot, ops.TM)
    wa[1], wb[1] = 0.0, 0.0
    assert torch.equal(ap.grad, wa) and torch.equal(bp.grad, wb)
    assert K.LAUNCHES["grouped_skip_sum_fwd_actint8"] == 1


# ---------------------------------------------------------------------------
# K1, K2, K3: one adapter stack over all rows
# ---------------------------------------------------------------------------


def _dense(cuda, lnum, m, d, rank, dtype, wdtype=torch.float32, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((lnum, m, d), generator=g, device=cuda).to(DTYPES[dtype])
    a = (torch.randn((lnum, d, rank), generator=g, device=cuda) / d**0.5).to(wdtype)
    b = (torch.randn((lnum, rank, d), generator=g, device=cuda) * 0.1).to(wdtype)
    gr = torch.randn((m, d), generator=g, device=cuda).to(DTYPES[dtype])
    return x, a, b, gr


@pytest.mark.parametrize("m", [1, 100, 1000, 1024])
@pytest.mark.parametrize("rank", [4, 8, 24, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_kernels_match_plain_versions(cuda, m, rank, dtype):
    for wdtype in (torch.float32, torch.bfloat16):
        x, a, b, g = _dense(cuda, 3, m, 200, rank, dtype, wdtype)
        _close(K.skip_lora_fwd(x, a, b), R.skip_lora_fwd_ref(x, a, b), dtype)
        ga, gb = K.skip_lora_bwd(x, a, b, g)
        wa, wb = R.skip_lora_bwd_ref(x, a, b, g)
        _close(ga, wa, dtype, 2.0**-6)
        _close(gb, wb, dtype, 2.0**-6)
        q, s = quantize_int8(x)
        _close(K.skip_lora_fwd_int8(q, s, a, b), R.skip_lora_int8_fwd_ref(q, s, a, b), "bfloat16")


def test_backward_is_deterministic(cuda):
    x, a, b, g = _dense(cuda, 24, 1000, 2048, 8, "bfloat16")
    first = K.skip_lora_bwd(x, a, b, g)
    for _ in range(3):
        again = K.skip_lora_bwd(x, a, b, g)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_autograd_wrappers_give_the_kernel_gradients(cuda):
    x, a, b, g = _dense(cuda, 4, 300, 128, 8, "bfloat16")
    a.requires_grad_(True)
    b.requires_grad_(True)
    out = ops.skip_lora_fused(x[:, :, None], a, b)[:, 0]
    (out.float() * g.float()).sum().backward()
    ga, gb = K.skip_lora_bwd(x, a.detach(), b.detach(), g)
    assert torch.equal(a.grad, ga) and torch.equal(b.grad, gb)


# ---------------------------------------------------------------------------
# K4: flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    # (b, h, hkv, s, hd, window, softcap)
    (2, 4, 4, 128, 64, 0, 0.0),
    (1, 4, 2, 200, 32, 0, 0.0),
    (1, 2, 1, 256, 128, 64, 0.0),
    (1, 4, 2, 512, 256, 100, 50.0),
    (1, 1, 1, 70, 80, 0, 30.0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version(cuda, case, dtype):
    b, h, hkv, s, hd, window, cap = case
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(DTYPES[dtype])
               for shape in ((b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd)))
    FK.reset_launches()
    got = FO.flash_attention(q, k, v, window=window, softcap=cap)
    assert FK.LAUNCHES["flash_attn_fwd"] == 1
    _close(got, FR.flash_attention_ref(q, k, v, window=window, softcap=cap), dtype, 2.0**-6)
