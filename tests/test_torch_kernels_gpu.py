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
from repro_torch.kernels.flash_attn import paged as PG  # noqa: E402
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


@pytest.mark.parametrize("groups", [(256, 256, 256, 256), (300, 0, 200, 524)])
@pytest.mark.parametrize("tm", [1, 7, 16, 32])
@pytest.mark.parametrize("rank", [4, 8, 24, 64])
def test_grouped_forward_tensor_cores_at_many_rows(cuda, groups, tm, rank):
    x, a, b, idx = _inputs(cuda, groups, rank, "bfloat16", d=256)
    row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], tm)
    for pool_dtype in (torch.float32, torch.bfloat16):
        ap, bp = a.to(pool_dtype), b.to(pool_dtype)
        got = K.grouped_skip_sum_fwd(x, ap, bp, row_src, tile_slot, tm)
        _close(got, R.skip_lora_grouped_ref(x, ap, bp, idx), "bfloat16")


@pytest.mark.parametrize("case", [
    # (groups, rank, tm, d, row offset in elements)
    ((5, 0, 11), 8, 16, 100, 0),              # D 100, not a multiple of 8: plain loads
    ((40, 0, 77, 0, 5, 130), 9, 7, 200, 0),   # N 6, two empty slots, R 9
    ((33, 64), 1, 32, 256, 0),                # rank 1
    ((64, 0, 3), 64, 1, 256, 1),              # x 2 bytes past a 16-byte boundary
])
def test_grouped_forward_tensor_core_edges(cuda, case):
    groups, rank, tm, d, offset = case
    x, a, b, idx = _inputs(cuda, groups, rank, "bfloat16", lnum=3, d=d, seed=5)
    if offset:
        shifted = torch.empty(x.numel() + offset, dtype=x.dtype, device=cuda)[offset:].view(x.shape)
        shifted.copy_(x)
        x = shifted
        assert x.data_ptr() % 16
    row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], tm)
    got = K.grouped_skip_sum_fwd(x, a, b, row_src, tile_slot, tm)
    _close(got, R.skip_lora_grouped_ref(x, a, b, idx), "bfloat16")


def test_grouped_forward_zero_slot_is_exactly_zero(cuda):
    x, a, b, idx = _inputs(cuda, (128, 128, 128, 128), 8, "bfloat16", lnum=24, d=2048)
    a[0], b[0] = 0.0, 0.0
    row_src, tile_slot = ops._plan(idx, 4, x.shape[1], ops.TM)
    got = K.grouped_skip_sum_fwd(x, a, b, row_src, tile_slot, ops.TM)
    zero = idx == 0
    assert not got[zero].any() and got[~zero].all(dim=-1).any()


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


# K7 (bf16 rows) and K8 on K5's tensor-core passes. Shapes: a decode step
# (one row in each of 5 slots of 6), the fleet step (4 slots of 256) and
# ragged groups with an empty slot.
TC_SHAPES = {"decode": (1, 1, 1, 1, 1, 0), "fleet": (256, 256, 256, 256), "ragged": (300, 0, 200, 524)}


def _launch_k5(x, a, b, row_src, tile_slot, tm, few):
    """K5's bf16 route launched with the geometry given, not the one
    ``kernel.grouped_fwd_geometry`` picks."""
    lnum, m, d = x.shape
    m_pad, r = row_src.numel(), a.shape[-1]
    z = K._grouped_scratch(x, lnum, m_pad, r)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    K.LIB.launch("grouped_skip_sum_fwd", x, x.data_ptr(), a.data_ptr(), b.data_ptr(), row_src.data_ptr(),
                 tile_slot.data_ptr(), z.data_ptr(), out.data_ptr(), lnum, m, d, r, tm, m_pad // tm, 1,
                 int(a.dtype == torch.bfloat16), few)
    return out


def _launch_k7(x, pool, row_src, tile_slot, tm, few):
    lnum, m, d = x.shape
    m_pad, r = row_src.numel(), 2 * pool[0].shape[-1]
    z = K._grouped_scratch(x, lnum, m_pad, r)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    K.LIB.launch("grouped_skip_sum_fwd_q4", x, x.data_ptr(), *(t.data_ptr() for t in pool), row_src.data_ptr(),
                 tile_slot.data_ptr(), z.data_ptr(), out.data_ptr(), lnum, m, d, r, tm, m_pad // tm, 1, few)
    return out


def _launch_k8(q, s, a, b, row_src, tile_slot, tm, few):
    lnum, m, d = q.shape
    m_pad, r = row_src.numel(), a.shape[-1]
    z = K._grouped_scratch(q, lnum, m_pad, r)
    out = torch.empty((m, d), dtype=torch.bfloat16, device=q.device)
    K.LIB.launch("grouped_skip_sum_fwd_actint8", q, q.data_ptr(), s.data_ptr(), a.data_ptr(), b.data_ptr(),
                 row_src.data_ptr(), tile_slot.data_ptr(), z.data_ptr(), out.data_ptr(), lnum, m, d, r, tm,
                 m_pad // tm, int(a.dtype == torch.bfloat16), few)
    return out


def _launch_k6(x, pool, row_src, tile_slot, tm, few):
    lnum, m, d = x.shape
    m_pad, r = row_src.numel(), pool[0].shape[-1]
    z = K._grouped_scratch(x, lnum, m_pad, r)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    K.LIB.launch("grouped_skip_sum_fwd_int8", x, x.data_ptr(), *(t.data_ptr() for t in pool), row_src.data_ptr(),
                 tile_slot.data_ptr(), z.data_ptr(), out.data_ptr(), lnum, m, d, r, tm, m_pad // tm, 1, few)
    return out


def _q4(a, b, kind, cuda):
    return (*Q.quantize_q4(a, kind), *Q.quantize_q4(b, kind), Q.codebook(kind, cuda))


def _int8(a, b):
    return (*quantize_int8(a), *quantize_int8(b))


def _dequant_int8(pool):
    qa, sa, qb, sb = pool
    return qa.float() * sa[..., None], qb.float() * sb[..., None]


@pytest.mark.parametrize("shape", list(TC_SHAPES))
@pytest.mark.parametrize("rank", [4, 8, 16, 32, 64])
def test_q4_tensor_cores_match_plain_version_and_k5(cuda, shape, rank):
    """K7 with bf16 rows within two bf16 ulps of its plain version, the same
    bits on a second run, and bitwise K5 over the dequantised pool (each
    element code[nibble] scale in fp32, then the same passes)."""
    groups = TC_SHAPES[shape]
    x, a, b, idx = _inputs(cuda, groups, rank, "bfloat16", lnum=4, d=2048, seed=rank)
    a[0], b[0] = 0.0, 0.0
    row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], ops.TM)
    assert K.grouped_fwd_route(x.dtype) == "tensor_cores"
    for kind in Q.Q4_KINDS:
        pool = _q4(a, b, kind, cuda)
        got = K.grouped_skip_sum_fwd_q4(x, *pool, row_src, tile_slot, ops.TM)
        _close(got, R.skip_lora_grouped_q4_ref(x, *pool, idx), "bfloat16")
        assert torch.equal(got, K.grouped_skip_sum_fwd_q4(x, *pool, row_src, tile_slot, ops.TM))
        qa, sa, qb, sb, code = pool
        k5 = K.grouped_skip_sum_fwd(x, Q.dequantize_q4(qa, sa, code), Q.dequantize_q4(qb, sb, code), row_src,
                                    tile_slot, ops.TM)
        assert torch.equal(got, k5)
        assert not got[idx == 0].any()


@pytest.mark.parametrize("shape", list(TC_SHAPES))
@pytest.mark.parametrize("rank", [4, 8, 16, 32, 64])
def test_actint8_tensor_cores_match_plain_version_and_k5(cuda, shape, rank):
    """K8 within two bf16 ulps of its plain version, the same bits on a
    second run, and bitwise K5 over the rows dequantised to bf16."""
    groups = TC_SHAPES[shape]
    x, a, b, idx = _inputs(cuda, groups, rank, "float32", lnum=4, d=2048, seed=rank)
    q, s = quantize_int8(x)
    row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], ops.TM)
    assert K.grouped_fwd_route(q.dtype) == "tensor_cores"
    for pool_dtype in (torch.float32, torch.bfloat16):
        ap, bp = a.to(pool_dtype), b.to(pool_dtype)
        got = K.grouped_skip_sum_fwd_actint8(q, s, ap, bp, row_src, tile_slot, ops.TM)
        _close(got, R.skip_lora_grouped_actint8_ref(q, s, ap, bp, idx), "bfloat16")
        assert torch.equal(got, K.grouped_skip_sum_fwd_actint8(q, s, ap, bp, row_src, tile_slot, ops.TM))
        rows = (q.float() * s[..., None]).to(torch.bfloat16)
        assert torch.equal(got, K.grouped_skip_sum_fwd(rows, ap, bp, row_src, tile_slot, ops.TM))


@pytest.mark.parametrize("case", [
    # (groups, rank, tm, d, byte offset of the rows)
    ((5, 0, 11), 8, 16, 100, 0),              # D 100: plain loads everywhere
    ((5, 0, 11), 8, 16, 200, 0),              # D 200: plain int8 and 4-bit loads, bf16 copies
    ((1, 1, 1, 1, 1, 0), 16, 16, 2048, 2),    # rows 2 bytes past a 16-byte boundary, decode shape
    ((40, 0, 77, 0, 5, 130), 24, 7, 256, 1),  # tm 7, two empty slots, rows 1 byte off (int8)
    ((3, 0, 2), 4, 32, 256, 0),               # tm 32, a few rows: two blocks a tile
    ((2, 0, 19, 1, 33), 64, 1, 256, 0),       # tm 1
])
def test_tensor_core_quantised_forward_edges(cuda, case):
    groups, rank, tm, d, offset = case
    x, a, b, idx = _inputs(cuda, groups, rank, "float32", lnum=3, d=d, seed=9)
    a[0], b[0] = 0.0, 0.0
    q, s = quantize_int8(x)
    xb = x.to(torch.bfloat16)
    if offset:
        q = torch.empty(q.numel() + offset, dtype=q.dtype, device=cuda)[offset:].view(q.shape).copy_(q)
        xb = torch.empty(xb.numel() + 1, dtype=xb.dtype, device=cuda)[1:].view(xb.shape).copy_(xb)
        assert q.data_ptr() % 16 and xb.data_ptr() % 16
    row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], tm)
    got = K.grouped_skip_sum_fwd_actint8(q, s, a, b, row_src, tile_slot, tm)
    _close(got, R.skip_lora_grouped_actint8_ref(q, s, a, b, idx), "bfloat16")
    for kind in Q.Q4_KINDS:
        pool = _q4(a, b, kind, cuda)
        got = K.grouped_skip_sum_fwd_q4(xb, *pool, row_src, tile_slot, tm)
        _close(got, R.skip_lora_grouped_q4_ref(xb, *pool, idx), "bfloat16")
        assert not got[idx == 0].any()


@pytest.mark.parametrize("shape", ["serve", *TC_SHAPES])
@pytest.mark.parametrize("rank", [8, 64])
def test_geometries_give_the_same_bits(cuda, shape, rank):
    """The few-row and many-row geometries of the tensor-core route give
    the same bits (each position's sums in the same k order), for K5 (so its
    serve shape, which now takes the few-row geometry, keeps the many-row
    bits), K6, K7 and K8."""
    groups = (1, 1, 1, 1) if shape == "serve" else TC_SHAPES[shape]
    x, a, b, idx = _inputs(cuda, groups, rank, "float32", lnum=4, d=2048, seed=3)
    q, s = quantize_int8(x)
    xb = x.to(torch.bfloat16)
    row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], ops.TM)
    pool = _q4(a, b, "nf4", cuda)
    pool8 = _int8(a, b)
    for run in (lambda few: _launch_k5(xb, a, b, row_src, tile_slot, ops.TM, few),
                lambda few: _launch_k6(xb, pool8, row_src, tile_slot, ops.TM, few),
                lambda few: _launch_k7(xb, pool, row_src, tile_slot, ops.TM, few),
                lambda few: _launch_k8(q, s, a, b, row_src, tile_slot, ops.TM, few)):
        assert torch.equal(run(0), run(1))


@pytest.mark.parametrize("shape", list(TC_SHAPES))
def test_q4_fp32_rows_stay_the_cuda_core_passes(cuda, shape):
    """K7 with fp32 rows runs the CUDA-core passes it ran before: bitwise K5's
    fp32 route over the dequantised pool, within 1e-5 of the plain version."""
    groups = TC_SHAPES[shape]
    x, a, b, idx = _inputs(cuda, groups, 8, "float32", lnum=4, d=2048, seed=2)
    row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], ops.TM)
    assert K.grouped_fwd_route(x.dtype) == "cuda_cores"
    for kind in Q.Q4_KINDS:
        qa, sa, qb, sb, code = _q4(a, b, kind, cuda)
        got = K.grouped_skip_sum_fwd_q4(x, qa, sa, qb, sb, code, row_src, tile_slot, ops.TM)
        _close(got, R.skip_lora_grouped_q4_ref(x, qa, sa, qb, sb, code, idx), "float32")
        k5 = K.grouped_skip_sum_fwd(x, Q.dequantize_q4(qa, sa, code), Q.dequantize_q4(qb, sb, code), row_src,
                                    tile_slot, ops.TM)
        assert torch.equal(got, k5)


@pytest.mark.parametrize("groups", [(3, 5), (128, 128, 128, 128)])
def test_q4_zero_slot_is_k5s_exact_zeros_in_both_geometries(cuda, groups):
    x, a, b, idx = _inputs(cuda, groups, 8, "bfloat16", lnum=24, d=2048)
    a[0], b[0] = 0.0, 0.0
    want = ops.skip_lora_grouped(x[:, :, None], a, b, idx)[:, 0]
    zero = idx == 0
    for kind in Q.Q4_KINDS:
        got = ops.skip_lora_grouped_q4(x[:, :, None], *_q4(a, b, kind, cuda), idx)[:, 0]
        assert torch.equal(got[zero], want[zero]) and not got[zero].any()


# K6 (int8 pool) with bf16 rows on the same passes (``stc::Int8Pool``).


@pytest.mark.parametrize("shape", ["serve", *TC_SHAPES])
@pytest.mark.parametrize("rank", [4, 8, 16, 32, 64])
def test_int8_pool_tensor_cores_match_plain_version_and_k5(cuda, shape, rank):
    """K6 with bf16 rows within two bf16 ulps of its plain version, the same
    bits on a second run, bitwise K5 over the dequantised pool (each element
    float(q) scale in fp32, then the same passes), and the zero slot exact
    zeros."""
    groups = (1, 1, 1, 1) if shape == "serve" else TC_SHAPES[shape]
    x, a, b, idx = _inputs(cuda, groups, rank, "bfloat16", lnum=4, d=2048, seed=rank)
    a[0], b[0] = 0.0, 0.0
    pool = _int8(a, b)
    row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], ops.TM)
    assert K.grouped_fwd_route(x.dtype) == "tensor_cores"
    got = K.grouped_skip_sum_fwd_int8(x, *pool, row_src, tile_slot, ops.TM)
    _close(got, R.skip_lora_grouped_int8_ref(x, *pool, idx), "bfloat16")
    assert torch.equal(got, K.grouped_skip_sum_fwd_int8(x, *pool, row_src, tile_slot, ops.TM))
    assert torch.equal(got, K.grouped_skip_sum_fwd(x, *_dequant_int8(pool), row_src, tile_slot, ops.TM))
    assert not got[idx == 0].any()


@pytest.mark.parametrize("case", [
    # (groups, rank, tm, d, element offset of the rows)
    ((5, 0, 11), 8, 16, 100, 0),              # D 100: plain loads everywhere
    ((5, 0, 11), 4, 16, 200, 0),              # D 200, not a multiple of 16: plain int8 pool loads
    ((1, 1, 1, 1, 1, 0), 16, 16, 2048, 1),    # rows 2 bytes past a 16-byte boundary, decode shape
    ((40, 0, 77, 0, 5, 130), 32, 7, 248, 0),  # tm 7, two empty slots, D 248
    ((3, 0, 2), 64, 32, 256, 0),              # tm 32, a few rows: two blocks a tile
    ((2, 0, 19, 1, 33), 9, 1, 256, 0),        # tm 1, R 9
])
def test_int8_pool_tensor_core_edges(cuda, case):
    groups, rank, tm, d, offset = case
    x, a, b, idx = _inputs(cuda, groups, rank, "bfloat16", lnum=3, d=d, seed=11)
    a[0], b[0] = 0.0, 0.0
    if offset:
        x = torch.empty(x.numel() + offset, dtype=x.dtype, device=cuda)[offset:].view(x.shape).copy_(x)
        assert x.data_ptr() % 16
    pool = _int8(a, b)
    row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], tm)
    got = K.grouped_skip_sum_fwd_int8(x, *pool, row_src, tile_slot, tm)
    _close(got, R.skip_lora_grouped_int8_ref(x, *pool, idx), "bfloat16")
    assert not got[idx == 0].any()
    assert torch.equal(got, K.grouped_skip_sum_fwd(x, *_dequant_int8(pool), row_src, tile_slot, tm))


@pytest.mark.parametrize("shape", ["serve", *TC_SHAPES])
def test_int8_pool_fp32_rows_stay_the_cuda_core_passes(cuda, shape):
    """K6 with fp32 rows runs the CUDA-core passes: within 1e-5 of the plain
    version, and bitwise K5's fp32 route over the dequantised pool."""
    groups = (1, 1, 1, 1) if shape == "serve" else TC_SHAPES[shape]
    x, a, b, idx = _inputs(cuda, groups, 8, "float32", lnum=4, d=2048, seed=2)
    pool = _int8(a, b)
    row_src, tile_slot = ops._plan(idx, len(groups), x.shape[1], ops.TM)
    assert K.grouped_fwd_route(x.dtype) == "cuda_cores"
    got = K.grouped_skip_sum_fwd_int8(x, *pool, row_src, tile_slot, ops.TM)
    _close(got, R.skip_lora_grouped_int8_ref(x, *pool, idx), "float32")
    assert torch.equal(got, K.grouped_skip_sum_fwd(x, *_dequant_int8(pool), row_src, tile_slot, ops.TM))


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


@pytest.mark.parametrize("case", [
    # (groups, rank, tm, d, pool dtype)
    ((300, 0, 200, 524), 8, 16, 2048, torch.float32),   # runs of several 16-row steps, ragged tails
    ((40, 0, 77, 0, 5, 130), 8, 16, 200, torch.float32),   # N 6, two empty slots
    ((2, 0, 19, 1, 33), 64, 1, 200, torch.bfloat16),    # tm 1 at R 64, bf16 pool
    ((5, 0, 11), 8, 16, 100, torch.float32),            # D 100, not a multiple of 8: plain loads
])
def test_grouped_backward_tensor_core_edges(cuda, case):
    groups, rank, tm, d, pool_dtype = case
    x, a, b, idx = _inputs(cuda, groups, rank, "bfloat16", lnum=2, d=d, seed=5)
    g = torch.randn(x.shape[1:], generator=torch.Generator(device=cuda).manual_seed(6),
                    device=cuda).to(x.dtype)
    ap, bp = a.to(pool_dtype), b.to(pool_dtype)
    row_src, tile_slot = ops._plan(idx, ap.shape[0], x.shape[1], tm)
    ga, gb = K.grouped_skip_sum_bwd(x, ap, bp, g, row_src, tile_slot, tm)
    wa, wb = R.skip_lora_grouped_bwd_ref(x, ap, bp, g, idx)
    _close(ga, wa, "bfloat16", 2.0**-6)
    _close(gb, wb, "bfloat16", 2.0**-6)
    empty = [n for n, c in enumerate(groups) if c == 0]
    assert not ga[empty].any() and not gb[empty].any()
    again = K.grouped_skip_sum_bwd(x, ap, bp, g, row_src, tile_slot, tm)
    assert torch.equal(ga, again[0]) and torch.equal(gb, again[1])


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
        got = K.skip_lora_fwd_int8(q, s, a, b)
        _close(got, R.skip_lora_int8_fwd_ref(q, s, a, b), "bfloat16")
        assert torch.equal(got, _k8_one_slot(q, s, a, b))       # K3 is K8's one-slot form
        if dtype == "bfloat16":                                 # K1's bf16 rows are K5's one-slot form
            assert torch.equal(K.skip_lora_fwd(x, a, b), _k5_one_slot(x, a, b))


def _k5_one_slot(x, a, b):
    """K5 over one slot holding a and b, every row its own tile (tm 1): the
    launch K1 makes for bf16 rows with null row_src and tile_slot, made
    explicit."""
    m = x.shape[1]
    row_src = torch.arange(m, dtype=torch.int32, device=x.device)
    tile_slot = torch.zeros(m, dtype=torch.int32, device=x.device)
    return K.grouped_skip_sum_fwd(x, a[None], b[None], row_src, tile_slot, 1)


def _k8_one_slot(q, s, a, b):
    """K8 over one slot holding a and b, every row its own tile (tm 1): the
    launch K3 makes with null row_src and tile_slot, made explicit."""
    m = q.shape[1]
    row_src = torch.arange(m, dtype=torch.int32, device=q.device)
    tile_slot = torch.zeros(m, dtype=torch.int32, device=q.device)
    return K.grouped_skip_sum_fwd_actint8(q, s, a[None], b[None], row_src, tile_slot, 1)


@pytest.mark.parametrize("d", [2048, 200])
@pytest.mark.parametrize("rank", [4, 8, 16, 32, 64])
def test_int8_cache_forward_on_the_tensor_cores(cuda, d, rank):
    """K3 at the cached step's M and L (D 2048; D 200 takes the plain loads)
    within two bf16 ulps of its plain version, the same bits on a second run,
    bitwise K8's one-slot launch and K5's one-slot launch over the rows
    dequantised to bf16."""
    x, a, b, _ = _dense(cuda, 24, 1024, d, rank, "float32", seed=rank)
    q, s = quantize_int8(x)
    assert K.grouped_fwd_route(q.dtype) == "tensor_cores"
    for wdtype in (torch.float32, torch.bfloat16):
        aw, bw = a.to(wdtype), b.to(wdtype)
        got = K.skip_lora_fwd_int8(q, s, aw, bw)
        _close(got, R.skip_lora_int8_fwd_ref(q, s, aw, bw), "bfloat16")
        assert torch.equal(got, K.skip_lora_fwd_int8(q, s, aw, bw))
        assert torch.equal(got, _k8_one_slot(q, s, aw, bw))
        rows = (q.float() * s[..., None]).to(torch.bfloat16)
        m = q.shape[1]
        one = torch.zeros(m, dtype=torch.int32, device=cuda)
        assert torch.equal(got, K.grouped_skip_sum_fwd(rows, aw[None], bw[None],
                                                       torch.arange(m, dtype=torch.int32, device=cuda), one, 1))


@pytest.mark.parametrize("d", [2048, 200])
@pytest.mark.parametrize("rank", [4, 8, 16, 32, 64])
def test_dense_forward_on_the_tensor_cores(cuda, d, rank):
    """K1's bf16 rows at the cached step's M and L (D 2048; D 200 takes the
    plain loads) within two bf16 ulps of the plain version, the same bits on
    a second run, and bitwise K5's one-slot launch."""
    x, a, b, _ = _dense(cuda, 24, 1024, d, rank, "bfloat16", seed=rank)
    assert K.grouped_fwd_route(x.dtype) == "tensor_cores"
    for wdtype in (torch.float32, torch.bfloat16):
        aw, bw = a.to(wdtype), b.to(wdtype)
        got = K.skip_lora_fwd(x, aw, bw)
        _close(got, R.skip_lora_fwd_ref(x, aw, bw), "bfloat16")
        assert torch.equal(got, K.skip_lora_fwd(x, aw, bw))
        assert torch.equal(got, _k5_one_slot(x, aw, bw))


@pytest.mark.parametrize("case", [
    # (layers, M, D, rank, adapter dtype, offset of x in elements)
    (24, 1000, 2048, 8, torch.float32, 0),   # ragged M: the last tiles pad past M
    (3, 1, 256, 8, torch.bfloat16, 0),       # one row
    (3, 257, 200, 40, torch.float32, 0),     # D 200, R 33-64: z L * 64 wide
    (2, 300, 100, 9, torch.bfloat16, 0),     # D 100, not a multiple of 8: plain loads
    (3, 300, 256, 8, torch.float32, 3),      # x 6 bytes off a 16-byte boundary: plain loads
])
def test_dense_forward_tensor_core_edges(cuda, case):
    lnum, m, d, rank, wdtype, off = case
    x, a, b, _ = _dense(cuda, lnum, m, d, rank, "bfloat16", wdtype, seed=5)
    if off:
        x = torch.empty(x.numel() + off, dtype=x.dtype, device=cuda)[off:].view(x.shape).copy_(x)
        assert x.data_ptr() % 16
    got = K.skip_lora_fwd(x, a, b)
    _close(got, R.skip_lora_fwd_ref(x, a, b), "bfloat16")
    assert torch.equal(got, _k5_one_slot(x, a, b))


def test_int8_cache_forward_rows_off_a_16_byte_boundary(cuda):
    x, a, b, _ = _dense(cuda, 3, 300, 256, 8, "float32", seed=4)
    q, s = quantize_int8(x)
    q = torch.empty(q.numel() + 3, dtype=q.dtype, device=cuda)[3:].view(q.shape).copy_(q)
    assert q.data_ptr() % 16
    _close(K.skip_lora_fwd_int8(q, s, a, b), R.skip_lora_int8_fwd_ref(q, s, a, b), "bfloat16")


def test_backward_is_deterministic(cuda):
    x, a, b, g = _dense(cuda, 24, 1000, 2048, 8, "bfloat16")
    first = K.skip_lora_bwd(x, a, b, g)
    for _ in range(3):
        again = K.skip_lora_bwd(x, a, b, g)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.parametrize("case", [
    # (layers, M, D, rank, adapter dtype)
    (3, 300, 100, 8, torch.float32),      # D 100, not a multiple of 8: plain loads
    (2, 257, 256, 9, torch.bfloat16),     # a chunk of one row, R 9
    (24, 1024, 2048, 8, torch.float32),   # the cached step: 4 chunks
])
def test_tensor_core_backward_edges_are_repeatable(cuda, case):
    lnum, m, d, rank, wdtype = case
    x, a, b, g = _dense(cuda, lnum, m, d, rank, "bfloat16", wdtype, seed=3)
    ga, gb = K.skip_lora_bwd(x, a, b, g)
    wa, wb = R.skip_lora_bwd_ref(x, a, b, g)
    _close(ga, wa, "bfloat16", 2.0**-6)
    _close(gb, wb, "bfloat16", 2.0**-6)
    again = K.skip_lora_bwd(x, a, b, g)
    assert torch.equal(ga, again[0]) and torch.equal(gb, again[1])


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
    (1, 2, 2, 130, 96, 0, 0.0),       # hd 96: padded to 128 in the bf16 tiles
    (2, 2, 1, 1, 64, 0, 0.0),         # S 1
    (1, 4, 2, 17, 64, 0, 0.0),        # S 17: one ragged tile
    (1, 2, 2, 100, 64, 1, 0.0),       # window 1: each query sees only itself
    (1, 8, 2, 300, 128, 0, 30.0),     # GQA group of 4 with softcap at hd 128
    (1, 2, 1, 45, 20, 0, 0.0),        # hd 20, not a multiple of 8: plain loads and stores
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


# ---------------------------------------------------------------------------
# K10: paged KV block gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    # (layers or None, n_blocks, block, n_kv, hd, dtype, rows, slots)
    (24, 128, 32, 32, 64, torch.bfloat16, 2, 14),    # the scheduler's reuse wave, full width
    (None, 16, 8, 4, 96, torch.float32, 3, 5),       # ragged, no layer axis
    (3, 9, 3, 1, 5, torch.bfloat16, 4, 3),           # 30-byte blocks: the narrow-unit path
    (2, 7, 5, 3, 7, torch.float16, 2, 6),            # 210-byte blocks
])
def test_paged_gather_is_bitwise_the_plain_version(cuda, case):
    lnum, nb, blk, nkv, hd, dtype, rows, slots = case
    g = torch.Generator(device=cuda).manual_seed(2)
    lead = (lnum,) if lnum else ()
    pool = torch.randn(lead + (nb, blk, nkv, hd), generator=g, device=cuda).to(dtype)
    tables = torch.randint(0, nb, (rows, slots), generator=g, device=cuda, dtype=torch.int32)
    tables[0, -1] = tables[0, 0]                     # a repeated id
    PG.reset_launches()
    got = PG.gather(pool, tables)
    torch.cuda.synchronize()
    assert PG.LAUNCHES["paged_gather"] == 1
    assert torch.equal(got, PG.paged_gather_ref(pool, tables))
    assert tuple(got.shape) == lead + (rows, slots * blk, nkv, hd)


def test_paged_gather_counts_one_launch_per_call_and_refuses_what_it_cannot_take(cuda):
    pool = torch.zeros((2, 4, 8, 2, 16), dtype=torch.bfloat16, device=cuda)
    tables = torch.tensor([[1, 3]], dtype=torch.int32, device=cuda)
    PG.reset_launches()
    for _ in range(3):
        PG.gather(pool, tables)
    assert PG.LAUNCHES["paged_gather"] == 3
    PG.paged_gather_ref(pool, tables)                # the plain version launches nothing
    assert PG.LAUNCHES["paged_gather"] == 3
    with pytest.raises(ValueError, match="int32"):
        PG.paged_gather(pool, tables.long())
    with pytest.raises(ValueError, match="contiguous"):
        PG.paged_gather(pool.transpose(-1, -2), tables)
    with pytest.raises(ValueError, match="dtype"):
        PG.paged_gather(pool.to(torch.int16), tables)
    assert PG.LAUNCHES["paged_gather"] == 3


def test_paged_decode_through_k10_is_bitwise_the_dense_branch(cuda):
    """``attn_decode_paged`` with the gather on K10 against the dense
    per-row decode over the same K/V bytes, bf16 as the serve caches."""
    from repro_torch.models import attention as A
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=256, n_heads=8, n_kv_heads=4,
                      d_ff=64, vocab_size=64, dtype="bfloat16")
    spec = A.AttnSpec.from_config(cfg, local=False)
    g = torch.Generator(device=cuda).manual_seed(3)
    params = A.init_attn(g, cfg, torch.bfloat16)
    b, t, blk, hd = 3, 64, 16, cfg.resolved_head_dim
    x = torch.randn((b, 1, cfg.d_model), generator=g, device=cuda).to(torch.bfloat16)
    cache = {n: torch.randn((b, t, cfg.n_kv_heads, hd), generator=g, device=cuda).to(torch.bfloat16)
             for n in ("k", "v")}
    pool = {n: c.reshape(b * t // blk, blk, *c.shape[2:]).clone() for n, c in cache.items()}
    table = torch.arange(b * t // blk, dtype=torch.int32, device=cuda).reshape(b, t // blk)
    pos = torch.tensor([0, t // 2, t - 1], device=cuda)
    PG.reset_launches()
    y_p, pool = A.attn_decode_paged(params, x, pos, spec, pool, table, use_kernel=True)
    assert PG.LAUNCHES["paged_gather"] == 2
    y_d, cache = A.attn_decode(params, x, pos, spec, cache)
    assert torch.equal(y_p, y_d)
    for n in ("k", "v"):
        assert torch.equal(pool[n].reshape(cache[n].shape), cache[n])
