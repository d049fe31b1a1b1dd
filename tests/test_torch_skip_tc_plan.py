"""What the tensor-core routes of K5 and K2 take from their wrappers, checked
on the CPU.

K5's bf16 rows (``kernel.grouped_fwd_route``) take the tensor cores: z
per (grouped position, layer) into an (M_pad, L * RP) bf16 scratch whose k
axis is k = l * RP + r, RP the rank padded to whole 8-wide mma n-tiles
(``kernel.bwd_scratch_rank``), then a sum over k against the slot's B stack,
each row written back through ``row_src``. K2's bf16 route rounds z and gz
to bf16 into (L, M, RP) scratch and sums over M in ``BWD_CHUNK``-row chunks
whose fp32 partials are added in chunk order. These tests hold the route
helper and the wrappers' launch arguments, and plain models of both layouts
and sums, to the plain versions in ``ref.py``: a model that puts a value in
the wrong column, slot or chunk misses them by far more than the bf16
bars."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.skip_lora import kernel as K  # noqa: E402
from repro_torch.kernels.skip_lora import ops  # noqa: E402
from repro_torch.kernels.skip_lora import ref as R  # noqa: E402

GROUPS = [(2, 0, 19, 1, 33), (1,), (0, 0, 40), (64, 0, 3), (40, 0, 77, 0, 5, 130)]
BF16 = torch.bfloat16


def test_route_follows_the_row_dtype():
    assert K.grouped_fwd_route(BF16) == "tensor_cores"
    assert K.grouped_fwd_route(torch.float32) == "cuda_cores"


@pytest.fixture
def recorded(monkeypatch):
    """K.LIB.launch replaced by a recorder that counts as the real one does,
    so the wrappers run on CPU tensors up to the launch."""
    calls = []

    def launch(name, x, *args):
        calls.append((name, args))
        K.LIB.launches[name] += 1

    monkeypatch.setattr(K.LIB, "launch", launch)
    K.reset_launches()
    return calls


def _pool(n, lnum, d, r, dtype=torch.float32):
    return torch.zeros((n, lnum, d, r), dtype=dtype), torch.zeros((n, lnum, r, d), dtype=dtype)


@pytest.mark.parametrize("m", [4, 1024])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_grouped_forward_launches_once_per_call(recorded, m, dtype):
    lnum, d, r, n, tm = 3, 64, 9, 4, 16
    x = torch.zeros((lnum, m, d), dtype=dtype)
    a, b = _pool(n, lnum, d, r)
    idx = torch.arange(m, dtype=torch.int32) % n
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    K.grouped_skip_sum_fwd(x, a, b, row_src, tile_slot, tm)
    K.grouped_skip_sum_fwd(x, a, b, row_src, tile_slot, tm)
    assert K.LAUNCHES["grouped_skip_sum_fwd"] == 2 and len(recorded) == 2
    assert sum(K.LAUNCHES.values()) == 2
    (_, args) = recorded[0]
    assert args[7:] == (lnum, m, d, r, tm, row_src.numel() // tm, int(dtype == BF16), 0)


@pytest.mark.parametrize("m", [1, 256, 257, 1024])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_dense_backward_launches_once_with_the_chunk(recorded, m, dtype):
    lnum, d, r = 2, 32, 8
    x = torch.zeros((lnum, m, d), dtype=dtype)
    a, b = torch.zeros((lnum, d, r)), torch.zeros((lnum, r, d))
    ga, gb = K.skip_lora_bwd(x, a, b, torch.zeros((m, d), dtype=dtype))
    assert K.LAUNCHES["skip_lora_bwd"] == 1 and len(recorded) == 1
    (_, args) = recorded[0]
    assert args[10:17] == (lnum, m, d, r, K.BWD_CHUNK, int(dtype == BF16), 0)
    assert (args[6] is None) == (K.bwd_chunks(m) == 1)          # partials only with several chunks
    assert ga.shape == (lnum, d, r) and gb.shape == (lnum, r, d)


def test_cached_step_chunks_fill_the_card():
    """K2's outer pass at the cached step (M 1024, L 24, D 2048, R 8) has one
    block per (chunk, 4 layers, 128 columns): at least the H100's 132 SMs."""
    assert K.bwd_chunks(1024) * (24 // 4) * (2048 // 128) >= 132
    assert K.bwd_chunks(1) == 1 and K.bwd_chunks(K.BWD_CHUNK) == 1 and K.bwd_chunks(K.BWD_CHUNK + 1) == 2


def _bf(t):
    return t.to(BF16).float()


def _inputs(rng, lnum, m, d, n, r):
    x = torch.as_tensor(rng.standard_normal((lnum, m, d)), dtype=torch.float32).to(BF16)
    a = torch.as_tensor(rng.standard_normal((n, lnum, d, r)) / d**0.5, dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((n, lnum, r, d)) * 0.1, dtype=torch.float32)
    return x, a, b


def _k5_model(x, a, b, row_src, tile_slot, tm):
    """K5's tensor-core passes in plain torch: z (M_pad, L RP) bf16, zero
    past R, then out[row] = bf16(sum_k z[p, k] bf16(B[slot, k])) over the k in
    order, written through row_src."""
    lnum, m, d = x.shape
    n, _, _, r = a.shape
    rp = K.bwd_scratch_rank(r, BF16)
    m_pad = row_src.numel()
    pos = torch.nonzero(row_src >= 0)[:, 0]
    rows = row_src[pos].long()
    slots = tile_slot[pos // tm].long()
    z = torch.zeros((m_pad, lnum, rp))
    z[pos, :, :r] = _bf(torch.einsum("lpd,pldr->plr", x[:, rows].float(), _bf(a[slots])))
    z = z.reshape(m_pad, lnum * rp)
    bk = torch.zeros((n, lnum, rp, d))
    bk[:, :, :r] = _bf(b)
    bk = bk.reshape(n, lnum * rp, d)
    out = torch.zeros((m, d), dtype=BF16)
    out[rows] = torch.einsum("pk,pkd->pd", z[pos], bk[slots]).to(BF16)
    return out


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("rank", [1, 4, 8, 9, 24, 64])
@pytest.mark.parametrize("tm", [1, 7, 16, 32])
def test_k5_tensor_core_layout_gives_the_plain_sum(groups, rank, tm):
    lnum, d, n, m = 3, 24, len(groups), sum(groups)
    rng = np.random.default_rng(rank * 100 + tm)
    x, a, b = _inputs(rng, lnum, m, d, n, rank)
    idx = torch.as_tensor(rng.permutation(np.repeat(np.arange(n), groups)), dtype=torch.int32)
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    got = _k5_model(x, a, b, row_src, tile_slot, tm)
    want = R.skip_lora_grouped_ref(x, a, b, idx)
    tol = 2.0**-7 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


def _k2_model(x, a, b, g):
    """K2's tensor-core route in plain torch: z and gz rounded to bf16 in
    (L, M, RP) scratch (zeros past R), fp32 partials of gA and gB per
    BWD_CHUNK rows, added in chunk order."""
    lnum, m, d = x.shape
    r = a.shape[-1]
    rp = K.bwd_scratch_rank(r, BF16)
    xf, gf = x.float(), g.float()
    z = torch.zeros((lnum, m, rp))
    gz = torch.zeros((lnum, m, rp))
    z[..., :r] = _bf(torch.einsum("lmd,ldr->lmr", xf, _bf(a)))
    gz[..., :r] = _bf(torch.einsum("md,lrd->lmr", gf, _bf(b)))
    ga = torch.zeros((lnum, d, rp))
    gb = torch.zeros((lnum, rp, d))
    for c in range(K.bwd_chunks(m)):
        rows = slice(c * K.BWD_CHUNK, (c + 1) * K.BWD_CHUNK)
        ga = ga + torch.einsum("lmd,lmr->ldr", xf[:, rows], gz[:, rows])
        gb = gb + torch.einsum("lmr,md->lrd", z[:, rows], gf[rows])
    return ga[..., :r], gb[:, :r]


@pytest.mark.parametrize("m", [1, 100, 255, 256, 257, 1000, 1024])
@pytest.mark.parametrize("rank", [4, 9])
def test_k2_chunked_sum_gives_the_plain_gradients(m, rank):
    lnum, d = 2, 40
    rng = np.random.default_rng(m + rank)
    x, a, b = _inputs(rng, lnum, m, d, 1, rank)
    a, b = a[0], b[0]
    g = torch.as_tensor(rng.standard_normal((m, d)), dtype=torch.float32).to(BF16)
    got = _k2_model(x, a, b, g)
    want = R.skip_lora_bwd_ref(x, a, b, g)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape
        tol = 2.0**-6 * wt.abs().max().item()
        assert (gt - wt).abs().max().item() <= tol
