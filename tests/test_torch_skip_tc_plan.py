"""What the tensor-core routes of K5, K6, K7, K8, K1, K3 and K2 take from
their wrappers, checked on the CPU.

K5's bf16 rows (``kernel.grouped_fwd_route``) take the tensor cores: z
per (grouped position, layer) into an (M_pad, L * RP) bf16 scratch whose k
axis is k = l * RP + r, RP the rank padded to whole 8-wide mma n-tiles
(``kernel.bwd_scratch_rank``), then a sum over k against the slot's B stack,
each row written back through ``row_src``; K6 (bf16 rows over an int8
pool), K7 (bf16 rows over a packed 4-bit pool) and K8 (int8 rows) run the
same passes with each pool element dequantised as bf16(float(q) scale) or
bf16(code[nibble] scale) and each row element built as bf16(q s) where it
becomes an mma fragment, and K1 and K3 are K5 and K8 with one slot (null
``row_src`` and ``tile_slot``: position p is row p, every position slot 0). At a few rows
(``kernel.grouped_fwd_geometry``) every block of both passes takes 16
positions of one row tile. K2's bf16 route rounds z and gz
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
from repro_torch.kernels.skip_lora import quant as Q  # noqa: E402
from repro_torch.kernels.skip_lora import ref as R  # noqa: E402
from repro_torch.core.lm_skiplora import quantize_int8  # noqa: E402

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
    few = int(K.grouped_fwd_geometry(m, row_src.numel()) == "few_rows")
    assert args[7:] == (lnum, m, d, r, tm, row_src.numel() // tm, int(dtype == BF16), 0, few)


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
    order, written through row_src. A null (None) row_src and tile_slot read
    as the kernels read them (K3): position p is row p, every tile slot 0."""
    lnum, m, d = x.shape
    n, _, _, r = a.shape
    rp = K.bwd_scratch_rank(r, BF16)
    if row_src is None:
        row_src, tile_slot = torch.arange(m), torch.zeros(-(-m // tm), dtype=torch.int32)
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


# ---------------------------------------------------------------------------
# K7 and K8 on the tensor cores, and the few-row geometry
# ---------------------------------------------------------------------------

DC, KC = 128, 32          # columns of a project chunk; rows of k a B stage (skip_sum_tc.cuh)
SMS = 132                 # the H100's streaming multiprocessors


@pytest.mark.parametrize("dtype,route", [(BF16, "tensor_cores"), (torch.int8, "tensor_cores"),
                                         (torch.float32, "cuda_cores")])
def test_grouped_route_follows_the_row_dtype(dtype, route):
    """bf16 rows (K5, K6, K7) and int8 rows (K3, K8, dequantised to bf16)
    take the tensor cores; fp32 rows (K5, K6, K7) stay on CUDA cores."""
    assert K.grouped_fwd_route(dtype) == route


def _decode_plan(n_rows, n_slots, tm=ops.TM):
    """One row in each of ``n_rows`` slots of an ``n_slots``-slot pool, as a
    decode step of grouped serving has them."""
    idx = torch.arange(n_rows, dtype=torch.int32)
    return ops._plan(idx, n_slots, n_rows, tm)


@pytest.mark.parametrize("m,n,tm,geometry", [
    (4, 4, 16, "few_rows"),        # the serve cell's decode step
    (5, 6, 16, "few_rows"),        # fleet serving's decode step, 5 rows in a 6-slot pool
    (2, 4, 16, "few_rows"),        # a scheduler step
    (160, 6, 16, "few_rows"),      # 32 rows in each of 5 slots
    (320, 6, 16, "many_rows"),     # 64 rows in each of 5 slots
    (640, 6, 16, "many_rows"),     # 128 rows in each of 5 slots
    (1024, 4, 16, "many_rows"),    # the fleet step
    (512, 4, 1, "many_rows"),
    (5, 6, 7, "few_rows"),
])
def test_geometry_takes_few_rows_where_a_quarter_of_positions_is_padding(m, n, tm, geometry):
    idx = torch.arange(m, dtype=torch.int32) % n
    row_src, _ = ops._plan(idx, n, m, tm)
    assert K.grouped_fwd_geometry(m, row_src.numel()) == geometry
    assert (geometry == "few_rows") == (4 * m <= 3 * row_src.numel())


def _blocks(geometry, n_tiles, tm, per):
    """The grouped positions of each block (skip_sum_tc.cuh, block_span):
    ``per`` consecutive positions a block at many rows; at a few rows 16
    positions of one row tile a block, ceil(tm / 16) blocks a tile."""
    m_pad = n_tiles * tm
    if geometry == "many_rows":
        return [range(p0, min(p0 + per, m_pad)) for p0 in range(0, m_pad, per)]
    bpt = -(-tm // 16)
    return [range(t * tm + 16 * h, t * tm + 16 * h + min(16, tm - 16 * h))
            for t in range(n_tiles) for h in range(bpt)]


@pytest.mark.parametrize("groups", GROUPS + [(1, 1, 1, 1, 1, 0)])
@pytest.mark.parametrize("tm", [1, 7, 16, 32])
@pytest.mark.parametrize("per", [16, 32, 64])
def test_each_geometry_covers_every_position_once(groups, tm, per):
    """Both geometries of both passes cover each grouped position exactly
    once; at a few rows each block holds one tile, so one slot and one
    round."""
    n, m = len(groups), sum(groups)
    idx = torch.as_tensor(np.repeat(np.arange(n), groups), dtype=torch.int32)
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    n_tiles = tile_slot.numel()
    for geometry in ("many_rows", "few_rows"):
        blocks = _blocks(geometry, n_tiles, tm, per)
        covered = sorted(p for b in blocks for p in b)
        assert covered == list(range(n_tiles * tm))
        if geometry == "few_rows":
            assert all(len(b) <= 16 and len({p // tm for p in b}) == 1 for b in blocks)
            assert all(len({int(tile_slot[p // tm]) for p in b}) == 1 for b in blocks)


def test_few_row_geometry_fills_the_card_at_the_decode_step():
    """At fleet serving's decode step (5 rows in a 6-slot pool, L 24, D 2048)
    the few-row expand grid has at least 128 blocks with live rows (the
    many-row one had 32 blocks, 16 of them live), and project 120 of 144."""
    row_src, tile_slot = _decode_plan(5, 6)
    tm, n_tiles = ops.TM, tile_slot.numel()
    live = [b for b in _blocks("few_rows", n_tiles, tm, 16) if any(int(row_src[p]) >= 0 for p in b)]
    assert len(live) * -(-2048 // 64) >= 128 and len(live) * 24 == 120
    many = _blocks("many_rows", n_tiles, tm, 64)
    assert len(many) * -(-2048 // 128) == 32


@pytest.fixture
def scratch(monkeypatch):
    """K._grouped_scratch wrapped to keep each scratch it makes."""
    made = []
    real = K._grouped_scratch

    def keep(*args):
        z = real(*args)
        made.append(z)
        return z

    monkeypatch.setattr(K, "_grouped_scratch", keep)
    return made


def _q4_pool(rng, n, lnum, d, r, kind):
    a = torch.as_tensor(rng.standard_normal((n, lnum, d, r)) / d**0.5, dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((n, lnum, r, d)) * 0.1, dtype=torch.float32)
    a[0], b[0] = 0.0, 0.0                     # the pool's zero slot: scale 0
    return (*Q.quantize_q4(a, kind), *Q.quantize_q4(b, kind), Q.codebook(kind))


@pytest.mark.parametrize("m", [5, 640])
@pytest.mark.parametrize("rank", [4, 8, 24, 64])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_q4_launch_arguments_and_scratch(recorded, scratch, m, rank, dtype):
    """K7 records one launch whose z is (M_pad, L RP) bf16 on the tensor
    cores and (L, M_pad, R) fp32 on CUDA cores, and the geometry flag."""
    lnum, d, n, tm = 2, 64, 6, ops.TM
    rng = np.random.default_rng(m + rank)
    x = torch.zeros((lnum, m, d), dtype=dtype)
    pool = _q4_pool(rng, n, lnum, d, rank, "int4")
    idx = torch.arange(m, dtype=torch.int32) % (n - 1)
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    m_pad = row_src.numel()
    K.grouped_skip_sum_fwd_q4(x, *pool, row_src, tile_slot, tm)
    assert K.LAUNCHES["grouped_skip_sum_fwd_q4"] == 1 and sum(K.LAUNCHES.values()) == 1
    (name, args), = recorded
    (z,) = scratch
    if dtype == BF16:
        assert z.shape == (m_pad, lnum * K.bwd_scratch_rank(rank, BF16)) and z.dtype == BF16
    else:
        assert z.shape == (lnum, m_pad, rank) and z.dtype == torch.float32
    assert args[8] == z.data_ptr()
    few = int(K.grouped_fwd_geometry(m, m_pad) == "few_rows")
    assert few == (m == 5)
    assert args[10:] == (lnum, m, d, rank, tm, m_pad // tm, int(dtype == BF16), few)


@pytest.mark.parametrize("m", [5, 1024])
@pytest.mark.parametrize("rank", [4, 8, 24, 64])
@pytest.mark.parametrize("pool_dtype", [BF16, torch.float32])
def test_actint8_launch_arguments_and_scratch(recorded, scratch, m, rank, pool_dtype):
    """K8 records one launch whose z is (M_pad, L RP) bf16 (always the
    tensor cores), and the geometry flag."""
    lnum, d, n, tm = 2, 64, 4, ops.TM
    q = torch.zeros((lnum, m, d), dtype=torch.int8)
    s = torch.ones((lnum, m))
    a, b = _pool(n, lnum, d, rank, pool_dtype)
    idx = torch.arange(m, dtype=torch.int32) % n
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    m_pad = row_src.numel()
    out = K.grouped_skip_sum_fwd_actint8(q, s, a, b, row_src, tile_slot, tm)
    assert out.dtype == BF16 and out.shape == (m, d)
    assert K.LAUNCHES["grouped_skip_sum_fwd_actint8"] == 1 and sum(K.LAUNCHES.values()) == 1
    (name, args), = recorded
    (z,) = scratch
    assert z.shape == (m_pad, lnum * K.bwd_scratch_rank(rank, BF16)) and z.dtype == BF16
    assert args[6] == z.data_ptr()
    few = int(K.grouped_fwd_geometry(m, m_pad) == "few_rows")
    assert args[8:] == (lnum, m, d, rank, tm, m_pad // tm, int(pool_dtype == BF16), few)


@pytest.mark.parametrize("m", [4, 5, 640])
@pytest.mark.parametrize("rank", [4, 8, 24, 64])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_int8_pool_launch_arguments_and_scratch(recorded, scratch, m, rank, dtype):
    """K6 records one launch whose z is (M_pad, L RP) bf16 on the tensor
    cores and (L, M_pad, R) fp32 on CUDA cores, and the geometry flag: a few
    rows at serving's one row a slot, many at 5 slots of 128."""
    lnum, d, n, tm = 2, 64, 6, ops.TM
    x = torch.zeros((lnum, m, d), dtype=dtype)
    a, b = _pool(n, lnum, d, rank)
    qa, sa = quantize_int8(a)
    qb, sb = quantize_int8(b)
    idx = torch.arange(m, dtype=torch.int32) % (n - 1)
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    m_pad = row_src.numel()
    out = K.grouped_skip_sum_fwd_int8(x, qa, sa, qb, sb, row_src, tile_slot, tm)
    assert out.dtype == dtype and out.shape == (m, d)
    assert K.LAUNCHES["grouped_skip_sum_fwd_int8"] == 1 and sum(K.LAUNCHES.values()) == 1
    (name, args), = recorded
    (z,) = scratch
    if dtype == BF16:
        assert z.shape == (m_pad, lnum * K.bwd_scratch_rank(rank, BF16)) and z.dtype == BF16
    else:
        assert z.shape == (lnum, m_pad, rank) and z.dtype == torch.float32
    assert args[7] == z.data_ptr()
    few = int(K.grouped_fwd_geometry(m, m_pad) == "few_rows")
    assert few == (m != 640)
    assert args[9:] == (lnum, m, d, rank, tm, m_pad // tm, int(dtype == BF16), few)
    assert K.ROW_LAUNCHES == {("grouped_skip_sum_fwd_int8", "few_rows" if few else "many_rows"): 1}


@pytest.mark.parametrize("m", [1, 100, 1024])
@pytest.mark.parametrize("rank", [4, 8, 16, 24, 32, 64])
@pytest.mark.parametrize("w_dtype", [BF16, torch.float32])
def test_int8_cache_forward_launch_arguments_and_scratch(recorded, scratch, m, rank, w_dtype):
    """K3 records one launch whose z is the (M, L RP) bf16 scratch of the
    tensor-core route, M positions of one row a tile, and the geometry flag
    of ``grouped_fwd_geometry(M, M)``: many rows, whatever M."""
    lnum, d = 3, 64
    q = torch.zeros((lnum, m, d), dtype=torch.int8)
    s = torch.ones((lnum, m))
    a, b = torch.zeros((lnum, d, rank), dtype=w_dtype), torch.zeros((lnum, rank, d), dtype=w_dtype)
    out = K.skip_lora_fwd_int8(q, s, a, b)
    assert out.dtype == BF16 and out.shape == (m, d)
    assert K.LAUNCHES["skip_lora_fwd_int8"] == 1 and sum(K.LAUNCHES.values()) == 1
    assert K.ROW_LAUNCHES == {}                      # not a grouped forward
    (name, args), = recorded
    (z,) = scratch
    assert z.shape == (m, lnum * K.bwd_scratch_rank(rank, BF16)) and z.dtype == BF16
    assert args[4] == z.data_ptr()
    assert K.grouped_fwd_geometry(m, m) == "many_rows"
    assert args[6:] == (lnum, m, d, rank, int(w_dtype == BF16), 0)


@pytest.mark.parametrize("groups", [(1, 1, 1, 1, 1, 0), (5, 5, 5, 5, 5, 0), (6, 6, 6, 6, 6, 0),
                                    (128, 128, 128, 128, 128, 0), (256, 256, 256, 256)])
@pytest.mark.parametrize("name", ["grouped_skip_sum_fwd", "grouped_skip_sum_fwd_int8",
                                  "grouped_skip_sum_fwd_q4", "grouped_skip_sum_fwd_actint8"])
def test_grouped_forwards_count_each_launch_by_row_class(recorded, name, groups):
    """Each grouped forward's wrapper counts its launch once in
    ``ROW_LAUNCHES`` under the row class ``grouped_fwd_geometry`` gives, the
    one whose flag it passes (K5-K8); ``reset_launches`` clears it."""
    lnum, d, r, n, tm = 2, 64, 8, len(groups), ops.TM
    m = sum(groups)
    idx = torch.cat([torch.full((c,), s, dtype=torch.int32) for s, c in enumerate(groups)])
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    geometry = K.grouped_fwd_geometry(m, row_src.numel())
    if max(groups) in (1, 128, 256):              # a decode step; a prefill or a fleet step
        assert geometry == ("few_rows" if max(groups) == 1 else "many_rows")
    x = torch.zeros((lnum, m, d), dtype=BF16)
    a, b = _pool(n, lnum, d, r)
    if name == "grouped_skip_sum_fwd":
        K.grouped_skip_sum_fwd(x, a, b, row_src, tile_slot, tm)
    elif name == "grouped_skip_sum_fwd_int8":
        qa, sa = quantize_int8(a)
        qb, sb = quantize_int8(b)
        K.grouped_skip_sum_fwd_int8(x, qa, sa, qb, sb, row_src, tile_slot, tm)
    elif name == "grouped_skip_sum_fwd_q4":
        pool = _q4_pool(np.random.default_rng(0), n, lnum, d, r, "int4")
        K.grouped_skip_sum_fwd_q4(x, *pool, row_src, tile_slot, tm)
    else:
        K.grouped_skip_sum_fwd_actint8(torch.zeros((lnum, m, d), dtype=torch.int8), torch.ones((lnum, m)),
                                       a, b, row_src, tile_slot, tm)
    assert K.ROW_LAUNCHES == {(name, geometry): 1}
    (_, args), = recorded
    assert args[-1] == int(geometry == "few_rows")
    K.reset_launches()
    assert K.ROW_LAUNCHES == {} and sum(K.LAUNCHES.values()) == 0


# Plain models of what the kernels stage and build, in their layouts.

def _int8_tile(q_rows):
    """A chunk of int8 rows as Int8Rows stages it: [rows][DC + 16] bytes."""
    tile = torch.zeros((q_rows.shape[0], DC + 16), dtype=torch.int8)
    tile[:, : q_rows.shape[1]] = q_rows
    return tile


def _int8_frag(tile, rsc, mt, warp, lane):
    """Int8Rows::frag: the four bf16 pairs of this lane's A fragment."""
    r0, col = mt * 16 + lane // 4, 16 * warp + 2 * (lane % 4)

    def two(r, c):
        return (tile[r, c : c + 2].float() * rsc[r]).to(BF16)

    return two(r0, col), two(r0 + 8, col), two(r0, col + 8), two(r0 + 8, col + 8)


def _a_matrix(frags):
    """The 16 x 16 A tile the lanes' fragments hold (mma.cuh's layout)."""
    a = torch.zeros((16, 16), dtype=BF16)
    for lane, (a0, a1, a2, a3) in enumerate(frags):
        g, t = lane // 4, lane % 4
        a[g, 2 * t : 2 * t + 2], a[g + 8, 2 * t : 2 * t + 2] = a0, a1
        a[g, 2 * t + 8 : 2 * t + 10], a[g + 8, 2 * t + 8 : 2 * t + 10] = a2, a3
    return a


@pytest.mark.parametrize("mt_rows", [16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_int8_fragments_hold_the_dequantised_rows(mt_rows, seed):
    """Each warp's A fragments over an Int8Rows tile are bf16(q s) of its
    16 columns and the tile's rows: the reference's dequantisation."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((mt_rows, DC)) * 3, dtype=torch.float32)
    q, s = quantize_int8(x)
    tile = _int8_tile(q)
    want = (q.float() * s[:, None]).to(BF16)
    for mt in range(mt_rows // 16):
        for warp in range(DC // 16):
            got = _a_matrix([_int8_frag(tile, s, mt, warp, lane) for lane in range(32)])
            assert torch.equal(got, want[16 * mt : 16 * mt + 16, 16 * warp : 16 * warp + 16])


def _q4_slab(qa, sa, gl, c0, rp):
    """Q4Pool::issue_a: rows c0.. of A (D, R/2) bytes, then DC fp32 scales at
    byte DC RP / 2; zeros past D."""
    d, hb = qa.shape[1], qa.shape[2]
    live = min(DC, d - c0)
    slab = torch.zeros(DC * rp // 2 + DC * 4, dtype=torch.uint8)
    slab[: live * hb] = qa[gl, c0 : c0 + live].reshape(-1)
    scales = torch.zeros(DC, dtype=torch.float32)
    scales[:live] = sa[gl, c0 : c0 + live]
    slab[DC * rp // 2 :] = scales.view(torch.uint8)
    return slab


def _lookup(code, byte, odd):
    return code[int(byte) >> 4 if odd else int(byte) & 15]


def _q4_a_at(slab, code, dd, r, rank, rp):
    scale = slab[DC * rp // 2 :].view(torch.float32)[dd]
    return _lookup(code, slab[dd * (rank // 2) + r // 2], r & 1) * scale


def _q4_b_stage(qb, sb, slot, k0, dc0, lnum, rank, rp, cw):
    """Q4Pool::issue_b: KC rows k = k0.. (l = k // RP, r = k % RP) of CW / 2
    bytes, each padded by 16, then their KC scales; zeros for r >= R."""
    d = 2 * qb.shape[-1]
    br = cw // 2 + 16
    st = torch.zeros(KC * br + KC * 4, dtype=torch.uint8)
    scales = torch.zeros(KC, dtype=torch.float32)
    for row in range(KC):
        k = k0 + row
        l, r = divmod(k, rp)
        if k >= lnum * rp or r >= rank:
            continue
        cols = qb[slot, l, r, dc0 // 2 : min(dc0 + cw, d) // 2]
        st[row * br : row * br + cols.numel()] = cols
        scales[row] = sb[slot, l, r]
    st[KC * br :] = scales.view(torch.uint8)
    return st


def _q4_b_at(st, code, row, col, cw):
    br = cw // 2 + 16
    return _lookup(code, st[row * br + col // 2], col & 1) * st[KC * br :].view(torch.float32)[row]


@pytest.mark.parametrize("kind", Q.Q4_KINDS)
@pytest.mark.parametrize("rank", [4, 8, 24, 64])
def test_q4_slab_and_b_stage_hold_the_dequantised_pool(kind, rank):
    """Every element a Q4Pool stage yields (A slab at a_at, B rows at b_at,
    both geometries' column widths) is the reference's code[nibble] scale,
    zeros past D and past R; the zero slot gives exact zeros."""
    lnum, d, n = 2, 160, 3
    rng = np.random.default_rng(rank)
    qa, sa, qb, sb, code = _q4_pool(rng, n, lnum, d, rank, kind)
    a = Q.dequantize_q4(qa, sa, code).reshape(n * lnum, d, rank)
    b = Q.dequantize_q4(qb, sb, code)
    rp = K.bwd_scratch_rank(rank, BF16)
    qa2, sa2 = qa.reshape(n * lnum, d, rank // 2), sa.reshape(n * lnum, d)
    for gl in (0, 3):
        for c0 in range(0, d, DC):
            slab = _q4_slab(qa2, sa2, gl, c0, rp)
            for dd in range(min(DC, d - c0)):
                got = torch.stack([_q4_a_at(slab, code, dd, r, rank, rp) for r in range(rank)])
                assert torch.equal(got, a[gl, c0 + dd])
    for cw in (64, 128):
        for slot in (0, 2):
            for k0 in range(0, lnum * rp, KC):
                for dc0 in range(0, d, cw):
                    st = _q4_b_stage(qb, sb, slot, k0, dc0, lnum, rank, rp, cw)
                    for row in range(KC):
                        l, r = divmod(k0 + row, rp)
                        got = torch.stack([_q4_b_at(st, code, row, c, cw) for c in range(min(cw, d - dc0))])
                        want = b[slot, l, r, dc0 : dc0 + cw] if l < lnum and r < rank else torch.zeros_like(got)
                        assert torch.equal(got, want)
                        if slot == 0:
                            assert not got.any()


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("rank", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("kind", Q.Q4_KINDS)
def test_q4_tensor_core_model_gives_the_plain_sum(groups, rank, kind):
    """K7 with bf16 rows: the K5 model (each pool element cast to bf16 before
    use, the k = l RP + r layout) over the dequantised pool gives the plain
    version within the bf16 bar, and the zero slot exact zeros."""
    lnum, d, n, m, tm = 3, 32, len(groups), sum(groups), ops.TM
    rng = np.random.default_rng(rank + 7 * len(groups))
    x = torch.as_tensor(rng.standard_normal((lnum, m, d)), dtype=torch.float32).to(BF16)
    pool = _q4_pool(rng, n, lnum, d, rank, kind)
    qa, sa, qb, sb, code = pool
    idx = torch.as_tensor(rng.permutation(np.repeat(np.arange(n), groups)), dtype=torch.int32)
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    got = _k5_model(x, Q.dequantize_q4(qa, sa, code), Q.dequantize_q4(qb, sb, code), row_src, tile_slot, tm)
    want = R.skip_lora_grouped_q4_ref(x, *pool, idx)
    tol = 2.0**-7 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    zero = idx == 0
    assert not got[zero].any()


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("rank", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("pool_dtype", [BF16, torch.float32])
def test_actint8_tensor_core_model_gives_the_plain_sum(groups, rank, pool_dtype):
    """K8: rows bf16(q s) before the product, then the same passes, give the
    plain version within the bf16 bar."""
    lnum, d, n, m, tm = 3, 32, len(groups), sum(groups), ops.TM
    rng = np.random.default_rng(rank + 11 * len(groups))
    x, a, b = _inputs(rng, lnum, m, d, n, rank)
    q, s = quantize_int8(x.float() * 4)
    a, b = a.to(pool_dtype), b.to(pool_dtype)
    idx = torch.as_tensor(rng.permutation(np.repeat(np.arange(n), groups)), dtype=torch.int32)
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    rows = (q.float() * s[..., None]).to(BF16)
    got = _k5_model(rows, a.float(), b.float(), row_src, tile_slot, tm)
    want = R.skip_lora_grouped_actint8_ref(q, s, a, b, idx)
    tol = 2.0**-7 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


# K6: the int8 pool policy (Int8Pool in skip_sum_tc.cuh) and its sums; K3 as
# K8 with one slot.

def _int8_pool(rng, n, lnum, d, r):
    a = torch.as_tensor(rng.standard_normal((n, lnum, d, r)) / d**0.5, dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((n, lnum, r, d)) * 0.1, dtype=torch.float32)
    a[0], b[0] = 0.0, 0.0                     # the pool's zero slot
    return (*quantize_int8(a), *quantize_int8(b))


def _int8_slab(qa, sa, gl, c0, rp):
    """Int8Pool::issue_a: rows c0.. of A (D, R) as R bytes each, then DC
    fp32 scales at byte DC RP; zeros past D."""
    d, r = qa.shape[1], qa.shape[2]
    live = min(DC, d - c0)
    slab = torch.zeros(DC * rp + DC * 4, dtype=torch.uint8)
    slab[: live * r] = qa[gl, c0 : c0 + live].reshape(-1).view(torch.uint8)
    scales = torch.zeros(DC, dtype=torch.float32)
    scales[:live] = sa[gl, c0 : c0 + live]
    slab[DC * rp :] = scales.view(torch.uint8)
    return slab


def _int8_a_at(slab, dd, r, rank, rp):
    return slab[dd * rank + r].view(torch.int8).float() * slab[DC * rp :].view(torch.float32)[dd]


def _int8_b_stage(qb, sb, slot, k0, dc0, lnum, rank, rp, cw):
    """Int8Pool::issue_b: KC rows k = k0.. (l = k // RP, r = k % RP) of CW
    bytes, each padded by 16, then their KC scales; zeros for r >= R."""
    d = qb.shape[-1]
    br = cw + 16
    st = torch.zeros(KC * br + KC * 4, dtype=torch.uint8)
    scales = torch.zeros(KC, dtype=torch.float32)
    for row in range(KC):
        k = k0 + row
        l, r = divmod(k, rp)
        if k >= lnum * rp or r >= rank:
            continue
        cols = qb[slot, l, r, dc0 : min(dc0 + cw, d)]
        st[row * br : row * br + cols.numel()] = cols.view(torch.uint8)
        scales[row] = sb[slot, l, r]
    st[KC * br :] = scales.view(torch.uint8)
    return st


def _int8_b_at(st, row, col, cw):
    br = cw + 16
    return st[row * br + col].view(torch.int8).float() * st[KC * br :].view(torch.float32)[row]


@pytest.mark.parametrize("rank", [4, 8, 9, 24, 64])
def test_int8_slab_and_b_stage_hold_the_dequantised_pool(rank):
    """Every element an Int8Pool stage yields (A slab at a_at, B rows at
    b_at, both geometries' column widths) is the reference's float(q) scale,
    zeros past D and past R; the zero slot gives exact zeros."""
    lnum, d, n = 2, 160, 3
    rng = np.random.default_rng(rank)
    qa, sa, qb, sb = _int8_pool(rng, n, lnum, d, rank)
    a = (qa.float() * sa[..., None]).reshape(n * lnum, d, rank)
    b = qb.float() * sb[..., None]
    rp = K.bwd_scratch_rank(rank, BF16)
    qa2, sa2 = qa.reshape(n * lnum, d, rank), sa.reshape(n * lnum, d)
    for gl in (0, 3):
        for c0 in range(0, d, DC):
            slab = _int8_slab(qa2, sa2, gl, c0, rp)
            for dd in range(min(DC, d - c0)):
                got = torch.stack([_int8_a_at(slab, dd, r, rank, rp) for r in range(rank)])
                assert torch.equal(got, a[gl, c0 + dd])
                if gl == 0:
                    assert not got.any()
    for cw in (64, 128):
        for slot in (0, 2):
            for k0 in range(0, lnum * rp, KC):
                for dc0 in range(0, d, cw):
                    st = _int8_b_stage(qb, sb, slot, k0, dc0, lnum, rank, rp, cw)
                    for row in range(KC):
                        l, r = divmod(k0 + row, rp)
                        got = torch.stack([_int8_b_at(st, row, c, cw) for c in range(min(cw, d - dc0))])
                        want = b[slot, l, r, dc0 : dc0 + cw] if l < lnum and r < rank else torch.zeros_like(got)
                        assert torch.equal(got, want)
                        if slot == 0:
                            assert not got.any()


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("rank", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("tm", [1, 16])
def test_int8_pool_tensor_core_model_gives_the_plain_sum(groups, rank, tm):
    """K6 with bf16 rows: the K5 model (each pool element float(q) scale
    cast to bf16 before use, the k = l RP + r layout) over the dequantised
    pool gives the plain version within the bf16 bar, and the zero slot
    exact zeros."""
    lnum, d, n, m = 3, 32, len(groups), sum(groups)
    rng = np.random.default_rng(rank + 13 * len(groups) + tm)
    x = torch.as_tensor(rng.standard_normal((lnum, m, d)), dtype=torch.float32).to(BF16)
    qa, sa, qb, sb = _int8_pool(rng, n, lnum, d, rank)
    idx = torch.as_tensor(rng.permutation(np.repeat(np.arange(n), groups)), dtype=torch.int32)
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    got = _k5_model(x, qa.float() * sa[..., None], qb.float() * sb[..., None], row_src, tile_slot, tm)
    want = R.skip_lora_grouped_int8_ref(x, qa, sa, qb, sb, idx)
    tol = 2.0**-7 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert not got[idx == 0].any()


@pytest.mark.parametrize("m", [1, 33, 100, 256])
@pytest.mark.parametrize("rank", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("w_dtype", [BF16, torch.float32])
def test_int8_cache_tensor_core_model_gives_the_plain_sum(m, rank, w_dtype):
    """K3: rows bf16(q s), the adapters a pool of one slot, null row_src and
    tile_slot with one row a tile: the K5 model's sum over k = l RP + r gives
    the plain version (each layer's product added into an fp32 output)
    within the bf16 bar."""
    lnum, d = 3, 48
    rng = np.random.default_rng(m + rank)
    x, a, b = _inputs(rng, lnum, m, d, 1, rank)
    q, s = quantize_int8(x.float() * 4)
    a, b = a[0].to(w_dtype), b[0].to(w_dtype)
    rows = (q.float() * s[..., None]).to(BF16)
    got = _k5_model(rows, a[None].float(), b[None].float(), None, None, 1)
    want = R.skip_lora_int8_fwd_ref(q, s, a, b)
    tol = 2.0**-7 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


# K1: K5's passes with one slot over bf16 rows; fp32 rows on CUDA cores.

@pytest.mark.parametrize("m", [1, 100, 1000, 1024])
@pytest.mark.parametrize("rank", [4, 8, 16, 24, 32, 64])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("w_dtype", [BF16, torch.float32])
def test_dense_forward_launch_arguments_and_scratch(recorded, scratch, m, rank, dtype, w_dtype):
    """K1 records one launch whose z is the (M, L RP) bf16 scratch of the
    tensor-core route for bf16 rows (M positions of one row a tile) and the
    (L, M, R) fp32 scratch of the CUDA-core passes for fp32 rows, and the
    geometry flag of ``grouped_fwd_geometry(M, M)``: many rows, whatever M."""
    lnum, d = 3, 64
    x = torch.zeros((lnum, m, d), dtype=dtype)
    a, b = torch.zeros((lnum, d, rank), dtype=w_dtype), torch.zeros((lnum, rank, d), dtype=w_dtype)
    out = K.skip_lora_fwd(x, a, b)
    assert out.dtype == dtype and out.shape == (m, d)
    assert K.LAUNCHES["skip_lora_fwd"] == 1 and sum(K.LAUNCHES.values()) == 1
    assert K.ROW_LAUNCHES == {}                      # not a grouped forward
    (name, args), = recorded
    (z,) = scratch
    if dtype == BF16:
        assert z.shape == (m, lnum * K.bwd_scratch_rank(rank, BF16)) and z.dtype == BF16
    else:
        assert z.shape == (lnum, m, rank) and z.dtype == torch.float32
    assert args[3] == z.data_ptr() and args[4] == out.data_ptr()
    assert K.grouped_fwd_geometry(m, m) == "many_rows"
    assert args[5:] == (lnum, m, d, rank, int(dtype == BF16), int(w_dtype == BF16), 0)


@pytest.mark.parametrize("m", [1, 33, 100, 257])
@pytest.mark.parametrize("rank", [4, 8, 16, 24, 32, 64])
@pytest.mark.parametrize("w_dtype", [BF16, torch.float32])
def test_dense_forward_tensor_core_model_gives_the_plain_sum(m, rank, w_dtype):
    """K1: bf16 rows, the adapters a pool of one slot, null row_src and
    tile_slot with one row a tile: the K5 model's sum over k = l RP + r gives
    the plain version (one fp32 sum over every layer's product) within the
    bf16 bar, at ranks 4-64 and M off every tile size."""
    lnum, d = 3, 48
    rng = np.random.default_rng(m + rank)
    x, a, b = _inputs(rng, lnum, m, d, 1, rank)
    a, b = a[0].to(w_dtype), b[0].to(w_dtype)
    got = _k5_model(x, a[None].float(), b[None].float(), None, None, 1)
    want = R.skip_lora_fwd_ref(x, a, b)
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape == (m, d)
    tol = 2.0**-7 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
