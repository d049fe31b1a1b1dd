"""The port's paged KV path against the reference on the CPU: K10's plain
version, the per-row attention variants, the scheduler's admission
prefills, ``KVBlockPool`` and ``RadixPrefixIndex``.

Inputs are made with numpy from seeds and handed to both packages; the
model is reduced stablelm-1.6b in float32, params from the reference's
``init_lm`` carried across by ``repro_torch.convert``.

Bars: the gather is data movement, so bitwise (against the reference's
``paged_gather_ref`` and its interpret-mode Pallas kernel); the attention
variants within 1e-5 relative in float32 (different GEMM summation
orders; the reference's own bitwise "mixed depths vs each row solo" bar
fails on this tree, so it is not carried over); the paged decode bitwise
against the port's own dense per-row branch; admission-prefill logits
within 1e-4; pool accounting and radix answers exactly the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import kv_pool as JKV  # noqa: E402
from repro.core.prefix_index import RadixPrefixIndex as JRadix  # noqa: E402
from repro.kernels.flash_attn import paged as JPG  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import kv_pool as KV  # noqa: E402
from repro_torch.core.prefix_index import RadixPrefixIndex  # noqa: E402
from repro_torch.kernels.flash_attn import paged as PG  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

CFG = reduce_config(get_config("stablelm-1.6b"))
RANK = 4
T = 8


def _np(x):
    return np.asarray(x, np.float32)


def _rel_close(got, want, rtol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), f"max diff {err:.3e} vs scale {np.abs(want).max():.3e}"


# ---------------------------------------------------------------------------
# K10's plain version
# ---------------------------------------------------------------------------


def _pool_and_tables(dtype, lead, seed=3):
    rng = np.random.default_rng(seed)
    pool = rng.normal(size=lead + (6, 4, 2, 8)).astype(np.float32)
    # repeated ids, and a padded row (block 0 as the pad id)
    tables = np.array([[3, 0, 5], [1, 1, 2], [4, 0, 0]], np.int32)
    if dtype == "bfloat16":
        pool = np.asarray(jnp.asarray(pool, jnp.bfloat16))
    return pool, tables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["no-layer-axis", "layer-axis"])
def test_gather_plain_is_bitwise_the_reference(dtype, lead):
    pool, tables = _pool_and_tables(dtype, lead)
    got = PG.paged_gather_ref(C.to_tensor(pool), torch.as_tensor(tables))
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert tuple(got.shape) == lead + (3, 12, 2, 8)
    layers = [pool] if not lead else list(pool)
    want_ref = [np.asarray(JPG.paged_gather_ref(jnp.asarray(p), jnp.asarray(tables))) for p in layers]
    want_ker = [np.asarray(JPG.paged_gather(jnp.asarray(p), jnp.asarray(tables), interpret=True))
                for p in layers]
    got_l = [C.to_numpy(got)] if not lead else [C.to_numpy(g) for g in got]
    for g, wr, wk in zip(got_l, want_ref, want_ker):
        np.testing.assert_array_equal(g, _np(wr))
        np.testing.assert_array_equal(g, _np(wk))


def test_gather_dispatch_on_the_cpu_takes_the_plain_version():
    pool, tables = _pool_and_tables("float32", (2,))
    p, t = torch.as_tensor(pool), torch.as_tensor(tables)
    want = PG.paged_gather_ref(p, t)
    assert torch.equal(PG.gather(p, t), want)
    with pytest.raises(ValueError, match="cpu or cuda"):
        PG.gather(p.to("meta"), t.to("meta"))      # neither route: raises, no fallback
    with pytest.raises(ValueError, match="CUDA device"):
        PG.paged_gather(p, t)                        # the kernel itself needs a card
    with pytest.raises(ValueError, match="int32"):
        PG.paged_gather(p, t.long())


# ---------------------------------------------------------------------------
# Attention: per-row decode, offset prefill, paged decode
# ---------------------------------------------------------------------------


def _mini_cfg(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=32, vocab_size=64, dtype="float32")
    base.update(kw)
    return base


@pytest.fixture(scope="module", params=[0, 3], ids=["global", "window3"])
def attn(request):
    """Reference and port attention with the same weights, a batch of 3
    rows, an (3, T) random cache."""
    kw = _mini_cfg(sliding_window=request.param)
    jcfg = JModelConfig(**kw)
    tcfg = ModelConfig(**kw)
    local = request.param > 0
    jspec, tspec = JA.AttnSpec.from_config(jcfg, local=local), TA.AttnSpec.from_config(tcfg, local=local)
    jp = JA.init_attn(jax.random.key(0), jcfg)
    tp = {k: C.to_tensor(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(1)
    hd = jcfg.resolved_head_dim
    x = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
    cache = {n: rng.normal(size=(3, T, jcfg.n_kv_heads, hd)).astype(np.float32) for n in ("k", "v")}
    return jp, tp, jspec, tspec, x, cache


def _tcache(cache):
    return {n: torch.as_tensor(c.copy()) for n, c in cache.items()}


@pytest.mark.parametrize("pos", [[0, T // 2, T - 1], [5, 5, 5], [T - 1, 2, 0]])
def test_vector_decode_matches_the_reference(attn, pos):
    jp, tp, jspec, tspec, x, cache = attn
    y_j, c_j = JA.attn_decode(jp, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jspec,
                              {n: jnp.asarray(c) for n, c in cache.items()})
    y_t, c_t = TA.attn_decode(tp, torch.as_tensor(x), torch.as_tensor(pos), tspec, _tcache(cache))
    _rel_close(y_t, y_j)
    for n in ("k", "v"):
        _rel_close(c_t[n], c_j[n])


@pytest.mark.parametrize("p", [0, T // 2, T - 1])
def test_constant_vector_decode_is_the_scalar_branch_bitwise(attn, p):
    _, tp, _, tspec, x, cache = attn
    y_s, c_s = TA.attn_decode(tp, torch.as_tensor(x), p, tspec, _tcache(cache))
    y_v, c_v = TA.attn_decode(tp, torch.as_tensor(x), torch.full((3,), p), tspec, _tcache(cache))
    assert torch.equal(y_v, y_s)
    for n in ("k", "v"):
        assert torch.equal(c_v[n], c_s[n])


def test_vector_decode_at_position_zero_ignores_cache_garbage(attn):
    _, tp, _, tspec, x, cache = attn
    pos = torch.zeros(3, dtype=torch.long)
    y_clean, _ = TA.attn_decode(tp, torch.as_tensor(x), pos, tspec, _tcache(cache))
    junk = _tcache(cache)
    for c in junk.values():
        c[:, 1:] = 1e3
    y_junk, c_junk = TA.attn_decode(tp, torch.as_tensor(x), pos, tspec, junk)
    assert torch.equal(y_junk, y_clean)
    assert bool((c_junk["k"][:, 1:] == 1e3).all())


@pytest.mark.parametrize("offs", [[0, 2, 5], [4, 4, 4], [6, 0, 3]])
def test_offset_prefill_matches_the_reference(attn, offs):
    """Tails of 3 tokens at per-row offsets, one row writing past the
    cache (offset 6 + 3 > T): those writes are dropped on both sides."""
    jp, tp, jspec, tspec, _, cache = attn
    x = np.random.default_rng(2).normal(size=(3, 3, 32)).astype(np.float32)
    y_j, c_j = JA.attn_prefill_ext(jp, jnp.asarray(x), jnp.asarray(offs, jnp.int32), jspec,
                                   {n: jnp.asarray(c) for n, c in cache.items()})
    y_t, c_t = TA.attn_prefill_ext(tp, torch.as_tensor(x), torch.as_tensor(offs, dtype=torch.int32),
                                   tspec, _tcache(cache))
    _rel_close(y_t, y_j)
    for n in ("k", "v"):
        _rel_close(c_t[n], c_j[n])


def _paged(cache, blk=4):
    """The dense rows scattered into pool blocks: row r's span [j * blk,
    (j + 1) * blk) in block r * (T / blk) + j, table row-major."""
    per_row = T // blk
    pool = {n: c.reshape(3 * per_row, blk, *c.shape[2:]).copy() for n, c in cache.items()}
    table = np.arange(3 * per_row, dtype=np.int32).reshape(3, per_row)
    return pool, table


def test_paged_decode_matches_the_reference_and_the_dense_branch_bitwise(attn):
    jp, tp, jspec, tspec, x, cache = attn
    pos = [0, T // 2, T - 1]
    pool, table = _paged(cache)
    y_j, pool_j = JA.attn_decode_paged(jp, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jspec,
                                       {n: jnp.asarray(c) for n, c in pool.items()},
                                       jnp.asarray(table))
    tpool = {n: torch.as_tensor(c) for n, c in pool.items()}
    y_p, pool_t = TA.attn_decode_paged(tp, torch.as_tensor(x), torch.as_tensor(pos), tspec, tpool,
                                       torch.as_tensor(table))
    _rel_close(y_p, y_j)
    for n in ("k", "v"):
        _rel_close(pool_t[n], pool_j[n])
    y_d, c_d = TA.attn_decode(tp, torch.as_tensor(x), torch.as_tensor(pos), tspec, _tcache(cache))
    assert torch.equal(y_p, y_d)
    for n in ("k", "v"):
        assert torch.equal(pool_t[n].reshape(c_d[n].shape), c_d[n])


# ---------------------------------------------------------------------------
# Admission prefills
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jp = JL.init_lm(jax.random.key(0), CFG)
    tp = C.params_from_reference(jax.tree.map(np.asarray, jp), CFG)
    rng = np.random.default_rng(4)
    pools = {
        "A": np.concatenate([np.zeros((1, CFG.n_layers, CFG.d_model, RANK), np.float32),
                             rng.normal(size=(2, CFG.n_layers, CFG.d_model, RANK)).astype(np.float32)
                             / np.sqrt(CFG.d_model)]),
        "B": np.concatenate([np.zeros((1, CFG.n_layers, RANK, CFG.d_model), np.float32),
                             rng.normal(size=(2, CFG.n_layers, RANK, CFG.d_model)).astype(np.float32)
                             * 0.1]),
    }
    return jp, tp, pools


def test_sched_prefill_logits_match_the_reference(model):
    jp, tp, pools = model
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, CFG.vocab_size, (3, 10)).astype(np.int32)
    lens = np.array([10, 4, 7], np.int32)
    idx = np.array([2, 0, 1], np.int32)
    lj, cj = JL.sched_prefill(jp, CFG, jnp.asarray(tokens), jnp.asarray(lens),
                              {k: jnp.asarray(v) for k, v in pools.items()}, jnp.asarray(idx),
                              use_kernel=False)
    lt, ct = TL.sched_prefill(tp, CFG, torch.as_tensor(tokens), torch.as_tensor(lens),
                              {k: torch.as_tensor(v) for k, v in pools.items()}, torch.as_tensor(idx))
    assert tuple(lt.shape) == (3, 1, CFG.vocab_size)
    np.testing.assert_allclose(_np(lt), _np(lj), atol=1e-4)
    got = C.caches_to_reference(ct, CFG)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(cj)):
        _rel_close(g, w, rtol=2.0**-7)       # bf16 caches: one ulp of rounding apart at most


def test_sched_prefill_reuse_logits_match_the_reference_and_the_dense_prefill(model):
    """Rows whose first 8 (or 4) tokens' K/V come from a dense prefill of the
    same prompts: the tail prefill's logits match the reference's and,
    within float32 noise plus the bf16 cache, the dense prefill's."""
    jp, tp, pools = model
    rng = np.random.default_rng(6)
    p = 12
    tokens = rng.integers(0, CFG.vocab_size, (2, p)).astype(np.int32)
    idx = np.array([1, 2], np.int32)
    prefix = np.array([8, 4], np.int32)
    full = np.array([12, 10], np.int32)
    tpools = {k: torch.as_tensor(v) for k, v in pools.items()}
    jpools = {k: jnp.asarray(v) for k, v in pools.items()}
    dense_l, dense_c = TL.sched_prefill(tp, CFG, torch.as_tensor(tokens), torch.as_tensor(full),
                                        tpools, torch.as_tensor(idx))
    jcaches = jax.tree.map(jnp.asarray, C.caches_to_reference(dense_c, CFG))
    pt = 8
    tail = np.zeros((2, pt), np.int32)
    tail_lens = full - prefix
    for j in range(2):
        tail[j, : tail_lens[j]] = tokens[j, prefix[j] : full[j]]
    # the prefix K/V in place, garbage (the dense prefill's own) above it
    lj, _ = JL.sched_prefill_reuse(jp, CFG, jnp.asarray(tail), jnp.asarray(tail_lens),
                                   jnp.asarray(prefix), jax.tree.map(lambda x: x.astype(jnp.bfloat16), jcaches),
                                   jpools, jnp.asarray(idx), use_kernel=False)
    lt, _ = TL.sched_prefill_reuse(tp, CFG, torch.as_tensor(tail), torch.as_tensor(tail_lens),
                                   torch.as_tensor(prefix), dense_c, tpools, torch.as_tensor(idx))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=1e-4)
    assert (lt.argmax(-1) == dense_l.argmax(-1)).all()


# ---------------------------------------------------------------------------
# KVBlockPool and RadixPrefixIndex
# ---------------------------------------------------------------------------


def toks(n, seed=0, vocab=50):
    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(np.int32)


def _pool(n_blocks, block=4):
    return KV.KVBlockPool(CFG, n_blocks=n_blocks, block=block, device="cpu")


def test_alloc_is_deterministic_lifo():
    pool = _pool(6)
    assert pool.alloc(2) == [0, 1] and pool.alloc(1) == [2]
    pool.deref([1])
    assert pool.alloc(1) == [1]
    pool.check_no_leaks(3)
    assert tuple(pool.data["k"].shape) == (CFG.n_layers, 6, 4, CFG.n_kv_heads, CFG.resolved_head_dim)


def test_exhaustion_raises_and_leaves_state_intact():
    pool = _pool(2)
    pool.alloc(1)
    with pytest.raises(KV.KVPoolExhausted):
        pool.alloc(2)
    assert pool.n_free() == 1
    pool.alloc(1)
    pool.check_no_leaks(2)


def test_ref_and_deref_guard_free_blocks():
    pool = _pool(2)
    with pytest.raises(RuntimeError, match="unallocated"):
        pool.ref([0])
    ids = pool.alloc(1)
    pool.ref(ids)
    pool.deref(ids)
    pool.deref(ids)
    with pytest.raises(RuntimeError, match="deref of free"):
        pool.deref(ids)


def test_check_no_leaks_catches_held_count_drift():
    pool = _pool(2)
    pool.alloc(1)
    with pytest.raises(RuntimeError, match="leak"):
        pool.check_no_leaks(0)


def test_stale_generation_release_noops():
    pool = _pool(2)
    ids, gen = pool.alloc(1), pool.generation
    pool.reset()
    pool.deref(ids, generation=gen)
    assert pool.counters["stale_release"] == 1
    pool.check_no_leaks(0)


def test_default_block_setting():
    assert KV.get_default_block() == KV.DEFAULT_BLOCK == JKV.DEFAULT_BLOCK
    try:
        KV.set_default_block(16)
        assert KV.get_default_block() == 16
        with pytest.raises(ValueError):
            KV.set_default_block(0)
    finally:
        KV.set_default_block(None)
    assert KV.get_default_block() == KV.DEFAULT_BLOCK


def _filled_caches(batch, seq, seed):
    """Stacked bf16 caches with random values, and the same values in the
    reference's tree."""
    rng = np.random.default_rng(seed)
    st = TL.init_stacked_caches(CFG, batch, seq, device="cpu")
    for c in st.values():
        c.copy_(torch.as_tensor(rng.normal(size=c.shape).astype(np.float32)))
    ref = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), C.stacked_to_reference(st, CFG))
    return st, ref


def test_publish_then_gather_roundtrips_bitwise_and_matches_the_reference_pool():
    pool = _pool(8)
    jpool = JKV.KVBlockPool(CFG, n_blocks=8, block=4)
    caches, jcaches = _filled_caches(2, 8, seed=1)
    ids = pool.alloc(2)
    assert jpool.alloc(2) == ids
    pool.publish(caches, 1, ids, [0, 1])
    jpool.publish(jcaches, 1, ids, [0, 1])
    for g, w in zip(jax.tree.leaves(C.stacked_to_reference(pool.data, CFG)), jax.tree.leaves(jpool.data)):
        np.testing.assert_array_equal(g, _np(w))
    tables = torch.as_tensor([ids], dtype=torch.int32)
    out = KV.gather_blocks(pool.data, tables)
    for n in ("k", "v"):
        assert torch.equal(out[n], caches[n][:, 1:2, 0:8])


def test_copy_block_cow():
    pool = _pool(4)
    caches, _ = _filled_caches(1, 4, seed=2)
    src = pool.alloc(1)[0]
    pool.publish(caches, 0, [src], [0])
    assert pool.copy_block(src) == src
    pool.ref([src])
    dst = pool.copy_block(src)
    assert dst != src
    assert pool.refs[src] == 1 and pool.refs[dst] == 1
    assert pool.counters["cow_copies"] == 1
    for x in pool.data.values():
        assert torch.equal(x[:, src], x[:, dst])


def _indexes(n_blocks, block=4):
    """The port's index and the reference's over equal pools: each test runs
    the same operations on both."""
    return (RadixPrefixIndex(_pool(n_blocks, block)),
            JRadix(JKV.KVBlockPool(CFG, n_blocks=n_blocks, block=block)))


def test_match_insert_and_tail_token_cap():
    for idx in _indexes(8):
        t = toks(10, seed=4)
        assert idx.match("a", t) == []
        created = idx.insert("a", t)
        assert [slot for _, slot in created] == [0, 1]
        assert idx.match("a", t) == [bid for bid, _ in created]
        assert idx.match("a", t[:8]) == [created[0][0]]
        assert idx.match("b", t) == []
        idx.pool.check_no_leaks(idx.n_nodes())


def test_insert_dedupes_shared_prefix():
    for idx in _indexes(8):
        shared = toks(8, seed=5)
        idx.insert("t", np.concatenate([shared, toks(4, seed=6)]))
        created = idx.insert("t", np.concatenate([shared, toks(4, seed=7)]))
        assert [slot for _, slot in created] == [2]
        assert idx.n_nodes() == 4


def test_lru_eviction_skips_referenced_blocks():
    trails = []
    for idx in _indexes(2):
        a, b = toks(5, seed=8), toks(5, seed=9)
        (bid_a, _), = idx.insert("t", a)
        (bid_b, _), = idx.insert("t", b)
        handle = idx.acquire([bid_a])
        idx.match("t", a)
        created = idx.insert("t", toks(5, seed=10))
        assert [bid for bid, _ in created] == [bid_b]
        assert idx.match("t", b) == [] and idx.match("t", a) == [bid_a]
        pin_c = idx.acquire([bid for bid, _ in created])
        assert idx.insert("t", np.concatenate([a[:4], toks(5, seed=11)])) == []
        assert idx.counters["insert_stopped"] == 1
        idx.release(handle)
        idx.release(pin_c)
        idx.pool.check_no_leaks(idx.n_nodes())
        trails.append((dict(idx.counters), idx.pool.refs.tolist(), list(idx.pool.free)))
    assert trails[0] == trails[1]


def test_drop_tenant_releases_only_that_scope():
    for idx in _indexes(8):
        idx.insert("a", toks(8, seed=12))
        idx.insert("b", toks(8, seed=13))
        assert idx.drop_tenant("a") == 2
        assert idx.match("a", toks(8, seed=12)) == []
        assert len(idx.match("b", toks(9, seed=13))) >= 1
        idx.pool.check_no_leaks(idx.n_nodes())


def test_reset_makes_outstanding_handles_stale():
    for idx in _indexes(4):
        (bid, _), = idx.insert("t", toks(5, seed=14))
        handle = idx.acquire([bid])
        idx.reset()
        idx.release(handle)
        assert idx.pool.counters["stale_release"] == 1
        idx.pool.check_no_leaks(0)


def test_state_roundtrip_rebuilds_refs_exactly():
    idx = RadixPrefixIndex(_pool(8))
    shared = toks(8, seed=15)
    a = np.concatenate([shared, toks(4, seed=16)])
    b = np.concatenate([shared, toks(4, seed=17)])
    idx.insert("t", a)
    idx.insert("u", b)
    idx2 = RadixPrefixIndex(_pool(8))
    idx2.load_state(idx.state())
    assert idx2.match("t", a) == idx.match("t", a)
    assert idx2.match("u", b) == idx.match("u", b)
    assert idx2.n_nodes() == idx.n_nodes()
    idx2.pool.check_no_leaks(idx2.n_nodes())


def test_paged_gathers_default_to_the_plain_version_as_the_reference(attn, monkeypatch):
    """``gather_blocks`` and ``attn_decode_paged`` take ``use_kernel=False``
    by default, as the reference's do, and only ``use_kernel=True`` goes
    through ``paged.gather`` (K10 on a CUDA pool); both routes give the same
    bits."""
    import inspect

    for port, ref in ((KV.gather_blocks, JKV.gather_blocks), (TA.attn_decode_paged, JA.attn_decode_paged)):
        assert inspect.signature(port).parameters["use_kernel"].default is False
        assert inspect.signature(ref).parameters["use_kernel"].default is False
    calls = []
    real = PG.gather
    monkeypatch.setattr(PG, "gather", lambda *a: calls.append(1) or real(*a))
    jp, tp, jspec, tspec, x, cache = attn
    pool, table = _paged(cache)
    outs = []
    for use_kernel in (False, True):
        tpool = {n: torch.as_tensor(c) for n, c in pool.items()}
        y, _ = TA.attn_decode_paged(tp, torch.as_tensor(x), torch.as_tensor([0, T // 2, T - 1]), tspec, tpool,
                                    torch.as_tensor(table), **({"use_kernel": True} if use_kernel else {}))
        g = KV.gather_blocks({"k": tpool["k"][None]}, torch.as_tensor(table),
                             **({"use_kernel": True} if use_kernel else {}))
        outs.append((y, g["k"]))
        assert len(calls) == (3 if use_kernel else 0)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
