"""The port's tiered Skip-Cache engine (``core/cache_engine.py``) and disk
host tier (``core/cache_store.py``) against the reference's, on the CPU.

Each engine case runs one script of writes, reads, prefetches and flushes
on the reference's ``TieredCacheEngine`` and on the port's, from the same
numpy inputs (seeded), and holds every observation of the port's to the
reference's: the values read (bitwise: the engine owns no math, and the int8
quantiser is bitwise the reference's), the resident ids in LRU order, the
free-row count and every counter of ``CacheStats``. The cases are the
reference's ``tests/test_cache_engine.py`` and ``tests/test_cache_store.py``
that test the engine's own behaviour. The disk tier's files are one format:
each side reads the other's, bf16 slots bit for bit. The fleet trainer
through the engine: ``fleet_cached_epoch_via_engine`` equals the resident
cached epoch bitwise, and ``fleet_finetune(engine=)`` equals the resident run
bitwise and the reference's engine run within ``test_torch_fleet.py``'s bars
(losses rtol 1e-5, adapters atol 2e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import cache_engine as JE  # noqa: E402
from repro.core import fleet_finetune as JFF  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.core.cache_store import HostCacheStore as JStore  # noqa: E402
from repro.models.lm import init_lm as j_init_lm  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import cache_engine as TE  # noqa: E402
from repro_torch.core import fleet_finetune as TFF  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.core.cache_store import HostCacheStore as TStore  # noqa: E402
from repro_torch.core.skip_cache import cache_read  # noqa: E402

J_LAYOUT = {"a": ((4,), jnp.float32), "lab": ((2,), jnp.int32)}
T_LAYOUT = {"a": ((4,), torch.float32), "lab": ((2,), torch.int32)}


class Side:
    """One package's engine and array constructors."""

    def __init__(self, name):
        self.name = name
        self.E = JE if name == "ref" else TE
        self.layout = J_LAYOUT if name == "ref" else T_LAYOUT

    def engine(self, n, layout=None, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.E.TieredCacheEngine(n, layout or self.layout, **kw)

    def arr(self, x):
        return jnp.asarray(x) if self.name == "ref" else torch.as_tensor(np.asarray(x))

    @staticmethod
    def np(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def fill(self, eng, n, batch=2, seed=0):
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((n, 4)).astype(np.float32)
        lab = rng.integers(0, 9, (n, 2)).astype(np.int32)
        for lo in range(0, n, batch):
            eng.write(self.arr(np.arange(lo, min(lo + batch, n))),
                      {"a": self.arr(a[lo:lo + batch]), "lab": self.arr(lab[lo:lo + batch])})

    def read(self, eng, ids, raw=False):
        out = (eng.read_raw if raw else eng.read)(self.arr(np.asarray(ids)))
        return {k: self.np(v) for k, v in out.items()}


def _state(eng):
    st = eng.stats
    return (list(eng.resident_ids()), len(eng._free), st.hbm_hits, st.host_hits, st.staged_hits, st.spills,
            st.writes)


def spill_and_readback(s, tmp):
    eng = s.engine(12, capacity=4)
    s.fill(eng, 12)
    return [_state(eng), s.read(eng, [0, 1, 2, 3]), s.read(eng, [0, 5, 11]), _state(eng)]


def lru_eviction_order(s, tmp):
    eng = s.engine(6, capacity=3)
    s.fill(eng, 3)
    s.read(eng, [0])     # touch 0 so 1 becomes least recently used
    eng.write(s.arr([3]), {"a": s.arr(np.zeros((1, 4), np.float32)), "lab": s.arr(np.zeros((1, 2), np.int32))})
    before = _state(eng)
    return [before, s.read(eng, [1]), _state(eng)]


def budget_derives_capacity(s, tmp):
    eng = s.engine(10, hbm_budget_bytes=3 * (4 * 4 + 2 * 4))
    return [eng.capacity, eng.row_nbytes(), eng.hbm_nbytes()]


def oversized_batch_without_promotion(s, tmp):
    eng = s.engine(8, capacity=2)
    s.fill(eng, 8)
    eng.write(s.arr(np.arange(8)), {"a": s.arr(np.ones((8, 4), np.float32)), "lab": s.arr(np.ones((8, 2), np.int32))})
    return [s.read(eng, np.arange(8)), _state(eng), s.read(eng, [7, 0, 3]), _state(eng)]


def duplicate_ids(s, tmp):
    eng = s.engine(8, capacity=2)
    s.fill(eng, 8)
    obs = []
    for _ in range(3):
        obs += [s.read(eng, [1, 1]), s.read(eng, [2, 2])]
    eng.write(s.arr([3, 3]), {"a": s.arr(np.zeros((2, 4), np.float32)), "lab": s.arr(np.zeros((2, 2), np.int32))})
    return obs + [_state(eng)]


def stale_prefetch(s, tmp):
    eng = s.engine(8, capacity=2)
    s.fill(eng, 8)                  # rows 0..5 spilled
    eng.prefetch(s.arr([0]))
    eng.wait()
    eng.write(s.arr([0]), {"a": s.arr(np.full((1, 4), 42.0, np.float32)), "lab": s.arr(np.zeros((1, 2), np.int32))})
    s.read(eng, [6, 7])             # evict row 0 again
    return [_state(eng), s.read(eng, [0])]


def prefetch_stages_host_rows(s, tmp):
    eng = s.engine(8, capacity=2)
    s.fill(eng, 8)
    cold = [i for i in range(8) if i not in eng.resident_ids()][:2]
    eng.prefetch(s.arr(cold))
    eng.wait()
    return [cold, s.read(eng, cold), _state(eng)]


def prefetch_of_resident_rows_is_noop(s, tmp):
    eng = s.engine(4, capacity=4)
    s.fill(eng, 4)
    eng.prefetch(s.arr(np.arange(4)))
    eng.wait()
    return [len(eng._staged), _state(eng)]


def stream_batches(s, tmp):
    eng = s.engine(8, capacity=3)
    s.fill(eng, 8, seed=3)
    idx_mat = np.array([[0, 5], [7, 1], [2, 6], [3, 4]])
    return [(np.asarray(i), {k: s.np(v) for k, v in vals.items()}) for i, vals in eng.stream_batches(idx_mat)] \
        + [_state(eng)]


def export_skipcache(s, tmp):
    eng = s.engine(10, capacity=3)
    s.fill(eng, 10)
    full = eng.export_skipcache()
    return [int(full.hit_count()), {k: s.np(v) for k, v in full.slots.items()}, _state(eng)]


def flush_to_host(s, tmp):
    eng = s.engine(4, capacity=4)
    s.fill(eng, 4)
    eng.flush_to_host()
    return [[eng._host.has(i) for i in range(4)], s.read(eng, np.arange(4)), _state(eng)]


def disk_spill_and_warm_restart(s, tmp):
    d = str(tmp / s.name)
    eng = s.engine(8, capacity=2, directory=d)
    s.fill(eng, 8)
    eng.flush_to_host()
    again = s.engine(8, capacity=4, directory=d)
    again._present = set(range(8))   # the ids written before the restart
    return [_state(eng), s.read(again, [0, 3, 7]), _state(again)]


def int8_compression(s, tmp):
    f32 = jnp.float32 if s.name == "ref" else torch.float32
    eng = s.engine(6, {"x": ((16,), f32)}, capacity=2, compress="int8")
    x = np.random.default_rng(0).standard_normal((6, 16)).astype(np.float32)
    for lo in range(0, 6, 2):
        eng.write(s.arr(np.arange(lo, lo + 2)), {"x": s.arr(x[lo:lo + 2])})
    return [s.read(eng, np.arange(6)), s.read(eng, [1, 4], raw=True), _state(eng)]


CASES = [spill_and_readback, lru_eviction_order, budget_derives_capacity, oversized_batch_without_promotion,
         duplicate_ids, stale_prefetch, prefetch_stages_host_rows, prefetch_of_resident_rows_is_noop,
         stream_batches, export_skipcache, flush_to_host, disk_spill_and_warm_restart, int8_compression]


def _same(got, want, where="obs"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=where)
        assert np.asarray(got).dtype == want.dtype, where
    else:
        assert got == want, where


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_engine_case_matches_reference(case, tmp_path):
    want = case(Side("ref"), tmp_path)
    got = case(Side("port"), tmp_path)
    _same(got, want)


def test_engine_invariants_the_cases_rely_on(tmp_path):
    """What the reference's tests assert of the cases above, on the port."""
    s = Side("port")
    state, *_ = spill_and_readback(s, tmp_path)
    assert state[5] > 0 and len(state[0]) == 4                       # spilled, 4 resident
    before, _, after = lru_eviction_order(s, tmp_path)
    assert set(before[0]) == {0, 2, 3} and after[3] == before[3] + 1 and 1 in after[0]
    assert budget_derives_capacity(s, tmp_path)[0] == 3
    assert len(oversized_batch_without_promotion(s, tmp_path)[1][0]) <= 2
    *_, last = duplicate_ids(s, tmp_path)
    assert len(last[0]) + last[1] == 2                               # no row leaked
    _, stale = stale_prefetch(s, tmp_path)
    np.testing.assert_array_equal(stale["a"], np.full((1, 4), 42.0, np.float32))
    _, _, staged = prefetch_stages_host_rows(s, tmp_path)
    assert (staged[4], staged[3]) == (2, 0)                          # staged hits, no host hits
    assert prefetch_of_resident_rows_is_noop(s, tmp_path)[0] == 0
    hits, slots, _ = export_skipcache(s, tmp_path)
    assert hits == 10
    has, _, _ = flush_to_host(s, tmp_path)
    assert all(has)
    eng = s.engine(4, capacity=2)
    s.fill(eng, 2)
    with pytest.raises(KeyError, match="never written"):
        eng.read(torch.tensor([3]))
    st = TE.CacheStats(hbm_hits=3, host_hits=1)
    assert st.reads() == 4 and st.hbm_hit_rate() == 0.75 and ("x/hbm_hits", 3.0) in st.as_rows("x")
    assert st.as_rows() == JE.CacheStats(hbm_hits=3, host_hits=1).as_rows()
    with pytest.raises(ValueError, match="exactly one"):
        s.engine(4)


def test_int8_read_dequantises_within_the_rowwise_bound(tmp_path):
    deq, raw, _ = int8_compression(Side("port"), tmp_path)
    x = np.random.default_rng(0).standard_normal((6, 16)).astype(np.float32)
    bound = np.abs(x).max(axis=-1, keepdims=True) / 127.0 + 1e-6
    assert (np.abs(deq["x"] - x) <= bound * 1.01).all()
    assert raw["x/q"].dtype == np.int8 and raw["x/s"].shape == (2,)
    lay = TE.storage_layout({"x": ((3, 8), torch.float32), "lab": ((2,), torch.int32)}, "int8")
    assert lay == {"x/q": ((3, 8), torch.int8), "x/s": ((3,), torch.float32), "lab": ((2,), torch.int32)}
    with pytest.raises(ValueError, match="compression"):
        TE.storage_layout(lay, "int4")


def test_tenant_view_offsets_into_the_engine():
    s = Side("port")
    eng = s.engine(8, capacity=8)
    view = eng.tenant_view(1, 4)
    view.write(torch.tensor([0, 3]), {"a": torch.ones((2, 4)), "lab": torch.ones((2, 2), dtype=torch.int32)})
    assert view.has(3) and eng.has(7) and not eng.has(3)
    np.testing.assert_array_equal(view.read([3])["a"].numpy(), eng.read([7])["a"].numpy())
    with pytest.raises(IndexError, match="partition"):
        view.read([4])
    with pytest.raises(ValueError, match="exceeds"):
        eng.tenant_view(2, 4)


# ---------------------------------------------------------------------------
# The disk host tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_store_files_are_one_format_bf16_bit_for_bit(tmp_path, writer):
    """One side writes, both read: float32, int8 and bf16 slots round-trip
    bit for bit (numpy has no bfloat16; the port writes bf16 through its
    16-bit integer view), the prefetched batch is taken only for its ids,
    and no ``.tmp`` file is left behind."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 2, 3)).astype(np.float32)
    b = rng.integers(-9, 9, (3, 4)).astype(np.int8)
    x = np.asarray(jnp.linspace(-2, 2, 3 * 16).reshape(3, 16).astype(jnp.bfloat16))
    jspec = {"a": ((2, 3), jnp.float32), "b": ((4,), jnp.int8), "x": ((16,), jnp.bfloat16)}
    tspec = {"a": ((2, 3), torch.float32), "b": ((4,), torch.int8), "x": ((16,), torch.bfloat16)}
    jstore, tstore = JStore(str(tmp_path), jspec), TStore(str(tmp_path), tspec)
    ids = np.array([3, 7, 9])
    if writer == "ref":
        jstore.flush_batch(ids, {"a": a, "b": b, "x": x})
    else:
        tstore.flush_batch(ids, {"a": torch.as_tensor(a), "b": torch.as_tensor(b), "x": C.to_tensor(x)})
    assert tstore.has(3) and tstore.has(9) and not tstore.has(0)
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    want = jstore.read_batch(ids)
    tstore.prefetch(ids[:2])
    tstore.wait()
    other = tstore.read_batch(ids[1:])      # not the prefetched ids: a synchronous read
    got = tstore.read_batch(ids[:2])        # the prefetched batch
    assert got["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["x"].view(torch.int16).numpy(), want["x"][:2].view(np.int16))
    np.testing.assert_array_equal(other["x"].view(torch.int16).numpy(), want["x"][1:].view(np.int16))
    np.testing.assert_array_equal(want["x"].view(np.int16), x.view(np.int16))
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[k].numpy(), want[k][:2])
        np.testing.assert_array_equal(other[k].numpy(), want[k][1:])
    assert tstore.nbytes_on_disk() == jstore.nbytes_on_disk() == 3 * (6 * 4 + 4 + 16 * 2)


# ---------------------------------------------------------------------------
# The fleet trainer through the engine
# ---------------------------------------------------------------------------

CFG = reduce_config(get_config("stablelm-1.6b"))
RANK, N_T, N_PER, BPT, SEQ, LR = 4, 2, 4, 2, 8, 1e-2


@pytest.fixture(scope="module")
def fleet_inputs():
    jp = j_init_lm(jax.random.key(0), CFG)
    tok = jax.random.randint(jax.random.key(1), (N_T, N_PER, SEQ), 0, CFG.vocab_size)
    lab = jax.random.randint(jax.random.key(2), (N_T, N_PER, SEQ), 0, CFG.vocab_size)
    kw = dict(rank=RANK, mode="full", cache_dtype="float32", use_fused_kernel=True)
    init = JFF.init_fleet_adapters(jax.random.key(3), CFG, JSL.SkipLoRAConfig(**kw), N_T)
    return (jp, C.params_from_reference(jax.tree.map(np.asarray, jp), CFG), tok, lab,
            C.to_tensor(np.asarray(tok)), C.to_tensor(np.asarray(lab)),
            C.adapters_from_reference(jax.tree.map(np.asarray, init)), kw)


def _t_engine(sl, capacity):
    return TE.TieredCacheEngine(N_T * N_PER, TSL.lm_cache_layout(CFG, sl, SEQ), capacity=capacity, device="cpu")


def test_cached_epoch_via_engine_equals_the_resident_epoch(fleet_inputs):
    _, tp, _, _, ttok, tlab, init, kw = fleet_inputs
    sl = TSL.SkipLoRAConfig(**kw)
    res = TFF.fleet_finetune(None, CFG, sl, tp, ttok, tlab, epochs=1, batch_per_tenant=BPT, lr=LR, adapters=init)
    eng = _t_engine(sl, capacity=BPT * N_T)      # half the rows: spills guaranteed
    ids = torch.arange(N_T * N_PER)
    for lo in range(0, N_T * N_PER, BPT * N_T):
        eng.write(ids[lo:lo + BPT * N_T], cache_read(res.cache, ids[lo:lo + BPT * N_T]))
    assert eng.stats.spills > 0
    opt = TFF.adamw(LR)
    row_tenant = TFF.fleet_row_tenant(N_T, BPT)
    idx_mat = torch.as_tensor(TFF.fleet_index_matrix(1, N_T, N_PER, BPT))
    st0 = opt.init(res.adapters)
    a, _, la = TFF.make_fleet_cached_epoch(CFG, sl, opt, N_T)(tp, res.adapters, st0, res.cache, idx_mat, row_tenant)
    step = TFF.make_fleet_cached_step_from_vals(CFG, sl, opt, N_T)
    b, _, lb = TFF.fleet_cached_epoch_via_engine(step, tp, res.adapters, st0, eng, idx_mat, row_tenant)
    assert torch.equal(la, lb) and all(torch.equal(a[k], b[k]) for k in a)
    assert eng.stats.staged_hits + eng.stats.host_hits > 0


def test_fleet_finetune_through_an_engine(fleet_inputs):
    jp, tp, jtok, jlab, ttok, tlab, init, kw = fleet_inputs
    jsl, tsl = JSL.SkipLoRAConfig(**kw), TSL.SkipLoRAConfig(**kw)
    jeng = JE.TieredCacheEngine(N_T * N_PER, JSL.lm_cache_layout(CFG, jsl, SEQ), capacity=5)
    want = JFF.fleet_finetune(jax.random.key(3), CFG, jsl, jp, jtok, jlab, epochs=3, batch_per_tenant=BPT,
                              lr=LR, use_kernel=True, engine=jeng)
    teng = _t_engine(tsl, capacity=5)
    got = TFF.fleet_finetune(None, CFG, tsl, tp, ttok, tlab, epochs=3, batch_per_tenant=BPT, lr=LR,
                             adapters=init, engine=teng)
    resident = TFF.fleet_finetune(None, CFG, tsl, tp, ttok, tlab, epochs=3, batch_per_tenant=BPT, lr=LR,
                                  adapters=init)
    assert got.cache is None and got.engine is teng and teng.stats.spills > 0
    np.testing.assert_array_equal(got.losses, resident.losses)
    assert all(torch.equal(got.adapters[k], resident.adapters[k]) for k in ("A", "B"))
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    for k in ("A", "B"):
        np.testing.assert_allclose(C.to_numpy(got.adapters[k]), np.asarray(want.adapters[k]), atol=2e-5)
    assert _state(teng)[2:] == _state(jeng)[2:]       # the same hits, spills and writes as the reference's
