"""The port's ``SessionRuntime`` training half (ingest, adapt, the tiered
cache engine behind them) against the reference's, and the reference's
own bars held by the port against itself, on the CPU.

Reduced stablelm-1.6b and gemma2-9b (float32; gemma2-9b brings local
attention, sandwich norms and softcaps), params from the reference's
``init_lm`` carried across by ``repro_torch.convert``; tokens, labels and
prompts made with numpy from seeds. The reference's fresh tenants draw
their initial adapters from ``jax.random.key(3)``; the port is handed that
stack by patching its ``fleet_finetune.init_fleet_adapters`` inside the
test. The reference runs its Pallas kernels in interpret mode
(``use_kernel=True``), the port the kernels' plain versions.

Bars against the reference, one serve -> ingest -> adapt -> serve session
(``tests/test_runtime.py``'s ``TestOfflineParity``), rank 4, 2 tenants x 4
samples x seq 8, 3 epochs, batch per tenant 2: ingest logits within atol
1e-4 (float32, other summation orders, as ``test_torch_serve.py``), per-step
per-tenant losses rtol 1e-5 and adapters and pool slots atol 2e-5 (as
``test_torch_fleet.py``, gemma2-9b's scaled by the cached activations' max
where it passes 1), the adapt path, and equal temperature-0 tokens before
and after the write-back. Against the port itself: the session equals the
offline ``fleet_finetune`` bitwise in mode ``full`` (adapters, losses, pool
slots); the streaming path over a spilling engine equals the resident scan
path bitwise; and the reference's session smoke cases (error paths, the
serve slot-index memo, adapt grouping, int8 learning). The CLIs that run
through the session are tested in ``test_torch_finetune.py`` (``--hbm-mb``,
``--cache-dir``) and ``test_torch_fleet.py`` (``--check-parity``)."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import fleet_finetune as JFF  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.core.runtime import SessionRuntime as JRuntime  # noqa: E402
from repro.models.lm import init_lm as j_init_lm  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import fleet_finetune as TFF  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.core import prefill_graph as PG  # noqa: E402
from repro_torch.core.adapter_pool import AdapterPool  # noqa: E402
from repro_torch.core.runtime import SessionRuntime  # noqa: E402

RANK, N_T, N_PER, SEQ, BPT, EPOCHS, LR, NEW = 4, 2, 4, 8, 2, 3, 1e-2, 4
LOGIT_ATOL, LOSS_RTOL, ADAPTER_ATOL = 1e-4, 1e-5, 2e-5
CFG = reduce_config(get_config("stablelm-1.6b"))


def _sl(mod, mode="full", use_kernel=True):
    return mod.SkipLoRAConfig(rank=RANK, mode=mode, cache_dtype="float32", use_fused_kernel=use_kernel)


def _data(cfg, n_t=N_T, n_per=N_PER, seq=SEQ, seed=5):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, cfg.vocab_size, (n_t, n_per, seq)).astype(np.int32) for _ in range(2))


def _prompts(cfg, n=N_T + 1, seed=9):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, 6)).astype(np.int32)


@contextlib.contextmanager
def _initial(stacked):
    """The port's fresh tenants start from ``stacked`` (tenant i <- row i)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFF, "init_fleet_adapters", lambda gen, cfg, sl, n: {k: v[:n].clone() for k, v in stacked.items()})
        yield


def _run_session(rt, tok, lab, prompts, adapt, extra):
    """serve -> ingest (batches of BPT) -> adapt -> serve -> one more ingest
    of tenant 0 (through its trained slot). Returns what to compare."""
    n_t, n_per, _ = tok.shape
    out = {"base": np.asarray(rt.serve([None] * (n_t + 1), prompts, max_new=NEW))}
    out["ingest"] = [np.asarray(extra(rt.ingest(t, tok[t, lo:lo + BPT], lab[t, lo:lo + BPT])))
                     for t in range(n_t) for lo in range(0, n_per, BPT)]
    res = adapt(rt)
    out["path"] = res["path"]
    out["losses"] = np.stack([res["losses"][t] for t in range(n_t)], axis=-1)
    out["adapters"] = {k: np.stack([np.asarray(extra(rt.tenant(t).adapters[k])) for t in range(n_t)])
                       for k in ("A", "B")}
    out["pools"] = {k: np.asarray(extra(v)) for k, v in rt.pool.pools().items()}
    out["tuned"] = np.asarray(rt.serve(list(range(n_t)) + [None], prompts, max_new=NEW))
    out["ingest_tuned"] = np.asarray(extra(rt.ingest(0, tok[0, :BPT], lab[0, :BPT])))
    return out


@pytest.fixture(scope="module", params=["stablelm-1.6b", "gemma2-9b"])
def session_pair(request):
    """(cfg, reference session results, port session results, port runtime)."""
    cfg = reduce_config(get_config(request.param))
    jp = j_init_lm(jax.random.key(0), cfg)
    tp = C.params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    tok, lab = _data(cfg)
    prompts = _prompts(cfg)
    kw = dict(max_tenants=N_T, samples_per_tenant=N_PER + BPT, seq=SEQ, lr=LR, use_kernel=True)
    jrt = JRuntime(cfg, _sl(JSL), jp, **kw)
    want = _run_session(
        jrt, jnp.asarray(tok), jnp.asarray(lab), jnp.asarray(prompts),
        lambda rt: rt.adapt(epochs=EPOCHS, batch_per_tenant=BPT, key=jax.random.key(3)), lambda x: x,
    )
    init = JFF.init_fleet_adapters(jax.random.key(3), cfg, _sl(JSL), N_T)
    trt = SessionRuntime(cfg, _sl(TSL), tp, device="cpu", **kw)
    with _initial(C.adapters_from_reference(jax.tree.map(np.asarray, init))):
        got = _run_session(
            trt, torch.as_tensor(tok), torch.as_tensor(lab), torch.as_tensor(prompts),
            lambda rt: rt.adapt(epochs=EPOCHS, batch_per_tenant=BPT), lambda x: x.detach(),
        )
    return cfg, want, got, trt


def test_session_matches_reference(session_pair):
    cfg, want, got, trt = session_pair
    assert got["path"] == want["path"] == "scan"
    for g, w in zip(got["ingest"] + [got["ingest_tuned"]], want["ingest"] + [want["ingest_tuned"]]):
        assert g.shape == (BPT, 1, cfg.vocab_size)
        np.testing.assert_allclose(g, w, atol=LOGIT_ATOL)
    assert got["losses"].shape == want["losses"].shape == (EPOCHS, N_PER // BPT, N_T)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    scale = max(1.0, float(trt.engine.export_skipcache().slots["acts"].abs().max()))
    for k in ("A", "B"):
        np.testing.assert_allclose(got["adapters"][k], want["adapters"][k], atol=ADAPTER_ATOL * scale)
    assert got["pools"].keys() == want["pools"].keys()
    for k in want["pools"]:
        np.testing.assert_allclose(got["pools"][k], want["pools"][k], atol=ADAPTER_ATOL * scale)
    np.testing.assert_array_equal(got["base"], want["base"])
    np.testing.assert_array_equal(got["tuned"], want["tuned"])
    stats = trt.stats()
    assert stats["runtime/ingest/rows"] == N_T * N_PER + BPT and stats["runtime/serve/grouped/float"] == 1
    assert stats["runtime/serve/single/base"] == 1 and stats["adapter_pool/registrations"] == N_T
    assert len(PG.GRAPHS) == 0 and not PG.GRAPHS.stats     # the CPU's ingests and prefills are eager


# ---------------------------------------------------------------------------
# The port against itself
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp():
    return C.params_from_reference(jax.tree.map(np.asarray, j_init_lm(jax.random.key(0), CFG)), CFG)


def _runtime(tp, sl=None, *, n_t=N_T, n_per=N_PER, seq=SEQ, **kw):
    return SessionRuntime(CFG, sl if sl is not None else _sl(TSL), tp, max_tenants=n_t,
                          samples_per_tenant=n_per, seq=seq, lr=LR, device="cpu", **kw)


def _ingest_all(rt, tok, lab, bpt=BPT, who=None):
    for t in range(tok.shape[0]):
        for lo in range(0, tok.shape[1], bpt):
            rt.ingest(t if who is None else who[t], torch.as_tensor(tok[t, lo:lo + bpt]),
                      torch.as_tensor(lab[t, lo:lo + bpt]))


def _gen():
    return torch.Generator().manual_seed(3)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_session_equals_offline_fleet_finetune_bitwise(tp, use_kernel):
    """The reference's section 9 bar on the port: serve -> ingest -> adapt ->
    serve reproduces the offline trainer (populate epoch, then cached
    epochs) bitwise, and the pool slots hold ``write_back_to_pool``'s."""
    sl = _sl(TSL, use_kernel=use_kernel)
    tok, lab = _data(CFG, seed=7)
    prompts = torch.as_tensor(_prompts(CFG))
    ref = TFF.fleet_finetune(_gen(), CFG, sl, tp, torch.as_tensor(tok), torch.as_tensor(lab), epochs=EPOCHS,
                             batch_per_tenant=BPT, lr=LR, use_kernel=use_kernel)
    rt = _runtime(tp, sl, use_kernel=use_kernel)
    rt.serve([None] * (N_T + 1), prompts, max_new=NEW)
    _ingest_all(rt, tok, lab)
    out = rt.adapt(epochs=EPOCHS, batch_per_tenant=BPT, generator=_gen())
    rt.serve(list(range(N_T)) + [None], prompts, max_new=NEW)
    assert out["path"] == "scan" and out["groups"] == [list(range(N_T))]
    np.testing.assert_array_equal(np.stack([out["losses"][t] for t in range(N_T)], axis=-1), ref.losses)
    for t in range(N_T):
        for k in ("A", "B"):
            assert torch.equal(rt.tenant(t).adapters[k], ref.adapters[k][t])
    pool = AdapterPool(N_T + 1, CFG, RANK, device="cpu")
    TFF.write_back_to_pool(pool, list(range(N_T)), ref.adapters)
    assert all(torch.equal(v, pool.pools()[k]) for k, v in rt.pool.pools().items())
    assert rt.pool.pinned() == set(range(N_T))


@pytest.mark.parametrize("mode,disk", [("full", False), ("full", True), ("int8", False)])
def test_stream_path_equals_scan_path_with_spills(tp, tmp_path, mode, disk):
    """Under a forced device budget ``adapt`` streams its batches out of the
    engine (spilling for real, through a disk host tier with ``cache_dir``)
    and gives the resident scan path's losses and adapters bitwise (the
    reference holds 1e-6)."""
    tok, lab = _data(CFG, seed=8)
    outs, rts = [], []
    for cap in (None, N_T * N_PER // 2):
        kw = {} if cap is None else dict(cache_capacity=cap, cache_dir=str(tmp_path) if disk else None)
        rt = _runtime(tp, _sl(TSL, mode), **kw)
        _ingest_all(rt, tok, lab)
        outs.append(rt.adapt(epochs=EPOCHS, batch_per_tenant=BPT, generator=_gen()))
        rts.append(rt)
    scan, stream = outs
    assert (scan["path"], stream["path"]) == ("scan", "stream") and rts[1].engine.stats.spills > 0
    assert rts[1].stats()["cache_engine/hbm_hit_rate"] < 1.0
    if disk:
        assert any(p.name.endswith(".bin") for p in tmp_path.iterdir())
    for t in range(N_T):
        np.testing.assert_array_equal(stream["losses"][t], scan["losses"][t])
        for k in ("A", "B"):
            assert torch.equal(rts[1].tenant(t).adapters[k], rts[0].tenant(t).adapters[k])


def test_int8_mode_session_learns(tp):
    tok, lab = _data(CFG, n_per=8, seed=9)
    rt = _runtime(tp, _sl(TSL, "int8"), n_per=8, pool_compress="int8")
    _ingest_all(rt, tok, lab, bpt=4)
    out = rt.adapt(epochs=3, batch_per_tenant=4, generator=_gen())
    ls = np.stack([out["losses"][t] for t in range(N_T)], axis=-1)
    assert ls.shape == (3, 2, 2) and np.isfinite(ls).all()
    assert (ls[-1].mean(axis=0) < ls[0].mean(axis=0)).all()
    assert rt.serve([0, 1, None], torch.as_tensor(_prompts(CFG)), max_new=2).shape == (3, 2)
    assert rt.counters["serve/grouped/int8"] == 1


# ---------------------------------------------------------------------------
# The reference's session smoke cases
# ---------------------------------------------------------------------------


def test_ingest_partition_overflow_and_seq_mismatch_raise(tp):
    rt = _runtime(tp, n_per=2)
    tok, lab = _data(CFG, n_t=1, n_per=3)
    with pytest.raises(ValueError, match="partition full"):
        rt.ingest("u0", tok[0], lab[0])
    tok16, lab16 = _data(CFG, n_t=1, n_per=2, seq=16)
    with pytest.raises(ValueError, match="seq"):
        rt.ingest("u0", tok16[0], lab16[0])
    # a rejected batch registers no tenant and takes no partition
    assert not rt._tenants and len(rt._free_partitions) == N_T


def test_adapt_without_ingest_raises(tp):
    rt = _runtime(tp)
    with pytest.raises(ValueError, match="no tenants"):
        rt.adapt(epochs=1)
    rt._add_tenant("ghost")     # partition assigned, nothing ingested
    with pytest.raises(ValueError, match="no ingested"):
        rt.adapt(["ghost"], epochs=1)
    with pytest.raises(KeyError, match="unknown tenant"):
        rt.tenant("nobody")


def test_session_capacity_bounds_and_release(tp):
    rt = _runtime(tp, n_t=1)
    tok, lab = _data(CFG)
    rt.ingest("u0", tok[0], lab[0])
    rt.adapt(epochs=1, batch_per_tenant=2, generator=_gen())
    with pytest.raises(RuntimeError, match="session full"):
        rt.ingest("u1", tok[1], lab[1])
    assert rt.pool.pinned() == {"u0"}
    rt.release("u0")
    assert rt.pool.has("u0") and rt.pool.pinned() == set()   # slot kept, LRU applies again
    rt.ingest("u1", tok[1], lab[1])                           # partition recycled
    assert rt.tenant("u1").partition == 0


def test_partial_fill_adapt_trains_on_own_rows(tp):
    """Partitions are an allocation stride, not a fill: half-filled
    partitions train each tenant on its own rows, on both paths."""
    tok, lab = _data(CFG, seed=11)
    outs = {}
    for name, n_per, kw in (("part", 8, {}), ("full", 4, {}), ("stream", 8, dict(cache_capacity=4))):
        rt = _runtime(tp, n_per=n_per, **kw)
        _ingest_all(rt, tok, lab, bpt=4)
        outs[name] = (rt.adapt(epochs=2, batch_per_tenant=2, generator=_gen()), rt)
    assert outs["stream"][0]["path"] == "stream"
    for name in ("part", "stream"):
        for t in range(N_T):
            np.testing.assert_array_equal(outs[name][0]["losses"][t], outs["full"][0]["losses"][t])
            assert torch.equal(outs[name][1].tenant(t).adapters["B"], outs["full"][1].tenant(t).adapters["B"])


def test_freeze_a_mode_and_what_stays_unported_raise(tp):
    with pytest.raises(ValueError, match="full"):
        _runtime(tp, TSL.SkipLoRAConfig(rank=RANK, mode="freeze_a"))
    with pytest.raises(ValueError, match="idx_memo_slots"):
        _runtime(tp, idx_memo_slots=0)
    with pytest.raises(ValueError, match="exactly one"):
        _runtime(tp, cache_capacity=2, hbm_budget_bytes=1 << 20)


def test_idx_memo_lru_bound_and_counters(tp):
    rt = _runtime(tp, idx_memo_slots=2, pool_slots=4)
    tok, lab = _data(CFG)
    _ingest_all(rt, tok, lab, who=["u0", "u1"])
    rt.adapt(epochs=1, batch_per_tenant=2, generator=_gen())
    prompts = torch.as_tensor(_prompts(CFG, n=2))
    orders = [["u0", "u1"], ["u1", "u0"], ["u0", "u0"]]
    for who in orders:
        rt.serve(who, prompts, max_new=2)
    assert len(rt._idx_cache) == 2                       # the third ordering evicted one
    assert rt.counters["idx_memo/misses"] == 3 and rt.counters["idx_memo/evictions"] == 1
    rt.serve(orders[2], prompts, max_new=2)              # the freshest ordering hits
    assert rt.counters["idx_memo/hits"] == 1
    rt.serve(orders[0], prompts, max_new=2)              # the evicted one misses again
    assert rt.counters["idx_memo/misses"] == 4
    rt.pool.register("u2", rt.tenant("u0").adapters)    # a new slot moves the pool version
    rt.serve(orders[2], prompts, max_new=2)              # ... and every memo entry misses
    assert rt.counters["idx_memo/misses"] == 5


def test_unequal_trajectories_split_into_groups(tp):
    """Tenants at different optimizer steps cannot share the stacked step
    count: adapt subgroups them, and tenant u0 (adapted twice) stands at
    twice u1's step."""
    rt = _runtime(tp, n_t=3)
    tok, lab = _data(CFG, n_t=3)
    _ingest_all(rt, tok, lab, who=["u0", "u1", "u2"])
    rt.adapt(["u0"], epochs=1, batch_per_tenant=2, generator=_gen())
    out = rt.adapt(epochs=1, batch_per_tenant=2, generator=_gen())
    assert sorted(len(g) for g in out["groups"]) == [1, 2]
    assert rt.tenant("u0").step == 2 * rt.tenant("u1").step
    assert rt.counters["adapt/epochs"] == 3
