"""The port's ``RequestScheduler`` and serving ``SessionRuntime`` against the
reference's, on the CPU.

Reduced stablelm-1.6b in float32 (the traces also on gemma2-9b: local
attention, sandwich norms, softcaps), params from the reference's
``init_lm``
carried across by ``repro_torch.convert``; both sessions hold the same two
adapters (``pool.register``, as the reference's serve CLI fills its pool).
Prompts are made with numpy from seeds.

Bars: temperature-0 tokens equal to the reference's, and the same
``counters`` (the planning is deterministic host logic, so every count must
agree exactly), on the reference's mid-decode admission, shared-prefix
reuse and row-recycling traces. Against the port itself: continuous ==
sequential == solo ``serve``; reuse on == reuse off; no block leaks after a
drain; a failed dispatch unwinds its admissions; freed rows readmit in the
same step; ingest queued with ``enqueue_ingest`` runs at a step boundary
and lands as a direct ``ingest`` does."""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.core.runtime import SessionRuntime as JRuntime  # noqa: E402
from repro.core.scheduler import RequestScheduler as JScheduler  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.core import prefill_graph as PG  # noqa: E402
from repro_torch.core import scheduler as S  # noqa: E402
from repro_torch.core.runtime import SessionRuntime  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402

CFG = reduce_config(get_config("stablelm-1.6b"))
RANK = 4

#: the reference's traces (tests/test_scheduler.py), as scheduler arguments
MID_DECODE = dict(max_batch=3, max_prompt=6, max_new_cap=4, admit_bucket=1, inflight_per_tenant=3,
                  chunk=2)
SHARED = dict(max_batch=4, max_prompt=16, max_new_cap=3, admit_bucket=2, inflight_per_tenant=4,
              chunk=2, kv_block=4)
RECYCLE = dict(max_batch=2, max_prompt=16, max_new_cap=3, admit_bucket=2, inflight_per_tenant=6,
               chunk=2, kv_block=4)


def _adapters(seed, cfg=CFG):
    rng = np.random.default_rng(seed)
    l, d = cfg.n_layers, cfg.d_model
    return {
        "A": (rng.normal(size=(l, d, RANK)) / np.sqrt(d)).astype(np.float32),
        "B": (rng.normal(size=(l, RANK, d)) * 0.1).astype(np.float32),
    }


def _sessions(cfg):
    """(reference runtime, port runtime) over the same weights and adapters."""
    jp = JL.init_lm(jax.random.key(0), cfg)
    tp = C.params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    jrt = JRuntime(cfg, JSL.SkipLoRAConfig(rank=RANK, mode="full", cache_dtype="float32"), jp,
                   max_tenants=2, samples_per_tenant=1, seq=8)
    trt = SessionRuntime(cfg, TSL.SkipLoRAConfig(rank=RANK), tp, max_tenants=2, samples_per_tenant=1, seq=8,
                         device="cpu")
    for i in range(2):
        jrt.pool.register(f"u{i}", _adapters(10 + i, cfg))
        trt.pool.register(f"u{i}", _adapters(10 + i, cfg))
    return jrt, trt


@pytest.fixture(scope="module")
def sessions():
    return _sessions(CFG)


@pytest.fixture(scope="module")
def local_sessions():
    """Reduced gemma2-9b: local attention (window 8, which the 16-token
    prompts pass), sandwich norms, softcaps. gemma3-27b's parity runs in the
    fine-tuning and fleet files, where it costs the tier-1 run less."""
    return _sessions(reduce_config(get_config("gemma2-9b")))


def _prompts(n, length, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (n, length)).astype(np.int32)


def _shared_prefix(n, share=12, tail=4, seed=20):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, CFG.vocab_size, share).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, CFG.vocab_size, tail).astype(np.int32)])
            for _ in range(n)]


def _run(sched_cls, rt, prompts, who, gen, **kw):
    """Submit every prompt, drain, return (tokens per request, counters)."""
    rt.reset_prefix_cache()
    sched = sched_cls(rt, **kw)
    reqs = [sched.submit(t, p, max_new=gen) for t, p in zip(who, prompts)]
    sched.drain()
    return [r.result() for r in reqs], dict(sched.counters), sched


def _mixed():
    """Shared-prefix prompts interleaved with unrelated ones: reuse waves
    split at the first prompt of the other kind (``prefix/wave_split``)."""
    shared, other = _shared_prefix(3, seed=22), list(_prompts(3, 16, 23))
    return [p for pair in zip(shared, other) for p in pair]


TRACES = {
    "mid-decode": (lambda: (_prompts(3, 6, 5), ["u0", "u1", "u0"], 4, MID_DECODE)),
    "mixed-waves": (lambda: (_mixed(), ["u0", "u0", "u1", "u0", "u0", None], 3, SHARED)),
    "shared-prefix": (lambda: (_shared_prefix(4), [None] * 4, 3, SHARED)),
    "shared-prefix-tenant": (lambda: (_shared_prefix(4, seed=21), ["u1"] * 4, 3, SHARED)),
    "recycle": (lambda: (_shared_prefix(6), [None] * 6, 3, RECYCLE)),
}


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse-on", "reuse-off"])
@pytest.mark.parametrize("trace", list(TRACES))
def test_tokens_and_counters_equal_the_reference(sessions, trace, reuse):
    _check_trace(*sessions, trace, reuse)


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse-on", "reuse-off"])
@pytest.mark.parametrize("trace", list(TRACES))
def test_tokens_and_counters_equal_the_reference_on_local_attention(local_sessions, trace, reuse):
    _check_trace(*local_sessions, trace, reuse)


def _check_trace(jrt, trt, trace, reuse):
    """Tokens and counters of the reference's scheduler on ``trace``, and the
    port's own invariants after it (on the CPU no admission graph)."""
    prompts, who, gen, kw = TRACES[trace]()
    want, want_c, _ = _run(JScheduler, jrt, prompts, who, gen, prefix_reuse=reuse, **kw)
    got, got_c, sched = _run(S.RequestScheduler, trt, prompts, who, gen, prefix_reuse=reuse, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got_c == want_c
    assert len(PG.GRAPHS) == 0 and not PG.GRAPHS.stats     # the CPU's admissions are eager: nothing captured
    if trace == "mixed-waves" and reuse:
        assert got_c["prefix/wave_split"] >= 1
    if reuse and trace != "mid-decode":
        assert got_c["dispatch/admit_reuse"] >= 1 and got_c["prefix/hits"] >= 1
        assert got_c["prefix/blocks_reused"] >= 1
        trt.check_prefix_no_leaks()
        pools = sched.prefix_metrics()["pools"]["0"]
        assert pools["held"] == pools["refs_total"] == pools["nodes"]
    if trace == "mid-decode":
        assert got_c["dispatch/admit"] == 3     # two of the three joined a live batch


def test_reuse_on_equals_reuse_off_and_leaks_nothing(sessions):
    _, trt = sessions
    prompts = _shared_prefix(4)
    on, on_c, _ = _run(S.RequestScheduler, trt, prompts, [None] * 4, 3, prefix_reuse=True, **SHARED)
    trt.check_prefix_no_leaks()
    off, off_c, _ = _run(S.RequestScheduler, trt, prompts, [None] * 4, 3, prefix_reuse=False, **SHARED)
    assert on_c["dispatch/admit_reuse"] >= 1 and off_c.get("dispatch/admit_reuse", 0) == 0
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_continuous_equals_sequential_equals_solo_serve(sessions):
    _, trt = sessions
    prompts, who, gen = _prompts(3, 6, 5), ["u0", "u1", "u0"], 4
    cont, _, _ = _run(S.RequestScheduler, trt, prompts, who, gen, **MID_DECODE)
    seq, seq_c, _ = _run(S.RequestScheduler, trt, prompts, who, gen, mode="sequential", **MID_DECODE)
    assert seq_c["dispatch/admit"] == 3
    for i, (c, s) in enumerate(zip(cont, seq)):
        solo = trt.serve([who[i]], prompts[i : i + 1], max_new=gen)
        np.testing.assert_array_equal(c, solo[0].numpy())
        np.testing.assert_array_equal(s, c)


def test_greedy_rows_beside_sampled_rows_match_solo_serve(sessions):
    """Mixed temperatures in one live batch (and base traffic beside a
    tenant): greedy rows still give their solo tokens, sampled rows draw
    valid tokens, and an identically seeded replay repeats every token."""
    _, trt = sessions
    prompts = _prompts(5, 4, 8)
    who = ["u0", None, "u1", "u0", None]
    temps = [0.0, 0.7, 0.0, 1.0, 0.0]

    def run():
        sched = S.RequestScheduler(trt, max_batch=2, max_prompt=4, max_new_cap=3, admit_bucket=2,
                                   inflight_per_tenant=2, chunk=2, prefix_reuse=False)
        reqs = [sched.submit(t, p, max_new=3, temperature=tmp) for t, p, tmp in zip(who, prompts, temps)]
        done = sched.drain()
        assert len(done) == 5 and not sched._in_flight
        assert sched.counters["tokens"] == 15
        return [r.result() for r in reqs]

    first, again = run(), run()
    for i, toks in enumerate(first):
        assert toks.shape == (3,) and ((toks >= 0) & (toks < CFG.vocab_size)).all()
        np.testing.assert_array_equal(toks, again[i])
        if temps[i] == 0.0:
            solo = trt.serve([who[i]], prompts[i : i + 1], max_new=3)
            np.testing.assert_array_equal(toks, solo[0].numpy())


def test_failed_dispatch_unwinds_admissions(sessions, monkeypatch):
    _, trt = sessions
    sched = S.RequestScheduler(trt, max_batch=2, max_prompt=4, max_new_cap=3, admit_bucket=2,
                               inflight_per_tenant=2, chunk=2)
    real = S._sched_admit
    armed = {"on": True}

    def flaky(*a, **kw):
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected device failure")
        return real(*a, **kw)

    monkeypatch.setattr(S, "_sched_admit", flaky)
    prompts = _prompts(3, 4, 12)
    bad = [sched.submit("u0", prompts[0], max_new=3), sched.submit("u1", prompts[1], max_new=3)]
    with pytest.raises(RuntimeError, match="injected device failure"):
        sched.step()
    for r in bad:
        assert r.done and r.error is not None
        with pytest.raises(RuntimeError, match="failed in dispatch"):
            r.result()
    assert not sched._in_flight and not sched._pending
    assert sched.counters["failed"] == 2
    assert len(sched._lb.free_rows()) == sched.max_batch
    ok = sched.submit("u0", prompts[2], max_new=3)
    sched.drain()
    solo = trt.serve(["u0"], prompts[2:3], max_new=3)
    np.testing.assert_array_equal(ok.result(), solo[0].numpy())
    assert sched.counters["completed"] == 1


def test_freed_rows_readmit_in_the_same_step(sessions):
    _, trt = sessions
    sched = S.RequestScheduler(trt, max_batch=1, max_prompt=4, max_new_cap=2, admit_bucket=1,
                               inflight_per_tenant=2, chunk=2)
    prompts = _prompts(2, 4, 13)
    reqs = [sched.submit("u0", p, max_new=2) for p in prompts]
    steps = 0
    while not all(r.done for r in reqs):
        sched.step()
        steps += 1
        assert steps < 20
    assert sched.counters["recycle_waves"] >= 1
    assert sched.counters["completed"] == 2
    for r, p in zip(reqs, prompts):
        np.testing.assert_array_equal(r.result(), trt.serve(["u0"], p[None], max_new=2)[0].numpy())


def test_validation(sessions):
    _, trt = sessions
    sched = S.RequestScheduler(trt, max_batch=2, max_prompt=4, max_new_cap=3)
    with pytest.raises(ValueError, match="prompt length"):
        sched.submit(None, np.zeros((5,), np.int32), max_new=2)
    with pytest.raises(ValueError, match="max_new"):
        sched.submit(None, np.zeros((3,), np.int32), max_new=9)
    with pytest.raises(ValueError, match="mode"):
        S.RequestScheduler(trt, mode="warp")
    with pytest.raises(ValueError, match="admit_bucket"):
        S.RequestScheduler(trt, max_batch=2, admit_bucket=3)
    ing = sched.submit_ingest("u0", np.zeros((1, 8), np.int32), np.zeros((1, 8), np.int32))
    assert not ing.done and list(sched._ingest_queue) == [ing]   # runs at the next step boundary
    sched._ingest_queue.clear()


def test_runtime_front_door_and_what_it_leaves_out(sessions):
    _, trt = sessions
    tp = trt.params
    rt = SessionRuntime(CFG, TSL.SkipLoRAConfig(rank=RANK), tp, max_tenants=2, samples_per_tenant=1, seq=8,
                        device="cpu")
    rt.pool.register("u0", _adapters(10))
    rt.attach_scheduler(max_batch=2, max_prompt=4, max_new_cap=3, chunk=2)
    with pytest.raises(RuntimeError, match="already"):
        rt.attach_scheduler()
    prompt = _prompts(1, 4, 14)[0]
    r = rt.enqueue_serve("u0", prompt, max_new=3)
    assert [d.rid for d in rt.drain()] == [r.rid]
    np.testing.assert_array_equal(r.result(), rt.serve(["u0"], prompt[None], max_new=3)[0].numpy())
    assert rt.counters["serve/grouped/float"] == 1
    base = rt.serve([None], prompt[None], max_new=3)
    assert rt.counters["serve/single/base"] == 1 and rt.counters["serve/tokens"] == 6
    np.testing.assert_array_equal(base[0].numpy(), trt.serve([None], prompt[None], max_new=3)[0].numpy())
    with pytest.raises(ValueError, match="tenants for batch"):
        rt.serve(["u0", None], prompt[None], max_new=3)
    with pytest.raises(ValueError, match="needs kv_pool"):
        rt.prefix_index()
    with pytest.raises(ValueError, match="must size it"):
        rt.kv_pool(block=4)
    pool = rt.kv_pool(block=4, n_blocks=8)
    assert rt.kv_pool() is pool and rt.prefix_index().pool is pool
    with pytest.raises(ValueError, match="block=4"):
        rt.kv_pool(block=8)
    with pytest.raises(ValueError, match="seq"):
        rt.ingest("u0", np.zeros((1, 4), np.int32), np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="no tenants"):
        rt.adapt(epochs=1)
    ing = rt.enqueue_ingest("u0", np.zeros((1, 8), np.int32), np.zeros((1, 8), np.int32))
    assert not ing.done and not rt._tenants       # queued until a step boundary
    rt.drain()
    assert ing.done and ing.logits.shape == (1, 1, CFG.vocab_size) and rt.tenant("u0").n_ingested == 1
    sl = TSL.SkipLoRAConfig(rank=RANK)
    kw0 = dict(max_tenants=2, samples_per_tenant=1, seq=8, device="cpu")
    from repro_torch.runtime.sharding import make_mesh

    model_axis = make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    for kw, err, where in ((dict(mesh=model_axis), ValueError, "use_kernel=False"),
                           (dict(placement_shards=3), ValueError, "divide over 3 shards"),
                           (dict(pipeline_stages=2), ValueError, "must equal the mesh's model-axis size")):
        with pytest.raises(err, match=where):
            SessionRuntime(CFG, sl, tp, **kw0, **kw)
    split = SessionRuntime(CFG, sl, tp, **{**kw0, "device": None}, mesh=model_axis, use_kernel=False)
    assert split.model_parallel == 2 and split.attach_scheduler().predicted_bubble() is None
    fused = SessionRuntime(CFG, sl, tp, **kw0, decode_fuse=True)
    assert fused.decode_fuse and fused.attach_scheduler()._how == (True, True, False)
    with pytest.raises(ValueError, match="params live on"):
        SessionRuntime(CFG, sl, tp, **{**kw0, "device": "meta"})


def test_enqueue_ingest_runs_at_step_boundaries(sessions):
    """The reference's ``test_ingest_runs_at_step_boundaries``: ingest work
    queued between decode dispatches runs at the step's end and lands in
    the tenant's cache partition exactly as a direct ``ingest`` does (same
    logits and cached rows, bitwise), while the serve request's tokens equal
    a solo ``serve``. ``quality_metrics`` has no gate section without a
    control plane."""
    _, trt = sessions
    rng = np.random.default_rng(16)
    tokens, labels = (rng.integers(0, CFG.vocab_size, (2, 8)).astype(np.int32) for _ in range(2))
    prompt = _prompts(1, 4, 17)[0]
    rts = []
    for _ in range(2):
        rt = SessionRuntime(CFG, TSL.SkipLoRAConfig(rank=RANK, cache_dtype="float32"), trt.params,
                            max_tenants=2, samples_per_tenant=4, seq=8, device="cpu")
        rt.pool.register("u0", _adapters(10))
        rts.append(rt)
    queued, direct = rts
    sched = queued.attach_scheduler(max_batch=2, max_prompt=4, max_new_cap=3, chunk=1)
    r = queued.enqueue_serve("u0", prompt, max_new=3)
    ing = queued.enqueue_ingest("u0", tokens, labels)
    assert sched.step() == 1 and ing.done and not r.done      # ingested at the first step's end
    queued.drain()
    assert r.done and sched.counters["ingested"] == 1 and queued.tenant("u0").n_ingested == 2
    want = direct.ingest("u0", tokens, labels)
    assert torch.equal(ing.logits, want) and ing.logits.shape == (2, 1, CFG.vocab_size)
    ids = np.arange(2)
    got, ref = queued.engine.read(ids), direct.engine.read(ids)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    np.testing.assert_array_equal(r.result(), direct.serve(["u0"], prompt[None], max_new=3)[0].numpy())
    assert sched.quality_metrics() == {}


def test_sample_token_per_row_temperatures():
    logits = torch.as_tensor(np.random.default_rng(15).normal(size=(4, 1, 50)).astype(np.float32))
    greedy = torch.argmax(logits, dim=-1)
    assert torch.equal(TL.sample_token(logits, torch.zeros(4)), greedy)
    t = torch.tensor([0.0, 0.8, 0.0, 2.0])
    a = TL.sample_token(logits, t, torch.Generator().manual_seed(3))
    b = TL.sample_token(logits, t, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (4, 1)
    assert torch.equal(a[[0, 2]], greedy[[0, 2]])


def test_serve_cli_scheduler_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--scheduler", "--tenants", "2", "--device", "cpu", "--batch", "3",
                  "--prompt-len", "8", "--gen", "4", "--chunk", "2"])
    text = out.getvalue()
    assert "[scheduler: 2 admit" in text and "generated (3, 4)" in text
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()) as err:
        cli.main(["--scheduler", "--loop", "--device", "cpu"])
    assert "--loop and --scheduler are mutually exclusive" in err.getvalue()


def _sharded_sessions():
    """(reference, port) 2-shard runtimes on one device: u0 on shard 0, u1
    on shard 1."""
    jp = JL.init_lm(jax.random.key(0), CFG)
    tp = C.params_from_reference(jax.tree.map(np.asarray, jp), CFG)
    jrt = JRuntime(CFG, JSL.SkipLoRAConfig(rank=RANK, mode="full", cache_dtype="float32"), jp,
                   max_tenants=2, samples_per_tenant=1, seq=8, placement_shards=2)
    trt = SessionRuntime(CFG, TSL.SkipLoRAConfig(rank=RANK), tp, max_tenants=2, samples_per_tenant=1, seq=8,
                         placement_shards=2, device="cpu")
    for i in range(2):
        jrt.pool.register(f"u{i}", _adapters(10 + i))
        trt.pool.register(f"u{i}", _adapters(10 + i))
    return jrt, trt


def test_multi_shard_routing_matches_solo():
    """Tenants placed on different logical shards decode in their own live
    batches against their own KV pools, solo-bitwise, with the reference's
    tokens and counters (``tests/test_scheduler.py``'s
    ``test_multi_shard_routing_matches_solo``, on the shared-prefix trace
    with reuse on)."""
    jrt, trt = _sharded_sessions()
    assert [trt.pool.shard_of(f"u{i}") for i in range(2)] == [jrt.pool.shard_of(f"u{i}") for i in range(2)] == [0, 1]
    prompts = _shared_prefix(6)
    who = ["u0", "u1", "u1", None, "u0", "u1"]
    got, got_c, sched = _run(S.RequestScheduler, trt, prompts, who, 3, **SHARED)
    want, want_c, _ = _run(JScheduler, jrt, prompts, who, 3, **SHARED)
    assert sorted(sched._batches) == [0, 1] and got_c == want_c and got_c["prefix/hits"] >= 1
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, trt.serve([who[i]], prompts[i][None], max_new=3)[0].numpy())
    pools = sched.prefix_metrics()["pools"]
    assert sorted(pools) == ["0", "1"] and all(p["held"] == p["refs_total"] == p["nodes"] for p in pools.values())
    trt.check_prefix_no_leaks()


def test_kv_pool_blocks_sizes_the_shard_pool_as_the_reference():
    """``kv_pool_blocks`` reaches ``runtime.kv_pool(n_blocks=)``; a pool of 9
    blocks (the heuristic would give 32) gives the reference's tokens and
    counters on the shared-prefix trace, evictions and all."""
    jrt, trt = _sessions(CFG)
    prompts, who = _shared_prefix(6, seed=24), [None, "u0"] * 3
    want, want_c, _ = _run(JScheduler, jrt, prompts, who, 3, kv_pool_blocks=9, **SHARED)
    got, got_c, _ = _run(S.RequestScheduler, trt, prompts, who, 3, kv_pool_blocks=9, **SHARED)
    assert trt.kv_pool(0).n_blocks == jrt.kv_pool(0).n_blocks == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got_c == want_c and got_c["dispatch/admit_reuse"] >= 1
    trt.check_prefix_no_leaks()
    fresh = _sessions(CFG)[1]
    _run(S.RequestScheduler, fresh, prompts[:2], [None] * 2, 3, **SHARED)
    assert fresh.kv_pool(0).n_blocks == 2 * SHARED["max_batch"] * (SHARED["max_prompt"] // SHARED["kv_block"])
