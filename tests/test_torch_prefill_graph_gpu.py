"""The prefills, the session's ingest and the scheduler's admissions as
CUDA-graph replays (``core.prefill_graph``) against their eager paths, on
the card.

Every test here needs a CUDA device and the CUDA toolkit's ``nvcc`` (the
grouped kernels K5, K6 and K7 and the paged gather K10 run inside the
captured calls); without a device they skip. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_prefill_graph_gpu.py

Reduced stablelm-1.6b with seeded weights, bf16 (the tensor-core routes)
and float32. A key's first call runs eagerly, its second captures and
replays, its third replays: each is held bitwise to the eager path, with
float, int8 and int4 pools:

  - the prefill and the grouped prefill: logits and every cache position;
    ``generate`` / ``generate_grouped``: tokens, the generator's state and
    the launches counted (the eager loop's, ``generate_loop``);
  - the session's ingest: logits, the engine rows it wrote, launches;
  - the scheduler's dense, prefix-reuse and mixed waves, greedy and with
    per-row temperatures: tokens, the whole ``counters`` dict and the
    launches counted, against ``RequestScheduler(loop=True)``;
  - a model group on one card and, where two are present, over two cards;
  - the pipelined admission of a runtime built with ``pipeline_stages=2``
    over one card's two members and over two cards: a dense trace, greedy
    and per-row temperatures, the graphed drain against ``loop=True``
    (tokens, counters, launches, the live batch's caches, tokens and
    positions), its ``admit_pipe`` keys captured and replayed;
  - entries dropped between calls (a temporary cache, an evicted entry) and
    a capture that fails (``GraphCaptureError``, no eager fallback)."""

import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import lm_skiplora as SL  # noqa: E402
from repro_torch.core import prefill_graph as PG  # noqa: E402
from repro_torch.core.cuda_graph import GraphCache, GraphCaptureError  # noqa: E402
from repro_torch.core.runtime import SessionRuntime, generate, generate_grouped, generate_loop  # noqa: E402
from repro_torch.core.scheduler import RequestScheduler  # noqa: E402
from repro_torch.kernels.flash_attn import paged as PGK  # noqa: E402
from repro_torch.kernels.skip_lora import kernel as K  # noqa: E402
from repro_torch.launch.serve import _register_demo, demo_pool, demo_runtime  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.runtime.sharding import group_mesh  # noqa: E402

pytestmark = pytest.mark.gpu

POOLS = [None, "int8", "int4"]
ONE_CARD, TWO_CARDS = ["cuda:0", "cuda:0"], ["cuda:0", "cuda:1"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    PG.GRAPHS.clear()
    yield torch.device("cuda")
    PG.GRAPHS.clear()


def _cfg(dtype="bfloat16"):
    return dataclasses.replace(reduce_config(get_config("stablelm-1.6b")), dtype=dtype)


def _params(cfg, cuda):
    return TL.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)


def _prompts(cfg, cuda, seed, shape=(4, 12)):
    return torch.randint(0, cfg.vocab_size, shape, generator=torch.Generator(device=cuda).manual_seed(seed),
                         device=cuda)


def _leaves(tree):
    if isinstance(tree, TP.HeadSplit):
        return list(tree.parts)
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [t for v in tree for t in _leaves(v)]


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _launches():
    return dict(K.LAUNCHES), dict(K.ROW_LAUNCHES), dict(PGK.LAUNCHES)


def _reset():
    torch.cuda.synchronize()
    K.reset_launches()
    PGK.reset_launches()


def _gain(since):
    got = PG.GRAPHS.stats.copy()
    got.subtract(since)
    return got


@pytest.mark.parametrize("kind", ["base", "adapters"] + POOLS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_calls_equal_the_eager_prefill_bitwise(cuda, dtype, kind):
    """First (eager), second (capture + replay) and third (replay) calls of
    one key, each on other prompts: the eager prefill's logits and every
    position of its fresh caches, and its launches."""
    cfg = _cfg(dtype)
    params = _params(cfg, cuda)
    kw = {}
    if kind in POOLS:
        pool = demo_pool(cfg, 3, 8, kind, cuda)
        kw = dict(pools=pool.pools(), idx=pool.lookup([None, "tenant-0", "tenant-1", "tenant-2"]))
    elif kind == "adapters":
        kw = dict(adapters=SL.adapters_to_stack(SL.init_adapters(torch.Generator(device=cuda).manual_seed(4), cfg,
                                                                 SL.SkipLoRAConfig(rank=8))))
    graphs = GraphCache()
    for call, seed in enumerate((3, 5, 7)):
        prompts = _prompts(cfg, cuda, seed)
        _reset()
        logits, caches = PG.prefill(params, cfg, prompts, 20, graphs=graphs, **kw)
        got_launches = _launches()
        _reset()
        fresh = TL.init_serve_caches(cfg, 4, 20, device=cuda)
        if kind in POOLS:
            want, fresh = TL.serve_prefill_grouped(params, cfg, prompts, fresh, kw["pools"], kw["idx"])
        else:
            want, fresh = TL.serve_prefill(params, cfg, prompts, fresh, adapters=kw.get("adapters"))
        assert torch.equal(logits, want), (kind, call)
        assert _same(caches, fresh), (kind, call)
        assert got_launches == _launches(), (kind, call)
    st = graphs.stats
    assert (st["eager_steps"], st["captures"], st["replays"]) == (1, 1, 2)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("compress", POOLS + ["base"])
def test_generate_calls_equal_the_eager_loop_bitwise(cuda, compress, temperature):
    """``generate`` / ``generate_grouped`` three times (the prefill eager,
    then captured, then replayed): ``generate_loop``'s tokens, generator
    state and launches each time."""
    cfg = _cfg()
    params = _params(cfg, cuda)
    prompts = _prompts(cfg, cuda, 3)
    kw = {}
    if compress != "base":
        pool = demo_pool(cfg, 3, 8, compress, cuda)
        kw = dict(pools=pool.pools(), idx=pool.lookup([None, "tenant-0", "tenant-1", "tenant-2"]))
    _reset()
    g = torch.Generator(device=cuda).manual_seed(11)
    want = generate_loop(params, cfg, prompts, max_new=6, temperature=temperature, generator=g, device=cuda, **kw)
    want_state, want_launches = g.get_state(), _launches()
    since = PG.GRAPHS.stats.copy()
    for _ in range(3):
        _reset()
        g = torch.Generator(device=cuda).manual_seed(11)
        if kw:
            got = generate_grouped(params, cfg, prompts, kw["pools"], kw["idx"], max_new=6, temperature=temperature,
                                   generator=g, unroll=2, device=cuda)
        else:
            got = generate(params, cfg, prompts, max_new=6, temperature=temperature, generator=g, unroll=2,
                           device=cuda)
        assert torch.equal(got, want) and torch.equal(g.get_state(), want_state)
        assert _launches() == want_launches
    gain = _gain(since)
    assert (gain["eager_steps"], gain["captures"], gain["replays"]) == (1, 1, 2)


@pytest.mark.parametrize("mode", ["full", "int8"])
@pytest.mark.parametrize("compress", POOLS)
def test_ingest_calls_equal_the_eager_ingest_bitwise(cuda, compress, mode):
    """Three ingests of one shape into a session (eager, captured, replayed):
    each the eager forward's logits and rows (read back from the engine),
    and its launches."""
    cfg = _cfg()
    params = _params(cfg, cuda)
    sl = SL.SkipLoRAConfig(rank=8, mode=mode)
    rt = SessionRuntime(cfg, sl, params, max_tenants=2, samples_per_tenant=6, seq=8, pool_compress=compress,
                        device=cuda)
    rt.pool.register("u", SL.init_adapters(torch.Generator(device=cuda).manual_seed(2), cfg, sl))
    rng = np.random.default_rng(4)
    since = PG.GRAPHS.stats.copy()
    for call in range(3):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)), device=cuda)
        labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)), device=cuda)
        _reset()
        logits = rt.ingest("u", tokens, labels)
        got_launches = _launches()
        _reset()
        idx = rt.pool.lookup(["u", "u"])
        want, acts, y_base = TL.ingest_prefill(params, cfg, tokens, rt.pool.pools(), idx)
        assert torch.equal(logits, want) and got_launches == _launches(), call
        ids = [2 * call, 2 * call + 1]
        rows = rt.engines[0].read(ids)
        values = SL._encode_acts(acts, None, sl)
        decoded = rt.engines[0]._decode(rt.engines[0]._encode(values | {"y_base": y_base, "labels": labels}))
        assert all(torch.equal(rows[k], decoded[k].to(rows[k].dtype)) for k in rows), call
    gain = _gain(since)
    assert (gain["eager_steps"], gain["captures"], gain["replays"]) == (1, 1, 2)


def _trace(cfg, wave):
    """Prompts of the three wave kinds: ``dense`` (nothing shared),
    ``reuse`` (one 12-token prefix, 4-token tails), ``mixed`` (both, so
    waves split at the kind flips)."""
    rng = np.random.default_rng(13)
    shared = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)

    def fresh():
        return rng.integers(0, cfg.vocab_size, 16).astype(np.int32)

    def sharing():
        return np.concatenate([shared, rng.integers(0, cfg.vocab_size, 4).astype(np.int32)])

    if wave == "dense":
        return [fresh() for _ in range(8)]
    if wave == "reuse":
        return [sharing() for _ in range(8)]
    return [sharing() if i % 3 else fresh() for i in range(9)]


def _scheduled(cfg, params, cuda, compress, prompts, temps, loop, devices=None):
    if devices is None:
        rt = demo_runtime(cfg, 2, 8, compress, params, cuda)
    else:   # a group's session (use_kernel=False); tenants without a slot ride the zero slot
        rt = SessionRuntime(cfg, SL.SkipLoRAConfig(rank=4), params, max_tenants=2, samples_per_tenant=1, seq=8,
                            use_kernel=False, mesh=group_mesh(devices), seed=0)
    who = [f"tenant-{i % 2}" for i in range(len(prompts))]
    sched = RequestScheduler(rt, max_batch=4, max_prompt=16, max_new_cap=5, admit_bucket=2, inflight_per_tenant=8,
                             chunk=2, kv_block=4, loop=loop)
    reqs = [sched.submit(t, p, max_new=5, temperature=0.7 * (i % 2) if temps == "rows" else 0.0)
            for i, (t, p) in enumerate(zip(who, prompts))]
    _reset()
    sched.drain()
    return [r.result().tolist() for r in reqs], dict(sched.counters), _launches()


@pytest.mark.parametrize("temps", ["greedy", "rows"])
@pytest.mark.parametrize("wave", ["dense", "reuse", "mixed"])
@pytest.mark.parametrize("compress", POOLS)
def test_scheduler_admissions_replay_the_eager_admissions_bitwise(cuda, compress, wave, temps):
    """A scheduler run whose admissions replay graphs (each key eager, then
    captured, then replayed) against ``loop=True``: tokens, the whole
    counters dict and every launch counter, bitwise."""
    cfg = _cfg()
    params = _params(cfg, cuda)
    prompts = _trace(cfg, wave)
    since = PG.GRAPHS.stats.copy()
    got = _scheduled(cfg, params, cuda, compress, prompts, temps, False)
    gain = _gain(since)
    want = _scheduled(cfg, params, cuda, compress, prompts, temps, True)
    assert got == want
    counters = got[1]
    if wave != "dense":
        assert counters["dispatch/admit_reuse"] >= 1
    if wave == "mixed":
        assert counters["prefix/wave_split"] >= 1
    assert gain["captures"] >= 1 and gain["replays"] >= 1
    assert _gain(since)["captures"] == gain["captures"]       # loop=True captured nothing


@pytest.mark.parametrize("cards", [1, 2], ids=["one_card", "two_cards"])
def test_group_prefill_and_admissions_replay_bitwise(cuda, cards):
    """A backbone split over a model group (one card's two members, or two
    cards): ``generate_grouped``'s three calls against its eager loop, and a
    scheduler run with reuse against ``loop=True``."""
    if cards == 2 and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    devices = ONE_CARD if cards == 1 else TWO_CARDS
    cfg = _cfg("float32")
    params = _params(cfg, cuda)
    gp = TP.group_params(params, devices)
    prompts = _prompts(cfg, cuda, 3)
    pool = demo_pool(cfg, 3, 8, None, cuda)
    kw = dict(pools=pool.pools(), idx=pool.lookup([None, "tenant-0", "tenant-1", "tenant-2"]), use_kernel=False)
    want = generate_loop(gp, cfg, prompts, max_new=5, device=cuda, **kw)
    since = PG.GRAPHS.stats.copy()
    for _ in range(3):
        assert torch.equal(generate_grouped(gp, cfg, prompts, kw["pools"], kw["idx"], max_new=5,
                                            use_kernel=False, device=cuda), want)
    gain = _gain(since)
    assert (gain["eager_steps"], gain["captures"], gain["replays"]) == (1, 1, 2)
    trace = _trace(cfg, "mixed")
    got = _scheduled(cfg, params, cuda, None, trace, "rows", False, devices)
    assert got == _scheduled(cfg, params, cuda, None, trace, "rows", True, devices)
    assert got[1]["dispatch/admit_reuse"] >= 1


def _pipelined(cfg, params, devices, prompts, temps, loop):
    """A dense trace through the scheduler of a session built with
    ``pipeline_stages=2`` over ``devices`` (the demo tenants, rank 8, float
    pool): tokens, counters, launches, and the live batch after the drain
    (caches, tokens, positions)."""
    rt = SessionRuntime(cfg, SL.SkipLoRAConfig(rank=8), params, max_tenants=2, samples_per_tenant=1, seq=8,
                        use_kernel=False, mesh=group_mesh(devices), pipeline_stages=2, seed=0)
    _register_demo(rt.pool, cfg, 2, 8, devices[0])
    sched = RequestScheduler(rt, max_batch=4, max_prompt=16, max_new_cap=5, admit_bucket=2, inflight_per_tenant=8,
                             chunk=2, loop=loop)
    reqs = [sched.submit(f"tenant-{i % 3}" if i % 3 < 2 else None, p, max_new=5,
                         temperature=0.7 * (i % 2) if temps == "rows" else 0.0) for i, p in enumerate(prompts)]
    _reset()
    sched.drain()
    lb = sched._lb
    return ([r.result().tolist() for r in reqs], dict(sched.counters), _launches()), (lb.caches, lb.tok, lb.pos)


@pytest.mark.parametrize("temps", ["greedy", "rows"])
@pytest.mark.parametrize("cards", [1, 2], ids=["one_card", "two_cards"])
def test_pipelined_admissions_replay_bitwise(cuda, cards, temps):
    """The scheduler of a runtime built with ``pipeline_stages=2``, over one
    card's two members or over two cards: its admissions replay graphs of
    the GPipe ticks (``admit_pipe`` keys: eager first call, capture,
    replays), bitwise the ``loop=True`` drain: tokens, counters, launches,
    and the live batch's caches, tokens and positions; ``loop=True``
    captures nothing."""
    if cards == 2 and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    devices = ONE_CARD if cards == 1 else TWO_CARDS
    cfg = _cfg()
    params = _params(cfg, cuda)
    prompts = _trace(cfg, "dense")
    since = PG.GRAPHS.stats.copy()
    got, got_live = _pipelined(cfg, params, devices, prompts, temps, False)
    gain = _gain(since)
    keys = {k[0] for k in PG.GRAPHS._entries}
    want, want_live = _pipelined(cfg, params, devices, prompts, temps, True)
    assert got == want and got[1]["dispatch/admit_pipe"] >= 3 and "dispatch/admit" not in got[1]
    assert _same(got_live, want_live)
    assert keys == {"admit_pipe"} and gain["captures"] >= 1 and gain["replays"] >= 1
    assert gain["eager_steps"] + gain["replays"] == got[1]["dispatch/admit_pipe"]
    assert _gain(since)["captures"] == gain["captures"]       # loop=True captured nothing


def test_dropping_an_entry_between_calls_is_safe(cuda):
    """Entries dropped as soon as their call returns (a temporary cache),
    evicted between calls (a cache of one) and cleared mid-run: every call
    bitwise the eager path."""
    cfg = _cfg()
    params = _params(cfg, cuda)
    pool = demo_pool(cfg, 3, 8, None, cuda)
    idx = pool.lookup([None, "tenant-0", "tenant-1", "tenant-2"])
    prompts = [_prompts(cfg, cuda, s) for s in (3, 4)]
    want = [TL.serve_prefill_grouped(params, cfg, p, TL.init_serve_caches(cfg, 4, 20, device=cuda), pool.pools(),
                                     idx)[0] for p in prompts]
    for _ in range(3):
        logits, _ = PG.prefill(params, cfg, prompts[0], 20, pools=pool.pools(), idx=idx, graphs=GraphCache())
        assert torch.equal(logits, want[0])
    one = GraphCache(capacity=1)
    for i in range(6):      # two keys (cache lengths) in turn: every call evicts the other's entry
        logits, _ = PG.prefill(params, cfg, prompts[i % 2], 20 + i % 2, pools=pool.pools(), idx=idx, graphs=one)
        assert torch.equal(logits, want[i % 2])
    assert one.stats["evictions"] == 5
    loop = generate_loop(params, cfg, prompts[1], pools=pool.pools(), idx=idx, max_new=4, device=cuda)
    for _ in range(3):
        assert torch.equal(generate_grouped(params, cfg, prompts[1], pool.pools(), idx, max_new=4, device=cuda), loop)
        PG.GRAPHS.clear()
        gc.collect()
    trace = _trace(cfg, "reuse")
    want_run = _scheduled(cfg, params, cuda, None, trace, "greedy", True)
    real = PG.admit_reuse

    def clearing(*a, **kw):
        out = real(*a, **kw)
        PG.GRAPHS.clear()
        return out

    PG.admit_reuse = clearing
    try:
        assert _scheduled(cfg, params, cuda, None, trace, "greedy", False) == want_run
    finally:
        PG.admit_reuse = real


def test_a_failed_capture_raises_and_falls_back_to_nothing(cuda, monkeypatch):
    """A kernel that refuses to launch inside a capture: the key's first
    call (eager) runs, the second raises ``GraphCaptureError`` naming the
    call, and no eager call stands in for it."""
    cfg = _cfg()
    params = _params(cfg, cuda)
    pool = demo_pool(cfg, 3, 8, None, cuda)
    idx = pool.lookup([None, "tenant-0", "tenant-1", "tenant-2"])
    prompts = _prompts(cfg, cuda, 3)
    real = K.LIB.launch

    def launch(name, x, *args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: refused inside a capture")
        real(name, x, *args)

    monkeypatch.setattr(K.LIB, "launch", launch)
    graphs = GraphCache()
    _reset()
    PG.prefill(params, cfg, prompts, 20, pools=pool.pools(), idx=idx, graphs=graphs)
    with pytest.raises(GraphCaptureError, match="grouped prefill.*refused inside a capture"):
        PG.prefill(params, cfg, prompts, 20, pools=pool.pools(), idx=idx, graphs=graphs)
    assert K.LAUNCHES["grouped_skip_sum_fwd"] == 1 and graphs.stats["replays"] == 0
