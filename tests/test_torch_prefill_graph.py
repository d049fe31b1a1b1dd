"""The graphs of the prefills, the session's ingest and the scheduler's
admissions (``core.prefill_graph``) on the CPU, where nothing is captured:
what keys an entry, which cache holds it, and what its body computes.

The replays themselves are held on the card by
``tests/test_torch_prefill_graph_gpu.py``; the five calls' parity with the
reference on the CPU by the parity tests of ``test_torch_decode_graph.py``
(``generate``, ``generate_grouped``), ``test_torch_runtime.py`` (``serve``,
``ingest``) and ``test_torch_scheduler.py`` (both admissions), each of
which also checks that the CPU captured nothing.

  - each entry's key holds the storage of what its graph reads or writes in
    place: two states of equal shapes give two keys; an admission's key
    follows the number of admitted rows, their temperature kind, a reuse
    admission's tail bucket and table width, and a pipelined admission's
    ``n_micro``, stage split storage, ``valid`` mask and stage devices;
  - the entries live in a ``GraphCache`` of their own, not
    ``decode_graph.GRAPHS``, and a CPU serve, ingest and scheduler run (a
    pipelined one too, its ``dispatch/admit_pipe`` counted) make no entry
    in either;
  - an entry's body, run twice over its own buffers (the second time over
    what the first left), gives the eager call's outputs bitwise: logits and
    every cache position of a prefill (a recurrent stack's non-zero initial
    states included, a model group's split caches too), an ingest's logits,
    ``y_base`` and encoded rows, an admission's first tokens (dense,
    prefix-reuse, over a group, and pipelined: 2 stages on ``["cpu",
    "cpu"]``, 2 microbatches), the live batch's caches, tokens and
    positions, and the generator's state.

Reduced float32 configs of the port's own, seeded; one intra-op thread."""

import dataclasses
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import decode_graph as DG  # noqa: E402
from repro_torch.core import lm_skiplora as SL  # noqa: E402
from repro_torch.core import prefill_graph as PG  # noqa: E402
from repro_torch.core import scheduler as S  # noqa: E402
from repro_torch.core.cuda_graph import GraphCache  # noqa: E402
from repro_torch.core.runtime import SessionRuntime, generate, generate_grouped  # noqa: E402
from repro_torch.launch.serve import demo_pool, demo_runtime  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.runtime.sharding import group_mesh  # noqa: E402

RANK = 4
CFG = reduce_config(get_config("stablelm-1.6b"))
XLSTM = dataclasses.replace(reduce_config(get_config("xlstm-350m"), n_periods=1), vocab_size=64)
GROUP = ["cpu", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS: dict = {}


def _model(name):
    """(cfg, params) drawn once a module: stablelm, xlstm (recurrent states,
    sLSTM's starting at one), stablelm split over ``GROUP``."""
    if name not in _MODELS:
        cfg = XLSTM if name == "xlstm" else CFG
        params = TL.init_lm(torch.Generator().manual_seed(0), cfg)
        if name == "group":
            params = TP.group_params(params, GROUP)
        _MODELS[name] = cfg, params
    return _MODELS[name]


def _pool(cfg, compress=None):
    return demo_pool(cfg, 3, RANK, compress, "cpu")


def _tokens(cfg, seed, shape=(3, 6)):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int64))


def _leaves(tree):
    """Every tensor of a cache tree (split caches by part)."""
    if isinstance(tree, TP.HeadSplit):
        return list(tree.parts)
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [t for v in tree for t in _leaves(v)]


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def _live(cfg, params, batch=4, seq=12):
    return (TL.init_stacked_caches(cfg, batch, seq, device="cpu", params=params),
            torch.zeros((batch, 1), dtype=torch.long), torch.zeros((batch,), dtype=torch.long))


def _dense_args(a=2, p=6, k=2):
    return dict(new_tokens=torch.zeros((a, p), dtype=torch.int32), new_lens=torch.ones((a,), dtype=torch.int32),
                new_idx=torch.zeros((a,), dtype=torch.int32), rows=torch.arange(k))


def _reuse_args(a=2, pt=4, max_nb=2, k=2):
    return dict(tables=torch.zeros((a, max_nb), dtype=torch.int32), tail_tokens=torch.zeros((a, pt), dtype=torch.int32),
                tail_lens=torch.ones((a,), dtype=torch.int32), prefix_lens=torch.zeros((a,), dtype=torch.int32),
                new_idx=torch.zeros((a,), dtype=torch.int32), rows=torch.arange(k))


def _kv_data(cfg, n_blocks=4, block=2):
    shape = (cfg.n_layers, n_blocks, block, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {n: torch.zeros(shape, dtype=torch.bfloat16) for n in ("k", "v")}


def _clone_tree(tree):
    return [{k: v.clone() for k, v in layer.items()} for layer in tree]


@pytest.mark.parametrize("kind", ["prefill", "grouped prefill", "ingest", "admit", "admit_reuse"])
def test_each_key_holds_the_storage_of_what_its_graph_touches(kind):
    """Two states of equal shapes and different storage give two keys, so
    neither caller's tensors are read through the other's graph; the same
    tensors give one key."""
    cfg, params = _model("stablelm")
    twin = TL.init_lm(torch.Generator().manual_seed(0), cfg)      # equal shapes, other storage
    pool = _pool(cfg)
    tok = _tokens(cfg, 1)
    idx = pool.lookup([None, "tenant-0", "tenant-1"])
    sl = SL.SkipLoRAConfig(rank=RANK)
    if kind in ("prefill", "grouped prefill"):
        if kind == "grouped prefill":
            kw, other = dict(pools=pool.pools(), idx=idx), dict(pools=_pool(cfg).pools(), idx=idx)
        else:
            adapters = SL.adapters_to_stack(SL.init_adapters(torch.Generator().manual_seed(2), cfg, sl))
            kw, other = dict(adapters=adapters), dict(adapters=_clone_tree(adapters))

        def key(p, kwargs=kw):
            return PG.prefill_key(p, cfg, tok, 11, **kwargs)

        others = [key(twin), key(params, other)]
        assert key(params) != PG.prefill_key(params, cfg, tok, 12, **kw)         # another cache length
    elif kind == "ingest":
        key = lambda p, pools=pool.pools(): PG.ingest_key(p, cfg, sl, tok, pools, idx)  # noqa: E731
        others = [key(twin), key(params, _pool(cfg).pools())]
        assert key(params) != PG.ingest_key(params, cfg, SL.SkipLoRAConfig(rank=RANK, mode="int8"), tok,
                                            pool.pools(), idx)
    else:
        live = _live(cfg, params)
        args = _dense_args() if kind == "admit" else _reuse_args()
        data = _kv_data(cfg) if kind == "admit_reuse" else None

        def key(p=params, caches=live[0], tk=live[1], pos=live[2], pool_data=data):
            return PG.admit_key(p, cfg, True, pool.pools(), args, 0.0, caches, tk, pos, prompt=6,
                                pool_data=pool_data)

        other_live = _live(cfg, params)
        others = [key(twin), key(caches=other_live[0]), key(tk=other_live[1]), key(pos=other_live[2])]
        if kind == "admit_reuse":
            others.append(key(pool_data=_kv_data(cfg)))
    assert key(params) == key(params)
    assert len({key(params), *others}) == 1 + len(others)


def _pipe(params, cfg, n_micro=2, devices=GROUP, valid=None):
    """A pipelined admission's ``pipe``: 2 stages of ``params``' layers."""
    stages, mask = TL.pipeline_stage_params(params, cfg, 2)
    return stages, mask if valid is None else valid, devices, n_micro


PIPE_KEYS = ["n_micro", "stage storage", "valid", "stage devices"]


@pytest.mark.parametrize("what", ["k", "temperature kind", "tail bucket", "table width"] + PIPE_KEYS)
def test_admission_key_follows_rows_temperature_kind_tail_bucket_and_table_width(what):
    cfg, params = _model("stablelm")
    pool = _pool(cfg)
    caches, tok, pos = _live(cfg, params)
    data = _kv_data(cfg)

    def key(temps=0.0, pipe=None, **over):
        reuse = what in ("tail bucket", "table width")
        args = _reuse_args(**over) if reuse else _dense_args(**over)
        return PG.admit_key(params, cfg, True, pool.pools(), args, temps, caches, tok, pos, prompt=6,
                            pool_data=data if reuse else None, pipe=pipe)

    if what in PIPE_KEYS:
        pipe = _pipe(params, cfg)
        base = key(pipe=pipe)
        assert base != key() and base == key(pipe=_pipe(params, cfg))     # a dense admission's key is another
        if what == "n_micro":
            other = _pipe(params, cfg, n_micro=1)
        elif what == "stage storage":
            other = _pipe(TL.init_lm(torch.Generator().manual_seed(0), cfg), cfg)   # equal values, other storage
        elif what == "valid":
            other = _pipe(params, cfg, valid=torch.tensor([[True], [False]]))
        else:
            other = _pipe(params, cfg, devices=["cpu", "meta"])
        assert key(pipe=other) != base
        return
    base = key()
    if what == "k":
        assert key(k=1) != base and key(k=2) == base
    elif what == "temperature kind":
        rows = key(torch.tensor([0.0, 0.7]))
        assert rows != base and rows == key(torch.tensor([0.9, 0.0]))     # values are copied in, not keyed
    elif what == "tail bucket":
        assert key(pt=2) != base and key(pt=4) == base
    else:
        assert key(max_nb=3) != base and key(max_nb=2) == base
    # a dense and a reuse admission of the same rows never share an entry
    assert PG.admit_key(params, cfg, True, pool.pools(), _dense_args(), 0.0, caches, tok, pos, prompt=6) != \
        PG.admit_key(params, cfg, True, pool.pools(), _dense_args(), 0.0, caches, tok, pos, prompt=6,
                     pool_data=data)


def test_prefill_graphs_are_a_cache_of_their_own_and_the_cpu_captures_nothing():
    """``prefill_graph.GRAPHS`` is a ``GraphCache`` apart from the decode's
    (an LRU of ``CAPACITY``); a CPU serve (base and grouped), ingest and
    scheduler run with prefix reuse make no entry in either cache."""
    assert isinstance(PG.GRAPHS, GraphCache) and PG.GRAPHS is not DG.GRAPHS
    assert PG.GRAPHS.capacity == PG.CAPACITY >= 8 and DG.GRAPHS.capacity == 4
    cfg, params = _model("stablelm")
    before = (PG.GRAPHS.stats.copy(), len(PG.GRAPHS), DG.GRAPHS.stats.copy(), len(DG.GRAPHS))
    rt = demo_runtime(cfg, 2, RANK, None, params, "cpu")
    tok = _tokens(cfg, 3, (2, 8))
    rt.serve([None, None], tok, max_new=3)
    rt.serve(["tenant-0", None], tok, max_new=3)
    rt.ingest("tenant-1", tok[:1], tok[:1])
    sched = S.RequestScheduler(rt, max_batch=2, max_prompt=8, max_new_cap=3, admit_bucket=2, chunk=2, kv_block=2)
    for p in (tok[0].numpy(), tok[1].numpy(), tok[0].numpy()):
        sched.submit("tenant-0", p, max_new=3)
    sched.drain()
    assert sched.counters["dispatch/admit"] >= 1 and sched.counters["dispatch/admit_reuse"] >= 1
    # a pipelined scheduler: 2 stages over a group of the CPU, its admissions eager and counted
    prt = SessionRuntime(cfg, SL.SkipLoRAConfig(rank=RANK), params, max_tenants=2, samples_per_tenant=1, seq=8,
                         use_kernel=False, mesh=group_mesh(GROUP), pipeline_stages=2, seed=0)
    pipe = S.RequestScheduler(prt, max_batch=2, max_prompt=8, max_new_cap=3, admit_bucket=2, chunk=2)
    for p in (tok[0].numpy(), tok[1].numpy(), tok[0].numpy()):
        pipe.submit(None, p, max_new=3)
    pipe.drain()
    assert pipe.counters["dispatch/admit_pipe"] >= 2 and pipe.counters["dispatch/admit"] == 0
    assert (PG.GRAPHS.stats, len(PG.GRAPHS), DG.GRAPHS.stats, len(DG.GRAPHS)) == before


# ---------------------------------------------------------------------------
# Entry bodies against the eager calls
# ---------------------------------------------------------------------------


def _eager_prefill(cfg, params, tokens, max_seq, pools=None, idx=None, adapters=None):
    caches = TL.init_serve_caches(cfg, tokens.shape[0], max_seq, device="cpu", params=params)
    if pools is None:
        return TL.serve_prefill(params, cfg, tokens, caches, adapters=adapters)
    return TL.serve_prefill_grouped(params, cfg, tokens, caches, pools, idx)


@pytest.mark.parametrize("case", ["base", "adapters", "grouped", "xlstm", "group"])
def test_prefill_body_twice_equals_the_eager_prefill(case):
    """The prefill entry's body over its own buffers, twice (the second over
    the caches the first filled): each time the eager prefill's logits and
    every position of its fresh caches, bitwise. xlstm's sLSTM states start
    at one and its caches hold recurrent states; the group's are split."""
    cfg, params = _model("xlstm" if case == "xlstm" else "group" if case == "group" else "stablelm")
    pool = _pool(cfg)
    kw = {}
    if case in ("grouped", "xlstm", "group"):
        kw = dict(pools=pool.pools(), idx=pool.lookup(["tenant-2", None, "tenant-0"]))
    elif case == "adapters":
        kw = dict(adapters=SL.adapters_to_stack(SL.init_adapters(torch.Generator().manual_seed(2), cfg,
                                                                 SL.SkipLoRAConfig(rank=RANK))))
    first = _tokens(cfg, 4)
    e = PG._Prefill(Counter(), cfg, first, 10, params=params, pools=kw.get("pools"), idx=kw.get("idx"),
                    use_kernel=True, devices=TP.run_devices(params, first))
    if case == "xlstm":
        assert any(f is not None for layer in e.fresh for f in layer.values())     # sLSTM's n starts at one
    for seed in (4, 5):
        tokens = _tokens(cfg, seed)
        e.tokens.copy_(tokens)
        if e.idx is not None:
            e.idx.copy_(kw["idx"])
        e.live = (params, kw.get("adapters"), kw.get("pools"))
        e.body(1, None)
        want_logits, want_caches = _eager_prefill(cfg, params, tokens, 10, **kw)
        assert torch.equal(e.out["logits"], want_logits)
        assert _same(e.caches, want_caches)


@pytest.mark.parametrize("mode", ["full", "int8"])
def test_ingest_body_twice_equals_the_eager_ingest(mode):
    cfg, params = _model("stablelm")
    pool = _pool(cfg, "int8")
    sl = SL.SkipLoRAConfig(rank=RANK, mode=mode)
    idx = pool.lookup(["tenant-1", "tenant-1"])
    e = PG._Ingest(Counter(), cfg, sl, _tokens(cfg, 6, (2, 8)), pools=pool.pools(), idx=idx, use_kernel=True,
                   devices=["cpu"])
    for seed in (6, 7):
        tokens = _tokens(cfg, seed, (2, 8))
        e.tokens.copy_(tokens)
        e.idx.copy_(idx)
        e.live = (params, pool.pools())
        e.body(1, None)
        logits, acts, y_base = TL.ingest_prefill(params, cfg, tokens, pool.pools(), idx)
        want = SL._encode_acts(acts, None, sl)
        assert torch.equal(e.out["logits"], logits) and torch.equal(e.out["y_base"], y_base)
        assert sorted(e.out) == sorted(want.keys() | {"logits", "y_base"})
        assert all(torch.equal(e.out[k], v) for k, v in want.items())


def _filled_live(cfg, params, seed, batch=4, seq=12):
    """A live batch mid-run: caches, tokens and positions drawn from a seed."""
    g = torch.Generator().manual_seed(seed)
    caches, tok, pos = _live(cfg, params, batch, seq)
    for t in _leaves(caches):
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    tok.copy_(torch.randint(0, cfg.vocab_size, tok.shape, generator=g))
    pos.copy_(torch.randint(0, seq, pos.shape, generator=g))
    return caches, tok, pos


def _copy_live(live):
    caches, tok, pos = live
    return ({n: TP.zeros_like(t) for n, t in caches.items()}, tok.clone(), pos.clone())


def _load_live(dst, src):
    for n in dst[0]:
        dst[0][n].copy_(src[0][n])
    dst[1].copy_(src[1])
    dst[2].copy_(src[2])


@pytest.mark.parametrize("temps", ["greedy", "rows"])
@pytest.mark.parametrize("kind", ["dense", "reuse", "group dense", "pipe"])
def test_admission_body_twice_equals_the_eager_admission(kind, temps):
    """An admission entry's body (prefill into its zeroed caches, the first
    tokens drawn, the scatter of ``k`` rows), twice over two live batches,
    each into the same buffers: the eager admission's first tokens, live
    caches, tokens, positions and generator state, bitwise. ``pipe``: the
    pipelined admission of a runtime built with ``pipeline_stages=2`` over
    ``GROUP`` (the live batch split by heads, the stages' layers and the
    admission caches whole, 2 microbatches of one row)."""
    cfg, params = _model("group" if kind in ("group dense", "pipe") else "stablelm")
    pipe = _pipe(_model("stablelm")[1], cfg) if kind == "pipe" else None
    pool = _pool(cfg)
    rng = np.random.default_rng(8)
    a, p, blk = 2, 6, 2
    adm_temps = 0.0 if temps == "greedy" else torch.tensor([0.8, 0.0])
    new_idx = pool.lookup(["tenant-0", "tenant-2"])
    rows = torch.tensor([3, 1])
    if kind == "reuse":
        data = {n: torch.randn((cfg.n_layers, 4, blk, cfg.n_kv_heads, cfg.resolved_head_dim),
                               generator=torch.Generator().manual_seed(9)).to(torch.bfloat16) for n in ("k", "v")}
        args = dict(tables=torch.tensor([[2, 0], [1, 3]], dtype=torch.int32),
                    tail_tokens=torch.as_tensor(rng.integers(0, cfg.vocab_size, (a, 2)).astype(np.int32)),
                    tail_lens=torch.tensor([2, 1], dtype=torch.int32), prefix_lens=torch.tensor([4, 2], dtype=torch.int32),
                    new_idx=new_idx, rows=rows)
    else:
        data = None
        args = dict(new_tokens=torch.as_tensor(rng.integers(0, cfg.vocab_size, (a, p)).astype(np.int32)),
                    new_lens=torch.tensor([6, 4], dtype=torch.int32), new_idx=new_idx, rows=rows)
    e = PG._Admit(Counter(), cfg, pipe is None, args, adm_temps, p, params=params, pools=pool.pools(),
                  reuse=kind == "reuse", devices=["cpu"], pipe=pipe)
    mine = _copy_live(_live(cfg, params))
    for seed in (10, 11):
        live = _filled_live(cfg, params, seed)
        _load_live(mine, live)
        theirs = _copy_live(live)
        _load_live(theirs, live)
        for n, t in args.items():
            e.args[n].copy_(t)
        if isinstance(adm_temps, torch.Tensor):
            e.temps.copy_(adm_temps)
        g_mine, g_theirs = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        e.live = (params, pool.pools(), data, *mine)
        e.body(1, g_mine)
        adm = TL.init_stacked_caches(cfg, a, p, device="cpu", params=None if pipe else params)
        if kind == "pipe":
            want = S._pipe_admission(params, cfg, pipe, pool.pools(), args["new_tokens"], args["new_lens"], new_idx,
                                     rows, *theirs, adm_temps, g_theirs, adm)
        elif kind == "reuse":
            want = S._reuse_admission(params, cfg, True, pool.pools(), data, args["tables"], args["tail_tokens"],
                                      args["tail_lens"], args["prefix_lens"], new_idx, rows, *theirs, adm_temps,
                                      g_theirs, adm)
        else:
            want = S._dense_admission(params, cfg, True, pool.pools(), args["new_tokens"], args["new_lens"], new_idx,
                                      rows, *theirs, adm_temps, g_theirs, adm)
        assert torch.equal(e.out["tok0"], want)
        assert _same(mine[0], theirs[0]) and torch.equal(mine[1], theirs[1]) and torch.equal(mine[2], theirs[2])
        assert torch.equal(g_mine.get_state(), g_theirs.get_state())
        # the admitted rows moved, the others kept their state
        assert not torch.equal(mine[2], live[2]) and torch.equal(mine[2][[0, 2]], live[2][[0, 2]])


def test_generate_on_the_cpu_runs_the_eager_prefill():
    """On CPU tensors ``generate`` / ``generate_grouped`` take the eager
    prefill: their tokens are those of the prefill and decode run by hand."""
    cfg, params = _model("stablelm")
    pool = _pool(cfg)
    tokens = _tokens(cfg, 12)
    idx = pool.lookup([None, "tenant-1", "tenant-0"])
    for kw in ({}, dict(pools=pool.pools(), idx=idx)):
        logits, caches = _eager_prefill(cfg, params, tokens, tokens.shape[1] + 4, **kw)
        want, _ = TL.decode_scan(params, cfg, TL.sample_token(logits, 0.0), tokens.shape[1], caches, max_new=4,
                                 **kw)
        got = (generate_grouped(params, cfg, tokens, kw["pools"], idx, max_new=4, device="cpu") if kw
               else generate(params, cfg, tokens, max_new=4, device="cpu"))
        assert torch.equal(got, want)
