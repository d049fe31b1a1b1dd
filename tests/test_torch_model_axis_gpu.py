"""The model axis on the card: a backbone split over a group of CUDA
devices (``models.tp``) and the 2-D session.

Every test needs a CUDA device; without one they skip, and the two-card
tests skip below two cards. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_model_axis_gpu.py

A small float32 attention stack (4 layers, d 16, 4 heads over 2 KV heads,
vocab 64) and reduced qwen2-moe-a2.7b (float32, vocab 512), seeded
weights. The session takes ``use_kernel=False``, as a model axis must.

  - one card: the group ``[cuda:0, cuda:0]`` (``tp.group_params``, the
    one-card form ``make_mesh`` refuses) against the unsplit backbone on
    the same card: train forward, serve prefill and a decode step (the
    caches split by heads) within 1e-4 of the largest value, greedy tokens
    equal;
  - graphs (``cuda_graph.capturable``), each on one card (the group
    ``[cuda:0, cuda:0]``) and on two (``[cuda:0, cuda:1]``, one capture
    reaching both cards; skipped below two): ``lm.decode_scan`` replays
    bitwise ``lm.decode_loop`` (tokens and caches) for reduced
    qwen2-moe-a2.7b (KV heads split), paligemma-3b (one KV head: caches
    split by sequence) and xlstm-350m (recurrent states split), greedy and
    sampled; the scheduler's chunks bitwise ``loop=True``; the populate,
    cached and three fleet epochs and a session's adapt (with and without a
    control plane) bitwise their ``loop=True`` loops; captures and replays
    counted in ``decode_graph.GRAPHS.stats`` / ``GraphCache.stats``;
  - two cards: a (1 data x 2 model) session over ``[cuda:0, cuda:1]`` (built
    through ``make_mesh``), with ``pipeline_stages=2`` and without, against
    the same session over ``["cpu", "cpu"]``: adapters within rtol 1e-4 /
    atol 1e-6 (the CPU tests' bar), slot tables and serve and scheduler
    tokens equal; a group over ``[cuda:0, cuda:1]`` decodes and trains as
    graph replays bitwise its eager steps; after a two-card capture the
    member card's free memory filled with NaN through new allocations, the
    replays stay bitwise and write none of it, and dropping the graphs
    gives the member card's pool back; entries dropped while their replays
    are in flight fault nothing; a failed two-card capture raises
    ``GraphCaptureError`` and leaves both cards usable."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import decode_graph as DG  # noqa: E402
from repro_torch.core import fleet_finetune as FF  # noqa: E402
from repro_torch.core import lm_skiplora as SL  # noqa: E402
from repro_torch.core.control_plane import ControlConfig  # noqa: E402
from repro_torch.core.cuda_graph import GraphCache  # noqa: E402
from repro_torch.core.runtime import SessionRuntime  # noqa: E402
from repro_torch.launch.serve import demo_pool  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim.optimizers import adamw, tree_leaves  # noqa: E402
from repro_torch.runtime.sharding import group_mesh, make_mesh  # noqa: E402

pytestmark = pytest.mark.gpu

CFG = ModelConfig(name="t", family="test", n_layers=4, d_model=16, n_heads=4, n_kv_heads=2, d_ff=32,
                  vocab_size=64, pattern=("attn",), dtype="float32")


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _live(params, cfg):
    for p in [params["final_norm"]] + [v for layer in params["stack"] for k, v in layer.items()
                                       if k.startswith("norm")]:
        p["scale"].fill_(1.0 if not cfg.rmsnorm_unit_offset else 0.0)
    return params


def _close(got, want, tol=1e-4):
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("arch", ["small", "qwen2-moe-a2.7b"])
def test_one_card_group_matches_the_unsplit_backbone(arch):
    cfg = CFG if arch == "small" else dataclasses.replace(reduce_config(get_config(arch)), vocab_size=512)
    params = _live(TL.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg), cfg)
    gp = TP.group_params(params, ["cuda:0", "cuda:0"])
    tokens = torch.randint(0, cfg.vocab_size, (2, 7), generator=torch.Generator().manual_seed(1)).cuda()
    _close(TL.lm_forward(gp, cfg, tokens)["h"], TL.lm_forward(params, cfg, tokens)["h"])
    c1, c2 = (TL.init_serve_caches(cfg, 2, 9, device="cuda", params=p) for p in (params, gp))
    l1, _ = TL.serve_prefill(params, cfg, tokens, c1)
    l2, _ = TL.serve_prefill(gp, cfg, tokens, c2)
    _close(l2, l1)
    assert torch.equal(l1.argmax(-1), l2.argmax(-1))
    d1, _ = TL.serve_decode(params, cfg, l1.argmax(-1), 7, c1)
    d2, _ = TL.serve_decode(gp, cfg, l2.argmax(-1), 7, c2)
    _close(d2, d1)


def _session(devices, stages):
    params = _live(TL.init_lm(torch.Generator().manual_seed(0), CFG), CFG)
    mesh = make_mesh((1, 2), ("data", "model"), devices=devices)
    if devices[0] != "cpu":
        from repro_torch.runtime.sharding import _to

        params = _to(params, torch.device(devices[0]))
    rt = SessionRuntime(CFG, SL.SkipLoRAConfig(rank=2, mode="full"), params, max_tenants=2, samples_per_tenant=4,
                        seq=6, use_kernel=False, mesh=mesh, pipeline_stages=stages, seed=0)
    g = np.random.default_rng(5)
    for t in ("a", "b"):
        rt.ingest(t, g.integers(0, 64, (4, 6)), g.integers(0, 64, (4, 6)))
    rt.adapt(["a", "b"], epochs=2, batch_per_tenant=2, generator=torch.Generator().manual_seed(7))
    prompts = g.integers(0, 64, (3, 5))
    toks = rt.serve([None, "a", "b"], prompts, max_new=4).cpu()
    rt.attach_scheduler(max_batch=4, max_prompt=5, max_new_cap=6, admit_bucket=2, chunk=2)
    reqs = [rt.enqueue_serve(t, prompts[j, :4 - j], max_new=5) for j, t in enumerate(("a", None, "b"))]
    rt.drain()
    return rt, toks, [r.result().tolist() for r in reqs]


@pytest.mark.parametrize("stages", [0, 2])
def test_two_card_session_matches_the_cpu_group(stages):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    card, toks_card, sched_card = _session(["cuda:0", "cuda:1"], stages)
    cpu, toks_cpu, sched_cpu = _session(["cpu", "cpu"], stages)
    assert [str(d) for d in card._group(0)] == ["cuda:0", "cuda:1"]
    for t in ("a", "b"):
        for k in ("A", "B"):
            np.testing.assert_allclose(card.tenant(t).adapters[k].cpu().numpy(),
                                       cpu.tenant(t).adapters[k].numpy(), rtol=1e-4, atol=1e-6)
    assert card.pool.slot_table() == cpu.pool.slot_table()
    assert torch.equal(toks_card, toks_cpu) and sched_card == sched_cpu
    if stages:
        assert card.scheduler.counters["dispatch/admit_pipe"] >= 1


# ---------------------------------------------------------------------------
# A group's steps as graph replays, on one card and on two
# ---------------------------------------------------------------------------

ONE_CARD = ["cuda:0", "cuda:0"]
TWO_CARDS = ["cuda:0", "cuda:1"]
CARDS = pytest.mark.parametrize("cards", [1, 2], ids=["one_card", "two_cards"])


def _group_devices(cards):
    """The group's devices: one card's two members, or two cards (skipped
    below two)."""
    if cards == 2 and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return ONE_CARD if cards == 1 else TWO_CARDS
SEQ_CFG = dataclasses.replace(CFG, name="t1", n_kv_heads=1)
ARCHS = {"moe": "qwen2-moe-a2.7b", "sequence": "paligemma-3b", "recurrent": "xlstm-350m"}


def _reduced(kind):
    cfg = reduce_config(get_config(ARCHS[kind]), **({"n_periods": 1} if kind == "recurrent" else {}))
    return dataclasses.replace(cfg, vocab_size=512)


def _whole(caches):
    return [TP.whole(t) for c in caches for t in c.values()]


def _stats_gain(stats, since):
    got = stats.copy()
    got.subtract(since)
    return got


@CARDS
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("kind", ["moe", "sequence", "recurrent"])
def test_group_decode_scan_replays_the_eager_loop_bitwise(kind, temperature, cards):
    devices = _group_devices(cards)
    cfg = _reduced(kind)
    params = _live(TL.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg), cfg)
    gp = TP.group_params(params, devices)
    del params
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (4, 8), generator=g, device="cuda")
    pool = demo_pool(cfg, 3, 4, None, torch.device("cuda"))
    idx = pool.lookup([None, "tenant-0", "tenant-1", "tenant-2"])
    caches = TL.init_serve_caches(cfg, 4, 8 + 6, device="cuda", params=gp)
    leaf = caches[0]["k"] if kind != "recurrent" else caches[0]["c"]
    assert isinstance(leaf, TP.HeadSplit) and leaf.axis == {"moe": -2, "sequence": -3, "recurrent": -3}[kind]
    with torch.no_grad():
        logits, caches = TL.serve_prefill(gp, cfg, prompts, caches)
        tok0 = logits.argmax(-1)
        twin = [{n: TP.zeros_like(t).copy_(t) for n, t in c.items()} for c in caches]
        kw = dict(max_new=6, temperature=temperature, pools=pool.pools(), idx=idx, use_kernel=False)
        since = DG.GRAPHS.stats.copy()
        got, _ = TL.decode_scan(gp, cfg, tok0, 8, caches, unroll=2,
                                generator=torch.Generator(device="cuda").manual_seed(5), **kw)
        gain = _stats_gain(DG.GRAPHS.stats, since)
        want, _ = TL.decode_loop(gp, cfg, tok0, 8, twin, generator=torch.Generator(device="cuda").manual_seed(5),
                                 **kw)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(_whole(caches), _whole(twin)))
    # a first call: one eager step, then 2- and 1-step graphs (5 = 2 + 2 + 1)
    assert gain["captures"] == 2 and gain["eager_steps"] == 1 and gain["replays"] == 3
    DG.GRAPHS.clear()


def _sched_session(cfg, loop, devices):
    params = _live(TL.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg), cfg)
    rt = SessionRuntime(cfg, SL.SkipLoRAConfig(rank=2, mode="full"), params, max_tenants=2, samples_per_tenant=4,
                        seq=6, use_kernel=False, mesh=group_mesh(devices), seed=0)
    g = np.random.default_rng(5)
    for t in ("a", "b"):
        rt.ingest(t, g.integers(0, cfg.vocab_size, (4, 6)), g.integers(0, cfg.vocab_size, (4, 6)))
    rt.adapt(["a", "b"], epochs=1, batch_per_tenant=2, generator=torch.Generator().manual_seed(7))
    prompts = g.integers(0, cfg.vocab_size, (4, 6))
    rt.attach_scheduler(max_batch=4, max_prompt=6, max_new_cap=8, admit_bucket=2, chunk=3, loop=loop)
    reqs = [rt.enqueue_serve(t, prompts[j, :6 - j], max_new=7 - j) for j, t in enumerate((None, "a", None, "b"))]
    rt.drain()
    return [r.result().tolist() for r in reqs], rt


@CARDS
@pytest.mark.parametrize("cfg", [CFG, SEQ_CFG], ids=["heads", "sequence"])
def test_group_scheduler_chunks_replay_the_eager_chunks_bitwise(cfg, cards):
    devices = _group_devices(cards)
    since = DG.GRAPHS.stats.copy()
    got, rt = _sched_session(cfg, False, devices)
    gain = _stats_gain(DG.GRAPHS.stats, since)
    assert TP.is_group(rt.params) and rt.params.devices == [torch.device(d) for d in devices]
    assert (isinstance(rt.scheduler._lb.caches["k"], TP.HeadSplit)
            and rt.scheduler._lb.caches["k"].axis == (-2 if cfg is CFG else -3))
    since = DG.GRAPHS.stats.copy()
    want, _ = _sched_session(cfg, True, devices)
    assert got == want
    assert gain["captures"] >= 1 and gain["replays"] >= 1
    assert _stats_gain(DG.GRAPHS.stats, since)["captures"] == 0
    DG.GRAPHS.clear()


N, SEQ, BATCH, RANK = 16, 16, 4, 4


@pytest.fixture(scope="module", params=[1, 2], ids=["one_card", "two_cards"])
def group_model(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    devices = _group_devices(request.param)
    cfg = dataclasses.replace(reduce_config(get_config("stablelm-1.6b")), vocab_size=512)
    gp = TP.group_params(_live(TL.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg), cfg), devices)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (N, SEQ), generator=g, device="cuda", dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (N, SEQ), generator=g, device="cuda", dtype=torch.int32)
    idx = [torch.randperm(N, generator=g, device="cuda").reshape(N // BATCH, BATCH) for _ in range(3)]
    return cfg, gp, tokens, labels, idx


def _leaves(*trees):
    out = []
    for t in trees:
        if isinstance(t, SL.SkipCache):
            out += list(t.slots.values()) + [t.valid]
        elif dataclasses.is_dataclass(t):
            out += [t.step] + tree_leaves(t.mu) + tree_leaves(t.nu)
        else:
            out += tree_leaves(t)
    return out


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _group_single(model, mode, *, loop, graphs):
    cfg, gp, tokens, labels, idx = model
    sl = SL.SkipLoRAConfig(rank=RANK, mode=mode, cache_dtype="float32")
    trainable, static = SL.split_trainable(SL.init_adapters(torch.Generator(device="cuda").manual_seed(2), cfg, sl),
                                           sl)
    opt = adamw(1e-3)
    opt_state = opt.init(trainable)
    cache = SL.init_lm_cache(N, cfg, sl, SEQ, device="cuda")
    trainable, opt_state, cache, ls = SL.make_populate_epoch(cfg, sl, opt, loop=loop, graphs=graphs)(
        gp, trainable, static, opt_state, cache, tokens, labels, idx[0])
    losses = [ls]
    for m in idx[1:]:
        trainable, opt_state, ls = SL.make_cached_epoch(cfg, sl, opt, loop=loop, graphs=graphs)(
            gp, trainable, static, opt_state, cache, m)
        losses.append(ls)
    torch.cuda.synchronize()
    return torch.stack(losses), _leaves(trainable, opt_state, cache)


@pytest.mark.parametrize("mode", ["full", "int8", "freeze_a"])
def test_group_single_tenant_epochs_replay_the_eager_loop_bitwise(group_model, mode):
    graphs = GraphCache()
    got = _group_single(group_model, mode, loop=False, graphs=graphs)
    want = _group_single(group_model, mode, loop=True, graphs=graphs)
    assert torch.equal(got[0], want[0]) and bool(torch.isfinite(got[0]).all())
    assert _equal(got[1], want[1])
    steps = N // BATCH
    assert graphs.stats["captures"] == 2 and graphs.stats["first_steps"] == 2
    assert graphs.stats["replays"] == 3 * steps - 2 and graphs.stats["hits"] == 1


def _group_fleet(model, mode, *, loop, graphs, tenants=2, bpt=2):
    cfg, gp, tokens, labels, _ = model
    sl = SL.SkipLoRAConfig(rank=RANK, mode=mode, cache_dtype="float32")
    stacked = FF.init_fleet_adapters(torch.Generator(device="cuda").manual_seed(3), cfg, sl, tenants)
    opt = adamw(1e-3)
    opt_state = opt.init(stacked)
    cache = SL.init_lm_cache(N, cfg, sl, SEQ, device="cuda")
    n_per = N // tenants
    row_tenant = FF.fleet_row_tenant(tenants, bpt, device="cuda")
    mats = [torch.as_tensor(FF.fleet_index_matrix(e, tenants, n_per, bpt), device="cuda") for e in range(3)]
    eval_idx = torch.arange(0, N, n_per // 2, device="cuda")
    eval_rows = FF.fleet_row_tenant(tenants, 2, device="cuda")
    kw = dict(use_kernel=False, loop=loop, graphs=graphs)
    stacked, opt_state, cache, l0 = FF.make_fleet_populate_epoch(cfg, sl, opt, tenants, **kw)(
        gp, stacked, opt_state, cache, tokens, labels, mats[0], row_tenant)
    stacked, opt_state, l1 = FF.make_fleet_cached_epoch(cfg, sl, opt, tenants, **kw)(
        gp, stacked, opt_state, cache, mats[1], row_tenant)
    stacked, opt_state, l2, pre, post = FF.make_fleet_cached_epoch_eval(cfg, sl, opt, tenants, **kw)(
        gp, stacked, opt_state, cache, mats[2], row_tenant, eval_idx, eval_rows)
    torch.cuda.synchronize()
    return torch.stack([l0, l1, l2]), torch.stack([pre, post]), _leaves(stacked, opt_state, cache)


@pytest.mark.parametrize("mode", ["full", "int8"])
def test_group_fleet_epochs_replay_the_eager_loop_bitwise(group_model, mode):
    graphs = GraphCache()
    got = _group_fleet(group_model, mode, loop=False, graphs=graphs)
    want = _group_fleet(group_model, mode, loop=True, graphs=graphs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _equal(got[2], want[2])
    assert graphs.stats["captures"] == 5 and graphs.stats["replays"] == 3 * (N // 4) - 2


def _adapt_session(control, devices):
    cfg = dataclasses.replace(CFG, vocab_size=64)
    params = _live(TL.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg), cfg)
    rt = SessionRuntime(cfg, SL.SkipLoRAConfig(rank=2, mode="full"), params, max_tenants=2, samples_per_tenant=6,
                        seq=6, use_kernel=False, mesh=group_mesh(devices), seed=0,
                        control=ControlConfig(holdout_every=3) if control else None)
    g = np.random.default_rng(5)
    for t in ("a", "b"):
        rt.ingest(t, g.integers(0, 64, (6, 6)), g.integers(0, 64, (6, 6)))
    return rt


@CARDS
@pytest.mark.parametrize("control", [False, True], ids=["plain", "control"])
def test_group_session_adapt_replays_the_eager_loop_bitwise(control, cards):
    devices = _group_devices(cards)
    rts = [_adapt_session(control, devices) for _ in range(2)]
    outs = []
    for rt, loop in zip(rts, (False, True)):
        outs.append([rt.adapt(["a", "b"], epochs=2, batch_per_tenant=2, loop=loop,
                              generator=torch.Generator().manual_seed(7)) for _ in range(2)])
    graphed, eager = rts
    for a, b in zip(*outs):
        assert a["path"] == b["path"] == "scan"
        for t in ("a", "b"):
            np.testing.assert_array_equal(a["losses"][t], b["losses"][t])
    for t in ("a", "b"):
        for name in ("adapters", "opt_mu", "opt_nu"):
            for k in ("A", "B"):
                assert torch.equal(getattr(graphed.tenant(t), name)[k], getattr(eager.tenant(t), name)[k])
    assert graphed.pool.slot_table() == eager.pool.slot_table()
    stats = graphed.epoch_graph_stats()
    assert stats["captures"] >= 1 and stats["replays"] >= 1
    assert eager.epoch_graph_stats()["captures"] == 0
    if not control:
        steps = 6 // 2
        # the first call runs its first step eagerly, the second only replays
        assert stats["captures"] == 1 and stats["replays"] == 4 * steps - 1


def _two_card_decode(cfg):
    """A group over two cards after its prefill: (params, tok0, the caches,
    a twin of them)."""
    params = _live(TL.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg), cfg)
    gp = TP.group_params(params, TWO_CARDS)
    prompts = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(4)).cuda()
    with torch.no_grad():
        caches = TL.init_serve_caches(cfg, 2, 9, device="cuda", params=gp)
        logits, caches = TL.serve_prefill(gp, cfg, prompts, caches)
    twin = [{n: TP.zeros_like(t).copy_(t) for n, t in c.items()} for c in caches]
    return gp, logits.argmax(-1), caches, twin


def test_cross_card_group_replays_the_eager_steps_bitwise():
    _group_devices(2)
    gp, tok0, caches, twin = _two_card_decode(CFG)
    assert {p.device for c in caches for t in c.values() if isinstance(t, TP.HeadSplit) for p in t.parts} == {
        torch.device("cuda", 0), torch.device("cuda", 1)}
    since = DG.GRAPHS.stats.copy()
    with torch.no_grad():
        got, _ = TL.decode_scan(gp, CFG, tok0, 5, caches, max_new=4)
        want, _ = TL.decode_loop(gp, CFG, tok0, 5, twin, max_new=4)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(_whole(caches), _whole(twin)))
    gain = _stats_gain(DG.GRAPHS.stats, since)
    assert gain["captures"] == 1 and gain["eager_steps"] == 1 and gain["replays"] == 3
    DG.GRAPHS.clear()
    sl = SL.SkipLoRAConfig(rank=2, mode="full", cache_dtype="float32")
    trainable, static = SL.split_trainable(SL.init_adapters(torch.Generator(device="cuda").manual_seed(2), CFG, sl),
                                           sl)
    opt = adamw(1e-3)
    tokens = torch.randint(0, CFG.vocab_size, (4, 6), generator=torch.Generator().manual_seed(6)).cuda()
    outs = []
    graphs = GraphCache()
    for loop in (False, True):
        cache = SL.init_lm_cache(4, CFG, sl, 6, device="cuda")
        t, o, cache, losses = SL.make_populate_epoch(CFG, sl, opt, loop=loop, graphs=graphs)(
            gp, trainable, static, opt.init(trainable), cache, tokens, tokens,
            torch.arange(4, device="cuda").reshape(2, 2))
        outs.append([losses] + _leaves(t, o, cache))
    assert _equal(*outs)
    assert graphs.stats["captures"] == 1 and graphs.stats["replays"] == 1


def _scribble(card):
    """The card's free memory filled with NaN through new allocations (the
    allocator's cached blocks first, then fresh memory) until 1 GiB is
    left: what a replay would read if its memory had been handed out
    again."""
    junk, chunk = [], 64 << 20
    while torch.cuda.mem_get_info(card)[0] > (1 << 30) + chunk:
        junk.append(torch.full((chunk // 4,), float("nan"), device=f"cuda:{card}"))
    torch.cuda.synchronize(card)
    return junk


@pytest.mark.parametrize("what", ["decode", "epochs"])
def test_two_card_replays_survive_a_scribbled_member_card(what):
    _group_devices(2)
    cfg = _reduced("moe")
    gp, tok0, caches, twin = _two_card_decode(cfg)
    base = [{n: TP.zeros_like(t).copy_(t) for n, t in c.items()} for c in caches]
    graphs = GraphCache()
    if what == "decode":
        def run(loop):
            mine = [{n: TP.zeros_like(t).copy_(t) for n, t in c.items()} for c in base]
            with torch.no_grad():
                if loop:
                    toks, _ = TL.decode_loop(gp, cfg, tok0, 5, mine, max_new=4, use_kernel=False)
                else:
                    toks, _ = DG.decode(gp, cfg, tok0, 5, mine, max_new=4, use_kernel=False, graphs=graphs)
            return [toks] + _whole(mine)
    else:
        sl = SL.SkipLoRAConfig(rank=2, mode="full", cache_dtype="float32")
        trainable, static = SL.split_trainable(
            SL.init_adapters(torch.Generator(device="cuda").manual_seed(2), cfg, sl), sl)
        opt = adamw(1e-3)
        tokens = torch.randint(0, cfg.vocab_size, (8, 6), generator=torch.Generator().manual_seed(6)).cuda()
        mat = torch.randperm(8, generator=torch.Generator().manual_seed(8)).reshape(4, 2).cuda()
        fresh = SL.init_lm_cache(8, cfg, sl, 6, device="cuda")
        cache = SL.init_lm_cache(8, cfg, sl, 6, device="cuda")   # one storage: the entry is keyed on it

        def run(loop):
            for a, b in zip(_leaves(cache), _leaves(fresh)):
                a.copy_(b)
            t, o, _, losses = SL.make_populate_epoch(cfg, sl, opt, loop=loop, graphs=graphs)(
                gp, trainable, static, opt.init(trainable), cache, tokens, tokens, mat)
            return [losses] + [x.clone() for x in _leaves(t, o, cache)]

    want = run(True)
    assert _equal(run(False), want)              # captures
    captures = graphs.stats["captures"]
    assert captures >= 1
    torch.cuda.empty_cache()
    junk = _scribble(1)
    got = run(False)                             # replays only, over a member card full of NaN
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    assert graphs.stats["captures"] == captures
    assert _equal(got, want)
    assert all(bool(torch.isnan(j).all()) for j in junk)
    del junk, got
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(1)
    graphs.clear()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(1) < held  # the member card's pool went with the graphs


def test_dropping_two_card_entries_mid_replay_is_safe():
    """Entries dropped as soon as their call returns, with their replays
    still in flight on both cards (a temporary ``GraphCache``: the entry's
    member-card pool is released before anything synchronises): every call
    bitwise the eager loop, no fault."""
    _group_devices(2)
    cfg = _reduced("moe")
    gp, tok0, caches, twin = _two_card_decode(cfg)
    with torch.no_grad():
        want, _ = TL.decode_loop(gp, cfg, tok0, 5, twin, max_new=4, use_kernel=False)
        got = []
        for _ in range(4):
            mine = [{n: TP.zeros_like(t).copy_(t) for n, t in c.items()} for c in caches]
            got.append(DG.decode(gp, cfg, tok0, 5, mine, max_new=4, use_kernel=False, graphs=GraphCache())[0])
    assert all(torch.equal(g, want) for g in got)


def test_a_failed_two_card_capture_raises_and_the_cards_go_on():
    """A step refused after it issued work on both cards (as the kernel
    wrappers refuse inside a capture) raises ``GraphCaptureError`` naming
    the step: no step falls back, both cards' current streams and the
    current card are as they were, and a later two-card capture replays
    bitwise."""
    _group_devices(2)
    from repro_torch.core.cuda_graph import CardPools, GraphCaptureError, capture

    x = torch.arange(8.0, device="cuda:1")
    (x * 2).to("cuda:0")            # peer access enabled outside the capture
    pools = CardPools(torch.device("cuda", 0))
    before = [torch.cuda.current_stream(d) for d in (0, 1)]

    def bad():
        (x * 2).to("cuda:0").add_(1)
        raise RuntimeError("refused inside a capture")

    with torch.cuda.device(0), pytest.raises(GraphCaptureError, match="capturing a bad step.*refused inside"):
        capture(torch.cuda.CUDAGraph(), bad, what="a bad step", devices=TWO_CARDS, pools=pools)
    assert [torch.cuda.current_stream(d) for d in (0, 1)] == before and torch.cuda.current_device() == 0
    assert list(pools) == [1]
    gp, tok0, caches, twin = _two_card_decode(CFG)
    with torch.no_grad():
        got, _ = DG.decode(gp, CFG, tok0, 5, caches, max_new=3, use_kernel=False, graphs=GraphCache())
        want, _ = TL.decode_loop(gp, CFG, tok0, 5, twin, max_new=3, use_kernel=False)
    assert torch.equal(got, want)
