"""The LM fine-tuning epochs as CUDA-graph replays (``core.lm_skiplora``,
``core.fleet_finetune``, ``core.cuda_graph.EpochGraph``) against the eager
loop, and the trainer chunk's graph keying (``launch.train``), on the card.

Every test here needs a CUDA device (CUDA graphs have no CPU mode); without
one they skip. The file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_lm_graph_gpu.py

Reduced stablelm-1.6b (bf16), 16 samples of 16 tokens, batch 4, rank 8,
seeded weights, TF32 off. Bars: in every mode, with the hand-written
kernels and without, the graphed populate and cached epochs, and the three
fleet epochs, give the ``loop=True`` loop's losses, adapters, moments,
step count and cache bitwise, with the same kernel launches; an entry
captures once and then only replays, one replay a step (a first call
runs its first step eagerly); an epoch leaves
every argument it does not donate untouched and hands out tensors no later
replay writes; a capture inside which a step raises surfaces the error as
``GraphCaptureError`` and replays nothing; two trainer states of equal
shapes, alternated through one chunk function, each follow their own eager
trajectory bitwise."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import fleet_finetune as FF  # noqa: E402
from repro_torch.core import lm_skiplora as SL  # noqa: E402
from repro_torch.core.cuda_graph import GraphCache, GraphCaptureError  # noqa: E402
from repro_torch.kernels.skip_lora import kernel as K  # noqa: E402
from repro_torch.models.lm import init_lm  # noqa: E402
from repro_torch.optim.optimizers import adamw, tree_leaves  # noqa: E402

pytestmark = pytest.mark.gpu

N, SEQ, BATCH, RANK, LR = 16, 16, 4, 8, 1e-3
MODES = [("full", False), ("full", True), ("int8", False), ("int8", True), ("freeze_a", False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = reduce_config(get_config("stablelm-1.6b"))
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (N, SEQ), generator=g, device="cuda", dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (N, SEQ), generator=g, device="cuda", dtype=torch.int32)
    idx = [torch.randperm(N, generator=g, device="cuda").reshape(N // BATCH, BATCH) for _ in range(3)]
    return cfg, params, tokens, labels, idx


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


def _single(model, mode, fused, *, loop, graphs):
    """Populate + two cached epochs -> (every losses, trainable, opt state,
    cache, launches by kernel)."""
    cfg, params, tokens, labels, idx = model
    sl = SL.SkipLoRAConfig(rank=RANK, mode=mode, cache_dtype="float32", use_fused_kernel=fused)
    adapters = SL.init_adapters(torch.Generator(device="cuda").manual_seed(2), cfg, sl)
    trainable, static = SL.split_trainable(adapters, sl)
    opt = adamw(LR)
    opt_state = opt.init(trainable)
    cache = SL.init_lm_cache(N, cfg, sl, SEQ, device="cuda")
    pop = SL.make_populate_epoch(cfg, sl, opt, loop=loop, graphs=graphs)
    cached = SL.make_cached_epoch(cfg, sl, opt, loop=loop, graphs=graphs)
    K.reset_launches()
    trainable, opt_state, cache, ls = pop(params, trainable, static, opt_state, cache, tokens, labels, idx[0])
    losses = [ls]
    for m in idx[1:]:
        trainable, opt_state, ls = cached(params, trainable, static, opt_state, cache, m)
        losses.append(ls)
    torch.cuda.synchronize()
    return torch.stack(losses), trainable, opt_state, cache, dict(K.LAUNCHES)


@pytest.mark.parametrize("mode,fused", MODES)
def test_graphed_single_tenant_epochs_equal_the_eager_loop_bitwise(cuda, model, mode, fused):
    graphs = GraphCache()
    got = _single(model, mode, fused, loop=False, graphs=graphs)
    want = _single(model, mode, fused, loop=True, graphs=graphs)
    assert torch.equal(got[0], want[0]) and bool(torch.isfinite(got[0]).all())
    assert _equal(_leaves(got[1], got[2], got[3]), _leaves(want[1], want[2], want[3]))
    assert got[4] == want[4]   # the replays' launches, as executed, are the loop's
    if fused:
        fwd = "skip_lora_fwd_int8" if mode == "int8" else "skip_lora_fwd"
        assert got[4][fwd] == got[4]["skip_lora_bwd"] == 2 * (N // BATCH)
    steps = N // BATCH
    # each entry's first call runs its first step eagerly and replays the rest
    assert graphs.stats["captures"] == 2 and graphs.stats["first_steps"] == 2
    assert graphs.stats["replays"] == 3 * steps - 2 and graphs.stats["hits"] == 1
    K.reset_launches()


def _fleet(model, mode, *, loop, graphs, tenants=2, bpt=2):
    cfg, params, tokens, labels, _ = model
    sl = SL.SkipLoRAConfig(rank=RANK, mode=mode, cache_dtype="float32")
    stacked = FF.init_fleet_adapters(torch.Generator(device="cuda").manual_seed(3), cfg, sl, tenants)
    opt = adamw(LR)
    opt_state = opt.init(stacked)
    cache = SL.init_lm_cache(N, cfg, sl, SEQ, device="cuda")
    n_per = N // tenants
    row_tenant = FF.fleet_row_tenant(tenants, bpt, device="cuda")
    mats = [torch.as_tensor(FF.fleet_index_matrix(e, tenants, n_per, bpt), device="cuda") for e in range(3)]
    eval_idx = torch.arange(0, N, n_per // 2, device="cuda")
    eval_rows = FF.fleet_row_tenant(tenants, 2, device="cuda")
    kw = dict(use_kernel=True, loop=loop, graphs=graphs)
    K.reset_launches()
    stacked, opt_state, cache, l0 = FF.make_fleet_populate_epoch(cfg, sl, opt, tenants, **kw)(
        params, stacked, opt_state, cache, tokens, labels, mats[0], row_tenant)
    stacked, opt_state, l1 = FF.make_fleet_cached_epoch(cfg, sl, opt, tenants, **kw)(
        params, stacked, opt_state, cache, mats[1], row_tenant)
    stacked, opt_state, l2, pre, post = FF.make_fleet_cached_epoch_eval(cfg, sl, opt, tenants, **kw)(
        params, stacked, opt_state, cache, mats[2], row_tenant, eval_idx, eval_rows)
    torch.cuda.synchronize()
    return torch.stack([l0, l1, l2]), torch.stack([pre, post]), stacked, opt_state, cache, dict(K.LAUNCHES)


@pytest.mark.parametrize("mode", ["full", "int8"])
def test_graphed_fleet_epochs_equal_the_eager_loop_bitwise(cuda, model, mode):
    graphs = GraphCache()
    got = _fleet(model, mode, loop=False, graphs=graphs)
    want = _fleet(model, mode, loop=True, graphs=graphs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _equal(_leaves(got[2], got[3], got[4]), _leaves(want[2], want[3], want[4]))
    assert got[5] == want[5] and got[5]["grouped_skip_sum_bwd"] == 3 * (N // 4)
    # populate, cached, and the eval epoch's step, pre and post graphs; on
    # a first call the first step and the pre eval run eagerly
    assert graphs.stats["captures"] == 5 and graphs.stats["replays"] == 3 * (N // 4) - 2
    K.reset_launches()


def test_an_entry_captures_once_then_only_replays(cuda, model):
    """Epochs of one optimizer over one cache, through fresh factories and
    any index matrix: the first call runs its first step eagerly, captures
    and replays the rest, every later one only replays, one replay a step.
    Another optimizer keys another entry."""
    cfg, params, _, _, idx = model
    sl = SL.SkipLoRAConfig(rank=RANK, cache_dtype="float32", use_fused_kernel=True)
    _, trainable, _, cache, _ = _single(model, "full", True, loop=True, graphs=GraphCache())
    graphs = GraphCache()
    opt = adamw(LR)
    for m in idx:
        SL.make_cached_epoch(cfg, sl, opt, graphs=graphs)(params, trainable, {}, opt.init(trainable), cache, m)
    assert graphs.stats["captures"] == graphs.stats["first_steps"] == 1 and graphs.stats["hits"] == 2
    assert graphs.stats["replays"] == 3 * (N // BATCH) - 1
    other = adamw(LR)
    SL.make_cached_epoch(cfg, sl, other, graphs=graphs)(params, trainable, {}, other.init(trainable), cache, idx[0])
    assert graphs.stats["captures"] == 2 and len(graphs) == 2
    K.reset_launches()


def test_epochs_leave_what_they_do_not_donate_alone(cuda, model):
    cfg, params, tokens, labels, idx = model
    sl = SL.SkipLoRAConfig(rank=RANK, mode="freeze_a", cache_dtype="float32")
    adapters = SL.init_adapters(torch.Generator(device="cuda").manual_seed(2), cfg, sl)
    trainable, static = SL.split_trainable(adapters, sl)
    opt = adamw(LR)
    opt_state = opt.init(trainable)
    cache = SL.init_lm_cache(N, cfg, sl, SEQ, device="cuda")
    kept = [t.clone() for t in _leaves(params, static, trainable, opt_state) + [tokens, labels] + idx]
    graphs = GraphCache()
    pop = SL.make_populate_epoch(cfg, sl, opt, graphs=graphs)
    t1, o1, cache, l1 = pop(params, trainable, static, opt_state, cache, tokens, labels, idx[0])
    handed = [t.clone() for t in _leaves(t1, o1) + [l1]]
    pop(params, t1, static, o1, SL.init_lm_cache(N, cfg, sl, SEQ, device="cuda"), tokens, labels, idx[1])
    torch.cuda.synchronize()
    assert _equal([t for t in _leaves(params, static, trainable, opt_state) + [tokens, labels] + idx], kept)
    assert _equal(_leaves(t1, o1) + [l1], handed)
    assert bool(cache.valid.all())


def test_a_failed_capture_raises_and_replays_nothing(cuda, model, monkeypatch):
    cfg, params, _, _, idx = model
    real = SL.apply_updates

    def apply_updates(p, u):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("update refused inside a capture")
        return real(p, u)

    monkeypatch.setattr(SL, "apply_updates", apply_updates)
    sl = SL.SkipLoRAConfig(rank=RANK, cache_dtype="float32")
    adapters = SL.init_adapters(torch.Generator(device="cuda").manual_seed(2), cfg, sl)
    opt = adamw(LR)
    graphs = GraphCache()
    K.reset_launches()
    with pytest.raises(GraphCaptureError, match="update refused inside a capture"):
        SL.make_cached_epoch(cfg, sl, opt, graphs=graphs)(
            params, adapters, {}, opt.init(adapters), SL.init_lm_cache(N, cfg, sl, SEQ, device="cuda"), idx[0])
    assert graphs.stats["first_steps"] == 1 and graphs.stats["captures"] == 0 and graphs.stats["replays"] == 0


def test_chunk_graph_keeps_two_states_of_equal_shapes_apart(cuda):
    """Two trainer states of equal shapes alternated through one
    ``make_scan_chunk``: each follows its own eager trajectory bitwise, and
    the tokens and labels are never written."""
    import numpy as np

    from repro_torch.launch import train as TT

    cfg = reduce_config(get_config("stablelm-1.6b"))
    opt = adamw(3e-4, weight_decay=0.1)
    g = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (16, 16), generator=g, device="cuda", dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (16, 16), generator=g, device="cuda", dtype=torch.int32)
    data = (tokens.clone(), labels.clone())
    mats = [torch.as_tensor(np.random.default_rng(s).integers(0, 16, size=(2, 4)), device="cuda") for s in range(3)]
    step = TT.make_step(cfg, opt)
    states, want = [], []
    for seed in (0, 1):
        p = init_lm(torch.Generator(device="cuda").manual_seed(seed), cfg)
        states.append((p, opt.init(p)))
        p, st, ls = p, opt.init(p), []
        for m in mats:
            for ids in m:
                p, st, loss = step(p, st, {"tokens": tokens[ids], "labels": labels[ids]})
                ls.append(loss)
        want.append((p, st, torch.stack(ls)))
    graphs = GraphCache(capacity=4)
    run = TT.make_scan_chunk(cfg, opt, graphs=graphs)
    losses = [[], []]
    for m in mats:
        for i in (0, 1):
            p, st, ls = run(*states[i], tokens, labels, m)
            states[i] = (p, st)
            losses[i].append(ls)
    for i in (0, 1):
        assert torch.equal(torch.cat(losses[i]), want[i][2])
        assert _equal(_leaves(states[i][0], states[i][1]), _leaves(want[i][0], want[i][1]))
    assert torch.equal(tokens, data[0]) and torch.equal(labels, data[1])
    assert graphs.stats["misses"] == 2 and graphs.stats["hits"] == 4
    graphs.clear()
