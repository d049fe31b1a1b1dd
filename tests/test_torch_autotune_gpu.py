"""The autotuner's sweeps on the card (``repro_torch.kernels.autotune``)
and the trainer's chunk graph (``repro_torch.launch.train``).

Every test here needs a CUDA device (and nvcc, to build the kernels);
without one they skip. The file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_autotune_gpu.py

Small widths (L 4, D 256, R 8, bf16 rows, fp32 pools): for K5, K6 and K7
(int4 and nf4) at one row in each of 4 slots (a decode step) and at 4 slots
of 40 rows, every (tile, geometry) candidate's output equals the default's
(``ops.TM``, ``"rule"``) bitwise; a cold sweep times and a warm one is all
cache hits with the same choice; ``apply_choice`` installs a winner and the
reset leaves (``TM``, ``"rule"``). The decode-unroll sweep replays graphs
of every candidate, and the KV-block sweep runs K10. A reduced float32
trainer's chunk (one CUDA-graph replay) equals its per-step path bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import kv_pool as KV  # noqa: E402
from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels.skip_lora import kernel as K  # noqa: E402
from repro_torch.kernels.skip_lora import ops as O  # noqa: E402

pytestmark = pytest.mark.gpu

L, D, R, N = 4, 256, 8, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    O.set_default_tile(None, None)
    KV.set_default_block(None)


def _inputs(groups, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = sum(groups)
    x = torch.randn((L, m, D), generator=g, device="cuda").to(torch.bfloat16)
    a = torch.randn((N, L, D, R), generator=g, device="cuda") / D**0.5
    b = torch.randn((N, L, R, D), generator=g, device="cuda") * 0.02
    idx = torch.cat([torch.full((c,), s, dtype=torch.int32, device="cuda") for s, c in enumerate(groups)])
    return x, a, b, idx[torch.randperm(m, generator=g, device="cuda")]


def _quick_timer(fn):
    fn()
    return 0.0


@pytest.mark.parametrize("groups", [(1, 1, 1, 1), (40, 40, 40, 40)], ids=["decode", "many"])
@pytest.mark.parametrize("variant", AT.VARIANTS)
def test_every_candidate_gives_the_defaults_bits(cuda, variant, groups):
    x, a, b, idx = _inputs(groups)
    record = []
    AT.tune_grouped(x, a, b, idx, variant, config="gpu-test", timer=_quick_timer, record=record)
    cands = {(tm, g): out for tm, g, _, _, out in record}
    assert set(AT.tile_candidates(x.shape[1], x.dtype)) == {tm for tm, _ in cands}
    want = cands[O.TM, "rule"]
    assert want.shape == (x.shape[1], D) and bool(torch.isfinite(want.float()).all())
    for key, out in cands.items():
        assert torch.equal(out, want), (variant, key)


@pytest.mark.parametrize("variant", AT.VARIANTS)
def test_cold_then_warm_sweep(cuda, tmp_path, variant):
    x, a, b, idx = _inputs((1, 1, 1, 1))
    path = str(tmp_path / "at.json")
    cache = AT.AutotuneCache(path)
    first = AT.tune_grouped(x, a, b, idx, variant, config="gpu-test", cache=cache,
                            timer=AT.median_timer(iters=3, warmup=1))
    assert cache.misses == 1 and cache.hits == 0
    assert 0 < first.time_s <= first.default_time_s and first.predicted_s > 0
    assert AT.device_kind(x) == torch.cuda.get_device_name().replace(" ", "_")
    warm = AT.AutotuneCache(path)

    def poisoned(fn):
        raise AssertionError("a cache hit must not re-time")

    second = AT.tune_grouped(x, a, b, idx, variant, config="gpu-test", cache=warm, timer=poisoned)
    assert warm.hits == 1 and warm.misses == 0
    assert (second.tm, second.grid_order, second.source) == (first.tm, first.grid_order, "cache")


def test_apply_choice_then_reset(cuda):
    x, a, b, idx = _inputs((1, 1, 1, 1))
    want = O.skip_lora_grouped(x[:, :, None], a, b, idx)[:, 0]
    before = dict(K.ROW_LAUNCHES)
    try:
        AT.apply_choice(AT.Choice(tm=4, grid_order="many_rows"))
        assert O.get_default_tile() == (4, "many_rows")
        plan = O.grouped_plan(idx, N)
        assert O.plan_tile(plan) == 4
        got = O.skip_lora_grouped(x[:, :, None], a, b, idx, plan=plan)[:, 0]
        assert torch.equal(got, want)
        rows = K.ROW_LAUNCHES.get(("grouped_skip_sum_fwd", "many_rows"), 0)
        assert rows == before.get(("grouped_skip_sum_fwd", "many_rows"), 0) + 1
    finally:
        O.set_default_tile(None, None)
    assert O.get_default_tile() == (O.TM, "rule")
    assert O.plan_tile(O.grouped_plan(idx, N)) == O.TM


def test_decode_unroll_and_kv_block_sweeps(cuda):
    from repro_torch.configs import get_config, reduce_config

    x, a, b, idx = _inputs((1, 1, 1, 1))
    u, t = AT.tune_decode_unroll(x, a, b, idx, tm=O.TM, grid_order="rule", steps=16)
    assert u in AT.UNROLL_CANDIDATES and t > 0
    u, t = AT.tune_decode_unroll(x, a, b, idx, tm=O.TM, grid_order="rule", steps=5, candidates=(2, 4))
    assert u in (2, 4) and t > 0
    cfg = reduce_config(get_config("stablelm-1.6b"))
    ch = AT.tune_kv_block(cfg, config="gpu-test", seq=16, batch=2)
    assert ch.tm in AT.KV_BLOCK_CANDIDATES and 0 < ch.time_s <= ch.default_time_s


def test_train_chunk_graph_equals_per_step(cuda):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.cuda_graph import GraphCache
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.launch import train as TT
    from repro_torch.models.lm import init_lm
    from repro_torch.optim.optimizers import adamw, tree_leaves

    cfg = reduce_config(get_config("stablelm-1.6b"))
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw(3e-4, weight_decay=0.1)
    store, _ = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, num_samples=16))
    staged = store.batch(np.arange(16))
    tokens = torch.as_tensor(staged["tokens"], device="cuda")
    labels = torch.as_tensor(staged["labels"], device="cuda")
    idx = torch.as_tensor(np.random.default_rng(5).integers(0, 16, size=(3, 4)), device="cuda")
    step = TT.make_step(cfg, opt)
    p, st, want = params, opt.init(params), []
    for ids in idx:
        p, st, loss = step(p, st, {"tokens": tokens[ids], "labels": labels[ids]})
        want.append(loss)
    graphs = GraphCache(capacity=1)
    run = TT.make_scan_chunk(cfg, opt, graphs=graphs)
    p2, st2, losses = run(params, opt.init(params), tokens, labels, idx)
    assert graphs.stats["misses"] == 1
    assert torch.equal(losses, torch.stack(want))
    for x, y in zip(tree_leaves(p2) + tree_leaves(st2.mu) + tree_leaves(st2.nu) + [st2.step],
                    tree_leaves(p) + tree_leaves(st.mu) + tree_leaves(st.nu) + [st.step], strict=True):
        assert torch.equal(x, y)
    graphs.clear()
