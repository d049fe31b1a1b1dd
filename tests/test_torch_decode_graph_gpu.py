"""CUDA-graph decode (``core.decode_graph``) against the eager steps, on the card.

Every test here needs a CUDA device and the CUDA toolkit's ``nvcc`` (the
grouped kernels K5, K6 and K7 run inside the captured steps); without a
device they skip. The file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_decode_graph_gpu.py

Reduced stablelm-1.6b with seeded weights, in bf16 (the tensor-core routes)
and float32 (the CUDA-core routes). Bars: a graph replay gives the eager
loop's tokens, caches and generator state bitwise, for every pool layout
and temperature kind; the scheduler's graphed chunks give its eager chunks'
tokens and counters; a capture inside which a kernel raises surfaces the
error and runs no eager steps; an evicted graph gives its memory back."""

import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import decode_graph as DG  # noqa: E402
from repro_torch.core.runtime import generate_grouped, generate_loop  # noqa: E402
from repro_torch.core.scheduler import RequestScheduler  # noqa: E402
from repro_torch.kernels.skip_lora import kernel as K  # noqa: E402
from repro_torch.launch.serve import demo_pool, demo_runtime  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402

pytestmark = pytest.mark.gpu

KERNEL = {None: "grouped_skip_sum_fwd", "int8": "grouped_skip_sum_fwd_int8",
          "int4": "grouped_skip_sum_fwd_q4", "nf4": "grouped_skip_sum_fwd_q4"}
TEMPS = {"greedy": 0.0, "value": 0.8, "rows": [0.0, 1.1, 0.6, 0.9]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _model(cuda, dtype):
    cfg = reduce_config(get_config("stablelm-1.6b"))
    if dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = TL.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (4, 12), generator=torch.Generator(device=cuda).manual_seed(3),
                            device=cuda)
    return cfg, params, prompts


def _decode_both(cfg, params, prompts, pool, temperature, unroll, graphs, new=7):
    """(graph tokens, caches, generator state), (eager ...) from one prefill."""
    dev = prompts.device
    idx = pool.lookup([None, "tenant-0", "tenant-1", "tenant-2"])
    b, s = prompts.shape
    caches = TL.init_serve_caches(cfg, b, s + new, device=dev)
    logits, caches = TL.serve_prefill_grouped(params, cfg, prompts, caches, pool.pools(), idx)
    tok0 = TL.sample_token(logits, 0.0)
    other = [{n: t.clone() for n, t in c.items()} for c in caches]
    if isinstance(temperature, list):
        temperature = torch.tensor(temperature, device=dev)
    out = []
    for run, cs in ((DG.decode, caches), (TL.decode_loop, other)):
        g = torch.Generator(device=dev).manual_seed(11)
        kw = dict(unroll=unroll, graphs=graphs) if run is DG.decode else {}
        toks, cs = run(params, cfg, tok0, s, cs, max_new=new, temperature=temperature, generator=g,
                       pools=pool.pools(), idx=idx, **kw)
        out.append((toks, cs, g.get_state()))
    return out


@pytest.mark.parametrize("temp", list(TEMPS))
@pytest.mark.parametrize("compress", list(KERNEL))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graph_replays_equal_the_eager_loop_bitwise(cuda, dtype, compress, temp):
    cfg, params, prompts = _model(cuda, dtype)
    pool = demo_pool(cfg, 3, 8, compress, cuda)
    graphs = DG.GraphCache()
    for unroll in (1, 3, 7):
        (g_toks, g_caches, g_state), (e_toks, e_caches, e_state) = _decode_both(
            cfg, params, prompts, pool, TEMPS[temp], unroll, graphs)
        assert torch.equal(g_toks, e_toks), (unroll, g_toks.tolist(), e_toks.tolist())
        assert all(torch.equal(a[n], b[n]) for a, b in zip(g_caches, e_caches) for n in a)
        assert torch.equal(g_state, e_state)
    # each entry's first call: one eager warm-up step, then 6 steps of replays
    assert graphs.stats["eager_steps"] == 3 and graphs.stats["replays"] == 6 + 2 + 1


def test_generate_grouped_counts_launches_executed(cuda):
    """33 launches a call (1 prefill + 32 replayed steps), at every unroll,
    the warm-up call's too, all at a few rows."""
    cfg, params, prompts = _model(cuda, "bfloat16")
    pool = demo_pool(cfg, 3, 8, None, cuda)
    idx = pool.lookup([None, "tenant-0", "tenant-1", "tenant-2"])
    want = generate_loop(params, cfg, prompts, pools=pool.pools(), idx=idx, max_new=32, device=cuda)
    for unroll in (1, 3, 32):
        for _ in range(2):
            K.reset_launches()
            got = generate_grouped(params, cfg, prompts, pool.pools(), idx, max_new=32, unroll=unroll,
                                   device=cuda)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert K.LAUNCHES["grouped_skip_sum_fwd"] == 33 and sum(K.LAUNCHES.values()) == 33
            assert K.ROW_LAUNCHES == {("grouped_skip_sum_fwd", "few_rows"): 33}


@pytest.mark.parametrize("reuse", [True, False])
def test_scheduler_graphed_chunks_equal_eager_chunks(cuda, reuse):
    cfg, params, _ = _model(cuda, "bfloat16")
    rng = np.random.default_rng(13)
    shared = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 4).astype(np.int32)]) for _ in range(6)]
    out = {}
    for loop in (False, True):
        rt = demo_runtime(cfg, 2, 8, None, params, cuda)
        sched = RequestScheduler(rt, max_batch=2, max_prompt=16, max_new_cap=5, admit_bucket=2,
                                 inflight_per_tenant=6, chunk=3, prefix_reuse=reuse, kv_block=4, loop=loop)
        reqs = [sched.submit(f"tenant-{i % 2}", p, max_new=5, temperature=0.7 * (i % 2)) for i, p in
                enumerate(prompts)]
        sched.drain()
        out[loop] = ([r.result().tolist() for r in reqs], dict(sched.counters))
    assert out[False] == out[True]


def test_a_failed_capture_raises_and_runs_no_eager_steps(cuda, monkeypatch):
    cfg, params, prompts = _model(cuda, "bfloat16")
    pool = demo_pool(cfg, 3, 8, None, cuda)
    real = K.LIB.launch

    def launch(name, x, *args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: refused inside a capture")
        real(name, x, *args)

    monkeypatch.setattr(K.LIB, "launch", launch)
    graphs = DG.GraphCache()
    K.reset_launches()
    with pytest.raises(DG.GraphCaptureError, match="refused inside a capture"):
        _decode_both(cfg, params, prompts, pool, 0.0, 3, graphs)
    # the warm-up step ran; no other step did
    assert K.LAUNCHES["grouped_skip_sum_fwd"] == 1 + 1 and graphs.stats["replays"] == 0


def test_evicting_a_graph_frees_its_memory(cuda):
    cfg, params, prompts = _model(cuda, "bfloat16")
    pool = demo_pool(cfg, 3, 8, None, cuda)
    graphs = DG.GraphCache(capacity=1)
    _decode_both(cfg, params, prompts, pool, 0.0, 3, graphs)
    static = sum(t.nbytes for c in graphs._entries[next(iter(graphs._entries))].state["caches"]
                 for t in c.values())
    _decode_both(cfg, params, prompts, pool, 0.0, 2, graphs)    # another unroll: evicts the first
    assert graphs.stats["evictions"] == 1 and len(graphs) == 1
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved(cuda)
    graphs.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the entry's static caches and its graphs' pool went back to the device
    assert held - torch.cuda.memory_reserved(cuda) >= static > 0
