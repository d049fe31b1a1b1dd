"""The MLP epochs as CUDA-graph replays (``core.finetune``) against the eager
loop, on the card.

Every test here needs a CUDA device (CUDA graphs have no CPU mode); without
one they skip. The file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_mlp_graph_gpu.py

Fan width (256-96-96-3), 47 samples (batch 20: a wrapped last batch), seeded
weights and data, TF32 off. Bars: each method's graphed epochs give the
eager loop's losses and trainable leaves bitwise, and Skip2-LoRA's populate
and cached epochs also its cache; an entry captures once and replays for
any index matrix; an epoch leaves its arguments untouched and hands out
tensors no later replay writes; a capture inside which a step raises
surfaces the error as ``GraphCaptureError`` and replays nothing."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import finetune as F  # noqa: E402
from repro_torch.core import methods as M  # noqa: E402
from repro_torch.core import skip_cache as C  # noqa: E402
from repro_torch.core.cuda_graph import GraphCache, GraphCaptureError  # noqa: E402
from repro_torch.models.mlp import MLPConfig, init_mlp  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

pytestmark = pytest.mark.gpu

CFG = MLPConfig(256, 96, 3, lora_rank=4)
N, BATCH, LR = 47, 20, 0.05


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(dev, method):
    g = torch.Generator().manual_seed(0)
    bb = init_mlp(g, CFG, device=dev)
    x = torch.randn((N, CFG.in_dim), generator=g).to(dev)
    y = torch.randint(0, CFG.out_dim, (N,), generator=g).to(dev)
    t, f = M.init_method(g, CFG, bb, method)
    idx = [F.epoch_index_matrix(g, N, BATCH, device=dev) for _ in range(3)]
    return t, f, x, y, idx


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(u, v) for u, v in zip(la, lb))


@pytest.mark.parametrize("method", [m for m in M.METHODS if m != "skip2_lora"])
def test_graphed_epochs_equal_the_eager_loop_bitwise(cuda, method):
    t, f, x, y, idx = _setup(cuda, method)
    graphs = GraphCache()
    out = {}
    for loop in (False, True):
        epoch = F.make_epoch_fn(method, CFG, loop=loop, graphs=graphs)
        tt, losses = t, []
        for m in idx:
            tt, ls = epoch(tt, f, x, y, m, LR)
            losses.append(ls)
        out[loop] = (tt, torch.stack(losses))
    assert torch.equal(out[False][1], out[True][1])
    assert _equal(out[False][0], out[True][0])
    assert graphs.stats["captures"] == 1 and graphs.stats["replays"] == 3 and graphs.stats["hits"] == 2


def test_skip2_populate_and_cached_epochs_equal_the_eager_loop_bitwise(cuda):
    t, f, x, y, idx = _setup(cuda, "skip2_lora")
    graphs = GraphCache()
    out = {}
    for loop in (False, True):
        pop, cached = F.make_skip2_epoch_fns(CFG, loop=loop, graphs=graphs)
        tt, cache, ls0 = pop(t, f, C.cache_for_mlp(N, CFG.dims, device=cuda), x, y, idx[0], LR)
        losses = [ls0]
        for m in idx[1:]:
            tt, ls = cached(tt, cache, x, y, m, LR)
            losses.append(ls)
        out[loop] = (tt, cache, torch.cat(losses))
    assert torch.equal(out[False][2], out[True][2])
    assert _equal(out[False][0], out[True][0])
    assert _equal(out[False][1].slots, out[True][1].slots) and torch.equal(out[False][1].valid, out[True][1].valid)
    assert int(out[False][1].hit_count()) == N
    assert graphs.stats["captures"] == 2 and graphs.stats["replays"] == 3


def test_finetune_replays_one_graph_per_phase(cuda):
    _, _, x, y, _ = _setup(cuda, "skip2_lora")
    bb = init_mlp(torch.Generator().manual_seed(0), CFG, device=cuda)
    F.GRAPHS.clear()
    F.GRAPHS.stats.clear()
    runs = [F.finetune(torch.Generator().manual_seed(4), "skip2_lora", CFG, bb, x, y, epochs=4, loop=loop)
            for loop in (False, True)]
    assert runs[0].losses == runs[1].losses and _equal(runs[0].trainable, runs[1].trainable)
    assert F.GRAPHS.stats["captures"] == 2 and F.GRAPHS.stats["replays"] == 4


def test_epochs_leave_their_arguments_and_results_alone(cuda):
    t, f, x, y, idx = _setup(cuda, "lora_all")
    before = [v.clone() for v in tree_leaves(t)]
    epoch = F.make_epoch_fn("lora_all", CFG, graphs=GraphCache())
    t1, ls1 = epoch(t, f, x, y, idx[0], LR)
    kept = [v.clone() for v in tree_leaves(t1)] + [ls1.clone()]
    epoch(t1, f, x, y, idx[1], LR)       # a replay over the same static buffers
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(t)))
    assert all(torch.equal(a, b) for a, b in zip(kept, tree_leaves(t1) + [ls1]))


def test_a_failed_capture_raises_and_replays_nothing(cuda, monkeypatch):
    t, f, x, y, idx = _setup(cuda, "skip_lora")
    real = M.sgd_

    def sgd_(trainable, grads, lr):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("update refused inside a capture")
        return real(trainable, grads, lr)

    monkeypatch.setattr(M, "sgd_", sgd_)
    graphs = GraphCache()
    with pytest.raises(GraphCaptureError, match="update refused inside a capture"):
        F.make_epoch_fn("skip_lora", CFG, graphs=graphs)(t, f, x, y, idx[0], LR)
    assert graphs.stats["warmup_steps"] == 1 and graphs.stats["captures"] == 0 and graphs.stats["replays"] == 0
