"""The port's full-backprop trainer (``repro_torch.launch.train``) against
the reference's (``repro.launch.train``), on the CPU.

Reduced float32 stablelm-1.6b, its weights from the reference's
``init_lm`` through ``repro_torch.convert``, the same numpy batches from
the shared synthetic pipeline. Three ``make_step`` steps (AdamW with weight
decay 0.1, clipping at global norm 1) must track the reference's losses
within 1e-4 relative and its parameters within 1e-4 of each leaf's largest
value: the two sum the readout's log-softmax and the products in different
orders, and AdamW's first steps move every weight by about the learning
rate whatever the gradient's size, so a gradient element near zero may take
another sign. The port holds its own bars bitwise: the scan chunk (the
eager loop on the CPU) equals the per-step path, and a resumed CLI run
equals an uninterrupted one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.data.pipeline import DataConfig, make_pipeline  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.models.lm import init_lm as j_init_lm  # noqa: E402
from repro.optim.optimizers import adamw as j_adamw  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.optim.optimizers import adamw as t_adamw, tree_leaves, tree_map  # noqa: E402

BATCH, SEQ, STEPS, LR = 4, 16, 3, 3e-4


@pytest.fixture(autouse=True)
def one_thread():
    """Small products: one intra-op thread runs them fastest and spares the
    cores other test processes share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = reduce_config(get_config("stablelm-1.6b"))
    jp = j_init_lm(jax.random.key(0), cfg)
    tp = C.params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    store, sampler = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                                              num_samples=64))
    batches = [store.batch(sampler.next_ids()) for _ in range(STEPS)]
    return cfg, jp, tp, batches


def _t_batch(b):
    return {"tokens": torch.as_tensor(b["tokens"]), "labels": torch.as_tensor(b["labels"])}


def test_make_step_tracks_the_reference(setup):
    cfg, jp, tp, batches = setup
    jopt, topt = j_adamw(LR, weight_decay=0.1), t_adamw(LR, weight_decay=0.1)
    jstep, tstep = JT.make_step(cfg, jopt), TT.make_step(cfg, topt)
    jst, tst = jopt.init(jp), topt.init(tp)
    jl, tl = [], []
    for b in batches:
        jp, jst, loss = jstep(jp, jst, {k: jax.numpy.asarray(b[k]) for k in ("tokens", "labels")})
        jl.append(float(loss))
        tp, tst, loss = tstep(tp, tst, _t_batch(b))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0], tl
    want = C.params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    for got, ref in zip(tree_leaves(tp), tree_leaves(want), strict=True):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        err = (got - ref).abs().max().item()
        assert err <= 1e-4 * max(ref.abs().max().item(), 1.0), err


def test_scan_chunk_equals_per_step_path(setup):
    cfg, _, tp, _ = setup
    opt = t_adamw(LR, weight_decay=0.1)
    store, _ = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, num_samples=16))
    staged = store.batch(np.arange(16))
    tokens, labels = torch.as_tensor(staged["tokens"]), torch.as_tensor(staged["labels"])
    idx = torch.as_tensor(np.random.default_rng(5).integers(0, 16, size=(3, BATCH)))
    step = TT.make_step(cfg, opt)
    p, st, want = tp, opt.init(tp), []
    for ids in idx:
        p, st, loss = step(p, st, {"tokens": tokens[ids], "labels": labels[ids]})
        want.append(loss)
    p2, st2, losses = TT.make_scan_chunk(cfg, opt)(tp, opt.init(tp), tokens, labels, idx)
    assert torch.equal(losses, torch.stack(want))
    for a, b in zip(tree_leaves(p2) + tree_leaves(st2.mu) + tree_leaves(st2.nu) + [st2.step],
                    tree_leaves(p) + tree_leaves(st.mu) + tree_leaves(st.nu) + [st.step], strict=True):
        assert torch.equal(a, b)


def test_chunk_graph_key_holds_the_storage_of_the_state_and_the_data(setup):
    """A chunk's graph entry (``chunk_key``) is keyed on the storage of the
    params and moments it donates and of the tokens and labels it reads:
    two token tensors, or two states, of equal shapes give two entries, so
    neither caller's tensors land in the other's buffers; the buffers handed
    back reuse theirs."""
    from repro_torch.core.cuda_graph import GraphCache

    cfg, _, tp, _ = setup
    opt = t_adamw(LR, weight_decay=0.1)
    tokens = [torch.zeros((16, SEQ), dtype=torch.int32) for _ in range(2)]
    labels = torch.zeros((16, SEQ), dtype=torch.int32)
    idx = torch.zeros((3, BATCH), dtype=torch.long)
    states = [(tp, opt.init(tp)), (tree_map(torch.clone, tp), opt.init(tp))]
    graphs = GraphCache(capacity=8)

    def entry(p, st, tok):
        return graphs.entry(TT.chunk_key(cfg, opt, p, st, tok, labels, idx), object)

    first = entry(*states[0], tokens[0])
    assert entry(*states[0], tokens[1]) is not first      # other tokens
    assert entry(*states[1], tokens[0]) is not first      # another state, params and moments
    assert entry(states[0][0], states[1][1], tokens[0]) is not first   # other moments
    assert entry(*states[0], tokens[0]) is first          # the buffers handed back
    assert len(graphs) == 4


def test_storage_sig_tells_strides_apart():
    """A graph addresses memory by pointer, shape and strides: a transposed
    square weight (same pointer, same shape) keys another entry."""
    from repro_torch.core.cuda_graph import storage_sig

    w = torch.zeros((8, 8))
    assert storage_sig({"w": w}) != storage_sig({"w": w.t()})
    assert storage_sig({"w": w}) == storage_sig({"w": w.view(8, 8)})


def _cli(tmp_path, *extra):
    return TT.main(["--device", "cpu", "--batch", "2", "--seq", "8", "--log-every", "1",
                    "--ckpt-dir", str(tmp_path / "ck"), *extra])


def test_cli_checkpoints_and_resumes(tmp_path):
    full = _cli(tmp_path / "a", "--steps", "4", "--ckpt-every", "100")
    first = _cli(tmp_path / "b", "--steps", "2", "--ckpt-every", "2")
    assert (tmp_path / "b" / "ck" / "ckpt_00000002" / "manifest.json").exists()
    resumed = _cli(tmp_path / "b", "--steps", "4", "--ckpt-every", "2")
    assert first["losses"] + resumed["losses"] == full["losses"]
    assert len(resumed["losses"]) == 2 and all(np.isfinite(full["losses"]))
    for a, b in zip(tree_leaves(resumed["params"]), tree_leaves(full["params"]), strict=True):
        assert torch.equal(a, b)
    chunked = _cli(tmp_path / "c", "--steps", "4", "--ckpt-every", "3", "--scan-chunk", "3")
    assert chunked["losses"] == full["losses"] and chunked["chunks"] == [3, 1]
    assert (tmp_path / "c" / "ck" / "ckpt_00000003" / "manifest.json").exists()
