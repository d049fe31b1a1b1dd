"""The dry-run's counter, the recurrent mixers on a group and the int8
optimizer state on the card.

Every test needs a CUDA device; without one they skip. The file imports no
JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_dryrun_gpu.py

  - reduced stablelm-1.6b and xlstm-350m cells of every step kind, counted
    on meta and on the card (one device and the group ``[cuda:0, cuda:0]``)
    under ``launch.op_analysis.OpCounter``: dot FLOPs, collective bytes and
    argument bytes equal, all FLOPs and bytes accessed within 0.1 %;
  - reduced float32 xlstm-350m and jamba-1.5-large split over
    ``[cuda:0, cuda:0]`` against the unsplit backbone on the card: prefill
    logits within 1e-4 of the largest value, the states after it gathering
    to the unsplit ones (fp32 within 1e-4, bf16 within an ulp), three decode
    steps within 1e-3, greedy tokens equal;
  - rematerialisation: a reduced stablelm-1.6b ``train`` cell on 1 x 1 and
    on ``[cuda:0, cuda:0]``, counted on meta and on the card with each
    period rematerialised and with ``remat.region`` a plain call: the
    counts equal between meta and the card either way, the loss and new
    parameters bitwise between the two, the counted temp bytes lower with
    remat;
  - context parallelism: a reduced paligemma-3b ``decode`` cell on
    ``[cuda:0, cuda:0]`` (one KV head: its caches split by sequence),
    counted on meta and on the card: the same counts, each member's cache
    half the positions, the arguments' storages the allocator's requested
    bytes;
  - ``optim.quantized`` on the card against the CPU: five ``int8_adamw``
    steps (updates within 1e-6 of the largest, codes at most one step
    apart), ``compress_grads`` and the error-feedback residual bitwise."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.shapes import ShapeCell  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import remat as RM  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402
from repro_torch.optim import quantized as Q  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402

pytestmark = pytest.mark.gpu



@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


CELLS = {"train": ShapeCell("t", "train", 32, 2), "prefill": ShapeCell("p", "prefill", 32, 2),
         "decode": ShapeCell("d", "decode", 32, 2)}


def _cell(kind):
    return CELLS[{"finetune_populate": "train", "finetune_cached": "train", "decode_adapted": "decode"}.get(kind, kind)]


def _rel(a, b):
    return float((a.float().cpu() - b.float().cpu()).abs().max() / b.float().abs().max().cpu())


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "xlstm-350m"])
def test_meta_counts_equal_the_cards(arch, n):
    cfg = reduce_config(get_config(arch), n_periods=1)
    mesh = SH.make_mesh((1, n), ("data", "model"), devices=["meta"] * n)
    dev = torch.device("cuda", 0)
    for kind in ST.STEP_KINDS:
        meta = D.count_cell(D.prepare_cell(cfg, _cell(kind), kind, mesh=mesh))
        card = D.count_cell(D.prepare_cell(cfg, _cell(kind), kind, mesh=mesh, group=[dev] * n))
        for f in ("dot_flops", "collective_bytes", "collective_count", "argument_size_in_bytes"):
            assert card[f] == meta[f], (kind, f, card[f], meta[f])
        # the engine accumulates a gradient read twice in place on the card
        # and anew on meta, which moves a few bytes of a training step
        for f in ("flops", "bytes_accessed"):
            assert abs(card[f] - meta[f]) <= 1e-3 * meta[f], (kind, f, card[f], meta[f])


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_recurrent_split_on_one_card(arch):
    cfg = dataclasses.replace(reduce_config(get_config(arch), n_periods=1), vocab_size=512)
    dev = torch.device("cuda", 0)
    params = TL.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    norms = [params["final_norm"]] + [v for layer in params["stack"] for k, v in layer.items() if k.startswith("norm")]
    for p in norms:
        if "scale" in p:
            p["scale"].fill_(1.0)      # the reference's zero RMSNorm scales would zero every block
    gp = TP.group_params(params, [dev, dev])
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen, device=dev)
    c1 = TL.init_serve_caches(cfg, 2, 16, device=dev)
    c2 = TL.init_serve_caches(cfg, 2, 16, device=dev, params=gp)
    with torch.no_grad():
        l1, _ = TL.serve_prefill(params, cfg, tokens, c1)
        l2, _ = TL.serve_prefill(gp, cfg, tokens, c2)
        assert _rel(l2, l1) <= 1e-4, _rel(l2, l1)
        # the states after the prefill (a decode step reads the bf16 conv
        # windows, an ulp apart between the runs, into the fp32 memories)
        for a, b in zip(c1, c2):
            for k in a:
                tol = 2.0 ** -7 if a[k].dtype == torch.bfloat16 else 1e-4
                assert _rel(TP.whole(b[k]), a[k]) <= tol, (k, _rel(TP.whole(b[k]), a[k]))
        for step in range(3):
            tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen, device=dev)
            d1, _ = TL.serve_decode(params, cfg, tok, 9 + step, c1)
            d2, _ = TL.serve_decode(gp, cfg, tok, 9 + step, c2)
            assert _rel(d2, d1) <= 1e-3, (step, _rel(d2, d1))
        toks = []
        for p in (params, gp):
            caches = TL.init_serve_caches(cfg, 2, 16, device=dev, params=p)
            logits, caches = TL.serve_prefill(p, cfg, tokens, caches)
            toks.append(TL.decode_scan(p, cfg, torch.argmax(logits, -1), 9, caches, max_new=5)[0])
    assert torch.equal(toks[0], toks[1]), (toks[0].tolist(), toks[1].tolist())


@pytest.mark.parametrize("n", [1, 2])
def test_remat_train_cell_meta_equals_the_card(n, monkeypatch):
    """Four layers at 4 x 128, where the layers' activations set the peak
    (at 2 x 32 the readout's does, the same either way)."""
    cfg = reduce_config(get_config("stablelm-1.6b"), n_periods=4)
    mesh = SH.make_mesh((1, n), ("data", "model"), devices=["meta"] * n)
    dev = torch.device("cuda", 0)
    shape = ShapeCell("t", "train", 128, 4)
    recs, outs = {}, {}
    for remat in (True, False):
        with monkeypatch.context() as m:
            if not remat:
                m.setattr(RM, "region", lambda fn, *args: fn(*args))
            meta = D.count_cell(D.prepare_cell(cfg, shape, "train", mesh=mesh))
            cell = D.prepare_cell(cfg, shape, "train", mesh=mesh, group=[dev] * n)
            card = D.count_cell(cell)
            new, _, loss = cell.fn(*cell.args)
        for f in ("dot_flops", "collective_bytes", "collective_count", "argument_size_in_bytes"):
            assert card[f] == meta[f], (remat, f, card[f], meta[f])
        recs[remat], outs[remat] = card, [loss] + SH._leaves(ST.trainable_tree(new)[0])
    assert all(torch.equal(a, b) for a, b in zip(outs[True], outs[False], strict=True))
    assert recs[True]["dot_flops"] > recs[False]["dot_flops"]
    assert recs[True]["temp_size_in_bytes"] < recs[False]["temp_size_in_bytes"]


def test_context_parallel_decode_cell_on_the_card():
    cfg = reduce_config(get_config("paligemma-3b"))
    mesh = SH.make_mesh((1, 2), ("data", "model"), devices=["meta"] * 2)
    dev = torch.device("cuda", 0)
    shape = ShapeCell("d", "decode", 64, 4)
    meta = D.count_cell(D.prepare_cell(cfg, shape, "decode", mesh=mesh))
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    cell = D.prepare_cell(cfg, shape, "decode", mesh=mesh, group=[dev, dev])
    torch.cuda.synchronize()
    held = torch.cuda.memory_stats()["requested_bytes.all.current"] - before
    for c in cell.args[3]:
        for k in ("k", "v"):
            assert TP.seq_split(c[k]) and [p.shape[-3] for p in c[k].parts] == [32, 32]
    card = D.count_cell(cell)
    for f in ("dot_flops", "collective_bytes", "collective_count", "argument_size_in_bytes"):
        assert card[f] == meta[f], (f, card[f], meta[f])
    assert [m["dot_flops"] for m in card["per_member"]] == [m["dot_flops"] for m in meta["per_member"]]
    assert held == card["argument_bytes_all_members"], (held, card["argument_bytes_all_members"])


def test_quantized_on_the_card_against_the_cpu():
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((300, 70), generator=gen), "b": torch.randn((129,), generator=gen)}
    card = O.tree_map(lambda t: t.cuda(), params)
    opt = Q.int8_adamw(1e-2, weight_decay=0.1)
    s_cpu, s_gpu = opt.init(params), opt.init(card)
    for _ in range(5):
        g = O.tree_map(lambda t: torch.randn(t.shape, generator=gen), params)
        u_cpu, s_cpu = opt.update(g, s_cpu, params)
        u_gpu, s_gpu = opt.update(O.tree_map(lambda t: t.cuda(), g), s_gpu, card)
        for a, b in zip(O.tree_leaves(u_cpu), O.tree_leaves(u_gpu)):
            assert _rel(b, a) <= 1e-6
        for a, b in zip(O.tree_leaves([s_cpu.mu, s_cpu.nu]), O.tree_leaves([s_gpu.mu, s_gpu.nu])):
            if a.dtype == torch.int8:
                assert int((b.cpu().int() - a.int()).abs().max()) <= 1
        params, card = O.apply_updates(params, u_cpu), O.apply_updates(card, u_gpu)
    card = O.tree_map(lambda t: t.cuda(), params)          # the same inputs on both
    c_cpu, c_gpu = Q.compress_grads(params), Q.compress_grads(card)
    for a, b in zip(O.tree_leaves([c_cpu.q, c_cpu.scale]), O.tree_leaves([c_gpu.q, c_gpu.scale])):
        assert torch.equal(a, b.cpu())
    vals, idx = Q.topk_sparsify(params["w"], 0.05)
    assert torch.equal(Q.error_feedback_residual(params["w"], vals, idx),
                       Q.error_feedback_residual(card["w"], vals.cuda(), idx.cuda()).cpu())
