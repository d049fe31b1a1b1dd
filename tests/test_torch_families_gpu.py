"""The other model families on the card: MoE, recurrent and frontend stacks.

Every test here needs a CUDA device (and ``nvcc`` for the grouped kernel K5
inside the captured decode steps); without one they skip. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_families_gpu.py

Reduced qwen2-moe-a2.7b, jamba-1.5-large, xlstm-350m and paligemma-3b with
seeded weights (the RMSNorm scales set to 1: the reference's zero scales
would zero every block's input). Bars: the decode's graph replays give the
eager loop's tokens and final caches, KV and recurrent states, bitwise, in
bf16 and float32; a float32 config's forward and prefill agree between the
card and the CPU within 1e-5 of each fp32 output's largest value, and its
greedy tokens are equal."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.launch.serve import demo_pool  # noqa: E402
from repro_torch.models import frontend as FE  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402

pytestmark = pytest.mark.gpu

ARCHS = ["qwen2-moe-a2.7b", "jamba-1.5-large-398b", "xlstm-350m", "paligemma-3b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _model(arch, dtype, device):
    cfg = dataclasses.replace(reduce_config(get_config(arch)), dtype=dtype)
    params = TL.init_lm(torch.Generator().manual_seed(0), cfg)
    if cfg.norm_type == "rmsnorm" and not cfg.rmsnorm_unit_offset:
        for p in [params["final_norm"]] + [p for layer in params["stack"] for n, p in layer.items()
                                           if n.startswith(("norm", "post_norm"))]:
            p["scale"].fill_(1.0)
    return cfg, _to(params, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_replays_equal_the_eager_loop_bitwise(cuda, arch, dtype):
    cfg, params = _model(arch, dtype, cuda)
    b, s, new = 4, 10, 6
    g = torch.Generator(device=cuda).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=cuda)
    p = FE.frontend_prefix_len(cfg)
    prefix = torch.randn((b, p, cfg.d_model), generator=g, device=cuda) if p else None
    caches = TL.init_serve_caches(cfg, b, p + s + new, device=cuda)
    kw = {}
    if prefix is None:
        pool = demo_pool(cfg, 3, 4, None, cuda)
        kw = dict(pools=pool.pools(), idx=pool.lookup([None, "tenant-0", "tenant-1", "tenant-2"]))
        logits, caches = TL.serve_prefill_grouped(params, cfg, prompts, caches, kw["pools"], kw["idx"])
    else:
        logits, caches = TL.serve_prefill(params, cfg, prompts, caches, prefix_embeds=prefix)
    tok0 = TL.sample_token(logits, 0.0)

    def fresh():
        return [{n: t.clone() for n, t in c.items()} for c in caches]

    want, want_c = TL.decode_loop(params, cfg, tok0, p + s, fresh(), max_new=new, **kw)
    for unroll in (1, 4):
        got, got_c = TL.decode_scan(params, cfg, tok0, p + s, fresh(), max_new=new, unroll=unroll, **kw)
        assert torch.equal(got, want)
        for x, y in zip(got_c, want_c):
            assert x.keys() == y.keys() and all(torch.equal(x[n], y[n]) for n in x)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_float32_card_equals_cpu(cuda, arch):
    cfg, params = _model(arch, "float32", "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(4))
    p = FE.frontend_prefix_len(cfg)
    prefix = torch.randn((2, p, cfg.d_model), generator=torch.Generator().manual_seed(5)) if p else None
    outs = {}
    for where in ("cpu", cuda):
        with torch.no_grad():
            pw = _to(params, where)
            pre = None if prefix is None else prefix.to(where)
            fwd = TL.lm_forward(pw, cfg, tokens.to(where), prefix_embeds=pre)
            caches = TL.init_serve_caches(cfg, 2, p + 9 + 4, device=where)
            logits, caches = TL.serve_prefill(pw, cfg, tokens.to(where), caches, prefix_embeds=pre)
            # the prefill's fp32 states, before the decode writes over them in place
            named = {"h": fwd["h"], "aux": fwd["aux"], "logits": logits}
            named.update({f"layer {i} {n}": t.clone() for i, c in enumerate(caches) for n, t in c.items()
                          if t.dtype == torch.float32})
            toks, _ = TL.decode_scan(pw, cfg, TL.sample_token(logits, 0.0), p + 9, caches, max_new=4)
        outs[str(where)] = (named, toks)
    (cpu, toks_cpu), (card, toks_card) = outs["cpu"], outs[str(cuda)]
    for name, a in cpu.items():
        err, mag = (card[name].cpu() - a).abs().max().item(), a.abs().max().item()
        assert err <= 1e-5 * max(mag, 1e-30), f"{name}: card vs CPU {err:.3e} of max {mag:.3e}"
    assert torch.equal(toks_card.cpu(), toks_cpu)
