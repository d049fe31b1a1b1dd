"""Context parallelism: K/V caches split by sequence over a model group
(``tp.init_caches``, ``tp.attend_split``) and over data shards in the
dry-run (``launch.dryrun``), where the reference's ``cache_specs`` split
them.

  - A sequence-split prefill and decode over ``["cpu"] * 2`` and ``* 4``
    against the unsplit run (the same group, its caches whole on the home
    device): reduced paligemma-3b (one KV head) and reduced gemma2-9b on
    four members (two KV heads; window 8 and the logit softcap), at int,
    0-d and per-row positions, with steps where a member's whole range lies
    after the position or before the window. In float32, each attention
    layer's output within 1e-6 of its largest value, the prefill's logits
    too and its caches bitwise; each decode step's logits (from the same
    caches) within ``LOGIT_BAR``; greedy tokens equal, the one-device
    run's too; each
    member's part holds its own positions only, and its bytes are
    ``sharding.per_device_bytes`` of ``steps.cache_specs``.
  - The request scheduler over a split session with prefix reuse: its
    tokens equal the unsplit session's, reuse admissions included.
  - A reduced jamba ``long_500k``-kind cell (batch 1) on a 2 x 1 meta
    mesh: the shard's K/V bytes are half the 1 x 1 record's, the merge of
    the shards' partials is the record's all-gather bytes, and there is no
    ``note``.
  - The reference's reduced paligemma ``decode`` cell compiled on a 1 x 2
    mesh (forced host devices, in a subprocess): its per-device HLO dot
    FLOPs against the port's home member's.

One intra-op thread."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import lm_skiplora as SL  # noqa: E402
from repro_torch.core.runtime import SessionRuntime  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.shapes import ShapeCell  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402

SEQ = 16          # cache positions: 8 or 4 a member
PROMPT = 5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch):
    cfg = reduce_config(get_config(arch))
    params = LM.init_lm(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    for p in [params["final_norm"]] + [v for layer in params["stack"] for k, v in layer.items() if "norm" in k]:
        p["scale"].copy_(1 + 0.1 * torch.randn(p["scale"].shape, generator=g))   # live norms (init: 0)
    return cfg, params


#: the one-device run against the group's: a few bf16 ulps of a cached key
ONE_DEVICE_BAR = 2e-3
#: a decode step's logits, split against unsplit in float32. The split
#: attention is within 1e-6 of the unsplit one (a few float32 ulps of its
#: largest value, ``test_split_attention_layer``), and the rest of the
#: model carries an ulp of an attention output into the logits at the
#: float32 floor of these reduced models: the exact (float64) attention
#: against the float32 one moves reduced gemma2's logits by up to 2.7e-6
#: of their largest value, as much as the split does
LOGIT_BAR = 1e-5


def _close(got, want, tol=1e-6):
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, want.abs().max().item())


CASES = [("paligemma-3b", 2), ("paligemma-3b", 4), ("gemma2-9b", 4)]


@pytest.mark.parametrize("arch,n", CASES)
def test_split_decode_equals_the_unsplit_one(arch, n):
    """The group with its caches split by sequence against the same group
    with its caches whole on the home device (``attention.attend``): the
    same K/V, so what differs is the split attention and its merge. The
    one-device run differs from both already in its projections (Megatron's
    partial sums), which a bf16 cache can turn into an ulp of a cached
    key: it is held to ``ONE_DEVICE_BAR`` and equal greedy tokens."""
    cfg, params = _model(arch)
    assert cfg.n_kv_heads % n and SEQ % n == 0
    gp = TP.group_params(params, ["cpu"] * n)
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, PROMPT)))
    c0 = LM.init_serve_caches(cfg, 2, SEQ, device="cpu")
    c1 = LM.init_serve_caches(cfg, 2, SEQ, device="cpu")
    c2 = LM.init_serve_caches(cfg, 2, SEQ, device="cpu", params=gp)
    k = c2[0]["k"]
    assert TP.seq_split(k) and k.ranges == [(i * SEQ // n, (i + 1) * SEQ // n) for i in range(n)]
    l0, _ = LM.serve_prefill(params, cfg, tokens, c0)
    l1, _ = LM.serve_prefill(gp, cfg, tokens, c1)
    l2, _ = LM.serve_prefill(gp, cfg, tokens, c2)
    _close(l2, l1)
    _close(l2, l0, ONE_DEVICE_BAR)
    for a, b in zip(c1, c2):
        for name in ("k", "v"):
            assert torch.equal(TP.whole(b[name]), a[name])
    # positions 5..14: members whose whole range lies after the position
    # (5 on four members: [8, 12), [12, 16)), and, on gemma2's local layers
    # (window 8), ranges wholly before the window. Each step starts from
    # the unsplit run's caches: an ulp of a hidden state can round a key
    # written into a bf16 cache the other way, and later steps would read it
    steps = [5, torch.tensor(6), torch.tensor([7, 7]), 8, torch.tensor([9, 11]), torch.tensor(12), 14]
    for pos in steps:
        for a, b in zip(c1, c2):
            for name in ("k", "v"):
                b[name][:, :] = a[name]
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1)))
        l0, _ = LM.serve_decode(params, cfg, tok, pos, c0)
        l1, _ = LM.serve_decode(gp, cfg, tok, pos, c1)
        l2, _ = LM.serve_decode(gp, cfg, tok, pos, c2)
        assert torch.isfinite(l2).all()
        _close(l2, l1, LOGIT_BAR)
        _close(l2, l0, ONE_DEVICE_BAR)
    outs = []
    for p, whole in ((params, True), (gp, True), (gp, False)):
        caches = LM.init_serve_caches(cfg, 2, SEQ, device="cpu", params=None if whole else p)
        logits, caches = LM.serve_prefill(p, cfg, tokens, caches)
        toks, _ = LM.decode_scan(p, cfg, torch.argmax(logits, -1), PROMPT, caches, max_new=SEQ - PROMPT)
        outs.append(toks)
    assert torch.equal(outs[2], outs[1]) and torch.equal(outs[2], outs[0])


@pytest.mark.parametrize("arch,n", CASES)
def test_split_attention_layer(arch, n):
    """One attention layer (global and, for gemma2, local) on random bf16
    caches and inputs, split against whole: within 1e-6 of its largest
    output, at positions where whole member ranges lie after the position
    or before the window, and on each position branch."""
    cfg, params = _model(arch)
    gp = TP.group_params(params, ["cpu"] * n)
    ga = gp["stack"][0]["attn"]
    g = torch.Generator().manual_seed(3)
    for local in ((False, True) if cfg.sliding_window else (False,)):
        spec = TP.A.AttnSpec.from_config(cfg, local=local)
        for pos in (3, 5, 9, 14, torch.tensor(7), torch.tensor([4, 12])):
            whole = {k: torch.randn((2, SEQ, cfg.n_kv_heads, spec.head_dim), generator=g).to(torch.bfloat16)
                     for k in ("k", "v")}
            x = torch.randn((2, 1, cfg.d_model), generator=g)
            split = TP.init_caches(gp, cfg, 2, SEQ)[0]
            for k in ("k", "v"):
                split[k][:, :] = whole[k]
            y1, _ = TP.attention(ga, x, spec, "decode", whole, pos)
            y2, _ = TP.attention(ga, x, spec, "decode", split, pos)
            _close(y2, y1)
            for k in ("k", "v"):
                assert torch.equal(split[k].whole(), whole[k])


@pytest.mark.parametrize("arch,n", CASES)
def test_member_parts_hold_their_own_positions(arch, n):
    cfg, params = _model(arch)
    gp = TP.group_params(params, ["cpu"] * n)
    mesh = SH.make_mesh((1, n), ("data", "model"), devices=["meta"] * n)
    shapes = LM.init_serve_caches(cfg, 2, SEQ, device="meta")
    specs = ST.cache_specs(shapes, mesh, ST.rules_for(ShapeCell("d", "decode", SEQ, 2), mesh))
    assert specs[0]["k"][1:] == (("model",), None, None)
    want = SH.per_device_bytes(shapes, specs, mesh)
    for stacked in (False, True):
        caches = (LM.init_stacked_caches(cfg, 2, SEQ, device="cpu", params=gp) if stacked
                  else LM.init_serve_caches(cfg, 2, SEQ, device="cpu", params=gp))
        tensors = [caches[n_] for n_ in ("k", "v")] if stacked else [c[n_] for c in caches for n_ in ("k", "v")]
        got = [sum(t.parts[i].numel() * t.parts[i].element_size() for t in tensors) for i in range(n)]
        if not stacked:
            assert got == [want] * n, (got, want)
        for t in tensors:
            assert t.axis == -3 and [hi - lo for lo, hi in t.ranges] == [p.shape[-3] for p in t.parts]
            assert all(a[1] == b[0] for a, b in zip(t.ranges, t.ranges[1:])) and t.ranges[-1][1] == SEQ
    # a prefill and a decode step write each position into its own part
    caches = LM.init_serve_caches(cfg, 2, SEQ, device="cpu", params=gp)
    seen = []
    for part in caches[0]["k"].parts:
        orig = part.clone()
        seen.append((part, orig))
    tokens = torch.zeros((2, 3), dtype=torch.long)
    LM.serve_prefill(gp, cfg, tokens, caches)
    LM.serve_decode(gp, cfg, torch.zeros((2, 1), dtype=torch.long), 3, caches)
    for i, (part, _) in enumerate(seen):
        lo, hi = caches[0]["k"].ranges[i]
        written = (part.abs().sum(dim=(0, 2, 3)) > 0).nonzero().flatten() + lo
        assert all(lo <= p < min(hi, 4) for p in written.tolist())
        assert sorted(written.tolist()) == list(range(lo, max(lo, min(hi, 4))))


def _session(cfg, params, n):
    mesh = None if n == 1 else SH.make_mesh((1, n), ("data", "model"), devices=["cpu"] * n)
    return SessionRuntime(cfg, SL.SkipLoRAConfig(rank=4), params, max_tenants=2, samples_per_tenant=1, seq=8,
                          use_kernel=False, mesh=mesh, device="cpu" if n == 1 else None)


def test_scheduler_with_prefix_reuse_keeps_its_tokens():
    cfg, params = _model("paligemma-3b")
    rng = np.random.default_rng(20)
    shared = rng.integers(0, cfg.vocab_size, 12)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 4)]) for _ in range(4)]
    outs = []
    for n in (1, 2):
        rt = _session(cfg, params, n)
        sched = rt.attach_scheduler(max_batch=4, max_prompt=16, max_new_cap=4, admit_bucket=2,
                                    inflight_per_tenant=4, chunk=2, kv_block=4)
        reqs = [rt.enqueue_serve(None, torch.as_tensor(p), max_new=4) for p in prompts]
        rt.drain()
        outs.append([r.result().tolist() for r in reqs])
        assert sched.counters["dispatch/admit_reuse"] >= 1
        if n == 2:
            assert TP.seq_split(sched._lb.caches["k"])
        rt.check_prefix_no_leaks()
    assert outs[0] == outs[1], outs


def _kv_bytes(caches):
    return sum(c[n].numel() * c[n].element_size() for c in caches if "k" in c for n in ("k", "v"))


def test_long_decode_splits_the_sequence_over_data_shards():
    cfg = reduce_config(get_config("jamba-1.5-large-398b"), n_periods=1)
    cell = ShapeCell("long", "decode", 64, 1)
    recs, cells = [], []
    for shape in ((1, 1), (2, 1)):
        mesh = SH.make_mesh(shape, ("data", "model"), devices=["meta"] * (shape[0] * shape[1]))
        c = D.prepare_cell(cfg, cell, "decode", mesh=mesh)
        cells.append(c)
        recs.append(D.count_cell(c))
    one, two = recs
    assert ST.rules_for(cell, cells[1].mesh).seq == "data" and cells[1].seq_shards == 2
    assert _kv_bytes(cells[1].args[3]) * 2 == _kv_bytes(cells[0].args[3]) > 0
    assert one["argument_size_in_bytes"] - two["argument_size_in_bytes"] == _kv_bytes(cells[1].args[3])
    n_attn = sum(k in ("attn", "attn_local") for k in cfg.layer_kinds())
    merge = n_attn * 2 * cfg.n_heads * (cfg.resolved_head_dim * 4 + 4)       # float32 partials + lse, 1 row
    assert two["collectives_per_op"] == {"all-gather": merge} and one["collective_bytes"] == 0
    assert "note" not in one and "note" not in two and two["seq_shards"] == 2


REF_PROG = textwrap.dedent(
    """
    import dataclasses, json
    import jax
    import numpy as np
    from repro.configs import get_config, reduce_config
    from repro.launch import hlo_analysis as H
    from repro.launch import steps as ST

    cfg = reduce_config(get_config("paligemma-3b"))
    ST.get_config = lambda arch: cfg
    ST.SHAPES = {"d": ST.ShapeCell("d", "decode", %d, 2)}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    fn, args, ins, outs = ST.build_cell("paligemma-3b", "d", mesh, "decode")
    with mesh:
        text = jax.jit(fn, in_shardings=ins, out_shardings=outs).lower(*args).compile().as_text()
    print(json.dumps({"dot_flops": H.analyze_dot_flops(text)}))
    """ % SEQ)


def test_home_member_dot_flops_against_the_reference_hlo():
    """The port's home member on a 1 x 2 group against the reference's
    per-device HLO: each attends every query head over half of the
    positions, and the projections, the MLP and the readout split as
    Megatron splits them."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", REF_PROG], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])["dot_flops"]
    cfg = reduce_config(get_config("paligemma-3b"))
    mesh = SH.make_mesh((1, 2), ("data", "model"), devices=["meta"] * 2)
    rec = D.count_cell(D.prepare_cell(cfg, ShapeCell("d", "decode", SEQ, 2), "decode", mesh=mesh))
    got = rec["per_member"][0]["dot_flops"]
    assert abs(got - want) <= 0.01 * want, (got, want)
