"""The model axis in the port (``models.tp``, the 2-D session mesh, the
pipelined admission, the CLI) on the CPU, over groups that repeat the CPU
device:

  - ``TestGroupForward``: the forward of a backbone split over a group
    (``tp.group_params``) against the reference's ``lm_forward`` on the same
    weights (float32, within 1e-4 of the largest value; the MoE aux too),
    for reduced stablelm-1.6b, qwen2-moe-a2.7b and paligemma-3b, at group
    sizes that take every branch of ``sharding._param_spec_for``: heads
    split with KV heads split (stablelm, qwen at 2) or whole (paligemma's
    one KV head, at 2 and 4), heads not dividing (``d_model`` split, ``wo``
    split by output: qwen at 16; all replicated: stablelm at 3), experts
    split (qwen at 2) or their hidden dimension (qwen at 16), vocabulary
    split (vocab 512) or replicated (503). Then the serve prefill, three
    decode steps (int, 0-d and per-row positions) and the caches (split by
    each member's KV heads or by sequence, ``tp.HeadSplit``), the
    chunked loss and its gradient, against the port's one-device run;
    ``tp.init_group_params`` against ``group_params`` of ``init_lm``.
  - ``TestSession2D``: ``tests/test_session_shard.py``'s 2-D bars, port
    against port on ``["cpu"] * 4``: a (2, 2) session and its pipelined
    twin against the 1-device twin with the same logical layout, tokens
    equal (the pipelined admission included), adapters within rtol 1e-4 /
    atol 1e-6, slot tables equal, backbone bytes a device down more than
    1.5-fold, ``predicted_bubble()`` = 1/3; the 2-D checkpoint restored
    into the 1-device twin, both continuing within the same bars; the
    refusals (``use_kernel``, N != M, a compressed pool under pipelining,
    a cache split for another group; a recurrent stack builds, its
    scheduler refused); a
    backbone split beforehand (``tp.GroupParams``) serving as the session
    that splits it.
  - ``launch.run --mesh 2x2 --pipeline-stages 2 --scheduler
    --check-parity`` in-process prints ``parity OK``.
  - The pipelined scheduler against the reference's: a (1 x 2) session with
    ``pipeline_stages=2`` in both packages on the same weights (norm scales
    drawn around 1), ingest, ``adapt`` (adapters within rtol 1e-4 / atol
    1e-6, the bar of ``TestSession2D``), then three requests through the
    scheduler: temperature-0 tokens, the counters dict and the predicted
    bubble equal. The reference runs in a subprocess over four forced host
    devices (``JAX_PLATFORMS=cpu`` set there explicitly).

One intra-op thread."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_config as j_reduce_config  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.checkpoint import checkpoint as CK  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro.core import fleet_finetune as JFF  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch.core import fleet_finetune as TFF  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.core.runtime import SessionRuntime  # noqa: E402
from repro_torch.launch import run  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _live_norms(tree, cfg, seed=0):
    """Norm scales drawn around an effective 1 (the reference's zero init
    would zero every block of qwen2-moe)."""
    rng = np.random.default_rng(seed)
    base = 0.0 if cfg.rmsnorm_unit_offset else 1.0

    def draw(path, x):
        if getattr(path[-1], "key", None) != "scale":
            return x
        return jnp.asarray(base + 0.1 * rng.normal(size=x.shape), x.dtype)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=1e-4):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"max diff {err:.3e} vs scale {np.abs(want).max():.3e}"


CASES = [
    # (arch, group size, vocab): the branches each case takes, see the docstring
    ("stablelm-1.6b", 2, 512),
    ("stablelm-1.6b", 3, None),
    ("qwen2-moe-a2.7b", 2, 512),
    ("qwen2-moe-a2.7b", 16, 512),
    ("paligemma-3b", 2, None),
    ("paligemma-3b", 4, 512),
]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-x{c[1]}-v{c[2]}")
def case(request):
    arch, n, vocab = request.param
    jcfg = j_reduce_config(j_get_config(arch))
    cfg = reduce_config(get_config(arch))
    if vocab:
        jcfg, cfg = dataclasses.replace(jcfg, vocab_size=vocab), dataclasses.replace(cfg, vocab_size=vocab)
    jp = _live_norms(JL.init_lm(jax.random.key(0), jcfg), jcfg)
    tp = C.params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    return jcfg, cfg, jp, tp, TP.group_params(tp, ["cpu"] * n)


class TestGroupForward:
    def test_branches_are_the_ones_named(self, case):
        _, cfg, _, _, gp = case
        n, layer = len(gp.devices), gp.specs["stack"][0]
        assert layer["attn"]["wq"][1] == ("model" if cfg.n_heads % n == 0 else None)
        assert gp.specs["embed"]["table"][0] == ("model" if cfg.vocab_size % n == 0 else None)
        if cfg.moe is not None:
            want = ("model", None, None) if cfg.moe.n_experts % n == 0 else (None, None, "model")
            assert layer["moe"]["w_gate"] == want

    def test_train_forward_matches_the_reference(self, case):
        jcfg, cfg, jp, _, gp = case
        tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
        want = JL.lm_forward(jp, jcfg, jnp.asarray(tokens), mode="train", collect_acts=True)
        got = TL.lm_forward(gp, cfg, torch.as_tensor(tokens), mode="train", collect_acts=True)
        _close(got["h"], want["h"])
        _close(got["acts"], want["acts"])
        np.testing.assert_allclose(float(got["aux"]), float(want["aux"]), rtol=1e-4, atol=1e-7)
        _close(TL.readout(gp, cfg, got["h"][:, -1:]), JL.readout(jp, jcfg, want["h"][:, -1:]))

    def test_serve_and_loss_match_one_device(self, case):
        _, cfg, _, tp, gp = case
        rng = np.random.default_rng(2)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int64))
        c1 = TL.init_serve_caches(cfg, 2, 12, device="cpu")
        c2 = TL.init_serve_caches(cfg, 2, 12, device="cpu", params=gp)
        # placed as the reference's cache_specs: split by each member's own KV
        # heads where they divide the group, else by sequence where the group
        # divides the 12 positions, else whole
        n = len(gp.devices)
        axis = -2 if cfg.n_kv_heads % n == 0 else (-3 if 12 % n == 0 else None)
        assert (c2[0]["k"].axis if isinstance(c2[0]["k"], TP.HeadSplit) else None) == axis
        l1, _ = TL.serve_prefill(tp, cfg, tokens, c1)
        l2, _ = TL.serve_prefill(gp, cfg, tokens, c2)
        _close(l2, l1)
        for pos in (7, torch.tensor(8), torch.tensor([9, 10])):
            tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1)))
            l1, _ = TL.serve_decode(tp, cfg, tok, pos, c1)
            l2, _ = TL.serve_decode(gp, cfg, tok, pos, c2)
            _close(l2, l1, tol=2e-4)
        for a, b in zip(c1, c2):
            _close(TP.whole(b["k"]), a["k"], tol=2.0**-7)          # bf16 caches: an ulp apart at most
            _close(TP.whole(b["v"]), a["v"], tol=2.0**-7)
        h = TL.lm_forward(tp, cfg, tokens, mode="train")["h"].detach()
        labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 7)))
        h1, h2 = h.clone().requires_grad_(True), h.clone().requires_grad_(True)
        loss1, loss2 = TL.lm_loss(tp, cfg, h1, labels), TL.lm_loss(gp, cfg, h2, labels)
        loss1.backward()
        loss2.backward()
        np.testing.assert_allclose(loss2.item(), loss1.item(), rtol=1e-5)
        _close(h2.grad, h1.grad, tol=1e-5)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-moe-a2.7b", "paligemma-3b"])
def test_init_group_params_splits_init_lms_draws(arch):
    """Drawn a part at a time and split as it comes, the members are
    ``group_params`` of ``init_lm`` from the same seed, bitwise, and
    ``prepare`` sees every part in draw order."""
    cfg = reduce_config(get_config(arch))
    want = TP.group_params(TL.init_lm(torch.Generator().manual_seed(3), cfg), ["cpu"] * 2)
    keys = []
    got = TP.init_group_params(torch.Generator().manual_seed(3), cfg, ["cpu"] * 2,
                               prepare=lambda key, tree: keys.append(key))
    assert keys == [k for k, _ in TL.init_parts(torch.Generator(), cfg)]
    assert keys[0] == "embed" and keys[1:1 + cfg.n_layers] == [("stack", i) for i in range(cfg.n_layers)]
    assert SH._leaves(got.specs) == SH._leaves(want.specs)
    for g, w in zip(got.members, want.members):
        for a, b in zip(SH._leaves(g), SH._leaves(w), strict=True):
            assert torch.equal(a, b)


def test_head_split_moves_rows_and_gathers_heads():
    """Overlapping ranges (two members sharing one KV head, paligemma's
    layout): indexing, assignment from a whole tensor or a ``HeadSplit``,
    iteration over the leading axis and ``whole``."""
    g = torch.Generator().manual_seed(0)
    full = torch.randn((2, 3, 5, 3, 4), generator=g)
    ranges = [(0, 2), (1, 3)]
    hs = TP.HeadSplit([torch.zeros((2, 3, 5, hi - lo, 4)) for lo, hi in ranges], ranges)
    assert hs.shape == full.shape and len(hs) == 2
    rows = torch.tensor([2, 0])
    hs[:, rows, :4] = full[:, :2, :4]
    want = torch.zeros_like(full)
    want[:, rows, :4] = full[:, :2, :4]
    assert torch.equal(hs.whole(), want)
    other = TP.HeadSplit([torch.zeros((2, 3, 5, hi - lo, 4)) for lo, hi in ranges], ranges)
    other[:, :, 1:] = hs[:, :, 1:]
    want2 = torch.zeros_like(full)
    want2[:, :, 1:] = want[:, :, 1:]
    assert torch.equal(other.whole(), want2)
    assert [torch.equal(layer.whole(), want2[i]) for i, layer in enumerate(other)] == [True, True]
    assert torch.equal(other.parts[0][..., 1, :], other.parts[1][..., 0, :])   # the shared head agrees
    with pytest.raises(ValueError, match="assigned into"):
        other[0] = TP.HeadSplit([p[0] for p in hs.parts], [(0, 1), (1, 3)])


def test_group_refusals():
    # recurrent stacks run on a group (they raised before the mixers were
    # split): the forward equals the unsplit one, the states split by d_inner
    cfg = reduce_config(get_config("jamba-1.5-large-398b"))
    tp = TL.init_lm(torch.Generator().manual_seed(0), cfg)
    gp = TP.group_params(tp, ["cpu"] * 2)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 4)))
    _close(TL.lm_forward(gp, cfg, tokens)["h"], TL.lm_forward(tp, cfg, tokens)["h"], tol=1e-5)
    xcfg = reduce_config(get_config("xlstm-350m"))
    xgp = TP.group_params(TL.init_lm(torch.Generator().manual_seed(0), xcfg), ["cpu"] * 2)
    states = TL.init_serve_caches(xcfg, 1, 6, device="cpu", params=xgp)
    assert isinstance(states[0]["conv"], TP.HeadSplit) and states[0]["conv"].axis == -1
    assert isinstance(states[0]["c"], TP.HeadSplit) and not isinstance(states[0]["n"], TP.HeadSplit)
    with pytest.raises(ValueError, match="states split over its members"):
        TL.serve_prefill(xgp, xcfg, torch.zeros((1, 4), dtype=torch.long), TL.init_serve_caches(xcfg, 1, 6, device="cpu"))
    small = reduce_config(get_config("stablelm-1.6b"))
    gp = TP.group_params(TL.init_lm(torch.Generator().manual_seed(0), small), ["cpu"] * 2)
    caches = TL.init_serve_caches(small, 1, 6, device="cpu", params=gp)
    other = TP.init_caches(TP.group_params(TL.init_lm(torch.Generator().manual_seed(0), small), ["cpu"] * 4),
                           small, 1, 6)
    TL.serve_prefill(gp, small, torch.zeros((1, 4), dtype=torch.long), caches)
    with pytest.raises(ValueError, match="reads KV heads"):
        TL.serve_prefill(gp, small, torch.zeros((1, 4), dtype=torch.long), other)
    with pytest.raises(ValueError, match="split by heads"):
        TL.serve_prefill(gp, small, torch.zeros((1, 4), dtype=torch.long),
                         TL.init_serve_caches(small, 1, 6, device="cpu"))
    with pytest.raises(IndexError, match="leading dimensions"):
        caches[0]["k"][:, :, 0]


# ---------------------------------------------------------------------------
# The 2-D session
# ---------------------------------------------------------------------------

SCFG = ModelConfig(name="t", family="test", n_layers=4, d_model=16, n_heads=4, n_kv_heads=2, d_ff=32,
                   vocab_size=64, pattern=("attn",), dtype="float32")
SL = TSL.SkipLoRAConfig(rank=2, mode="full")


def _ints(seed, shape):
    return np.random.default_rng(seed).integers(0, SCFG.vocab_size, shape).astype(np.int32)


def _adapters_close(a, b):
    for k in ("A", "B"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-4, atol=1e-6)


class TestSession2D:
    @pytest.fixture(scope="class")
    def sessions(self, tmp_path_factory):
        params = TL.init_lm(torch.Generator().manual_seed(0), SCFG)
        g = torch.Generator().manual_seed(1)
        for p in [params["final_norm"]] + [v for layer in params["stack"] for k, v in layer.items()
                                           if k.startswith("norm")]:
            p["scale"].copy_(1 + 0.1 * torch.randn(p["scale"].shape, generator=g))   # live norms (init: 0)
        mesh = SH.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)

        def build(mesh=None, stages=0):
            return SessionRuntime(SCFG, SL, params, max_tenants=4, samples_per_tenant=8, seq=6,
                                  use_kernel=False, mesh=mesh, placement_shards=2, seed=0,
                                  pipeline_stages=stages, device="cpu" if mesh is None else None)

        rts = build(), build(mesh), build(mesh, 2)
        tokens, labels = _ints(5, (2, 6)), _ints(6, (2, 6))
        for rt in rts:
            for t in ("a", "b", "c"):
                rt.ingest(t, tokens, labels)
            rt.adapt(["a", "b", "c"], epochs=2, generator=torch.Generator().manual_seed(7))
        return params, build, rts, tmp_path_factory.mktemp("ck")

    def test_layout_and_backbone_bytes(self, sessions):
        params, _, (rt1, rt2, rtp), _ = sessions
        assert rt2.model_parallel == 2 and rt2.n_shards == 2 and rtp.pipeline_stages == 2
        assert rt1.model_parallel == 1 and rt1._scope == [None, None]
        assert [str(d) for d in rt2._group(1)] == ["cpu", "cpu"] and rt2._scope[0].mesh.size == 2
        total = sum(x.numel() * x.element_size() for x in SH._leaves(params))
        per = max(sum(x.numel() * x.element_size() for x in SH._leaves(m)) for m in rt2._shard_params[0].members)
        assert total / per > 1.5, (total, per)
        assert rt2.session_state()[1]["layout"]["model_parallel"] == 2
        assert rtp.session_state()[1]["layout"]["pipeline_stages"] == 2

    def test_adapters_slots_and_serve_tokens(self, sessions):
        _, _, (rt1, rt2, rtp), _ = sessions
        assert not torch.equal(rt1.tenant("a").adapters["B"], torch.zeros_like(rt1.tenant("a").adapters["B"]))
        for rt in (rt2, rtp):
            for t in ("a", "b", "c"):
                _adapters_close(rt1.tenant(t).adapters, rt.tenant(t).adapters)
            assert rt1.pool.slot_table() == rt.pool.slot_table()
        prompts = _ints(4, (2, 5))
        want = rt1.serve([None, "a"], prompts, max_new=4)
        assert torch.equal(rt2.serve([None, "a"], prompts, max_new=4), want)
        assert torch.equal(rtp.serve(["b", "a"], prompts, max_new=4), rt1.serve(["b", "a"], prompts, max_new=4))

    def test_scheduler_tokens_equal_with_pipelined_admission(self, sessions):
        _, _, rts, _ = sessions
        prompts, outs = _ints(4, (2, 5)), []
        for rt in rts:
            rt.attach_scheduler(max_batch=4, max_prompt=5, max_new_cap=8, admit_bucket=2, chunk=2)
            reqs = [rt.enqueue_serve("a", prompts[0, :4], max_new=6), rt.enqueue_serve(None, prompts[1, :3], max_new=5)]
            rt.drain()
            outs.append([r.result().tolist() for r in reqs])
        assert outs[0] == outs[1] == outs[2], outs
        pipe = rts[2].scheduler
        assert pipe.predicted_bubble() == pytest.approx(1 / 3, abs=1e-12) and pipe.admit_pad == 2
        assert pipe.counters["dispatch/admit_pipe"] >= 1 and pipe.counters["dispatch/admit"] == 0
        assert not pipe.prefix_reuse and rts[1].scheduler.prefix_reuse
        assert rts[1].scheduler.predicted_bubble() is None
        for rt in rts[1:]:
            # the live batch keeps each member's KV head on its device
            k = rt.scheduler._lb.caches["k"]
            assert isinstance(k, TP.HeadSplit) and k.ranges == [(0, 1), (1, 2)] and k.parts[0].shape[-2] == 1

    def test_checkpoint_restores_into_the_one_device_twin(self, sessions):
        _, build, (_, rt2, _), ck = sessions
        path = CK.save_runtime_session(str(ck), 1, rt2)
        back = build()
        CK.restore_runtime_session(path, back)
        tokens, labels = _ints(5, (2, 6)), _ints(6, (2, 6))
        for rt in (rt2, back):
            for t in ("a", "b", "c"):
                rt.ingest(t, labels, tokens)
            rt.adapt(["a", "b", "c"], epochs=1, generator=torch.Generator().manual_seed(8))
        for t in ("a", "b", "c"):
            _adapters_close(rt2.tenant(t).adapters, back.tenant(t).adapters)
        assert rt2.pool.slot_table() == back.pool.slot_table()
        prompts = _ints(4, (2, 5))
        assert torch.equal(rt2.serve([None, "b"], prompts, max_new=4), back.serve([None, "b"], prompts, max_new=4))

    def test_refusals(self, sessions):
        params, build, _, _ = sessions
        mesh = SH.make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
        kw = dict(max_tenants=2, samples_per_tenant=2, seq=6)
        with pytest.raises(ValueError, match="use_kernel=False"):
            SessionRuntime(SCFG, SL, params, **kw, mesh=mesh)
        for stages, m in ((3, mesh), (2, None)):
            with pytest.raises(ValueError, match="must equal the mesh's model-axis size"):
                SessionRuntime(SCFG, SL, params, **kw, mesh=m, use_kernel=False, pipeline_stages=stages,
                               device="cpu" if m is None else None)
        with pytest.raises(ValueError, match="float layout"):
            SessionRuntime(SCFG, SL, params, **kw, mesh=mesh, use_kernel=False, pipeline_stages=2,
                           pool_compress="int8")
        with pytest.raises(ValueError, match="pipelined-admission knob"):
            build().attach_scheduler(microbatch=2)
        # a recurrent stack builds over a model axis; its scheduler is
        # refused, as the reference's is
        jamba = reduce_config(get_config("jamba-1.5-large-398b"))
        rt = SessionRuntime(jamba, SL, TL.init_lm(torch.Generator().manual_seed(0), jamba), **kw, mesh=mesh,
                            use_kernel=False)
        assert rt.model_parallel == 2
        with pytest.raises(NotImplementedError, match="attention"):
            rt.attach_scheduler(max_batch=2, max_prompt=5, max_new_cap=4)


def test_session_takes_a_backbone_split_beforehand():
    """A ``tp.GroupParams`` over the devices of a one-group mesh serves and
    adapts as the session that splits the same weights itself; another
    group's devices, or pipeline stages, are refused."""
    params = TL.init_lm(torch.Generator().manual_seed(0), SCFG)
    mesh = SH.make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    kw = dict(max_tenants=2, samples_per_tenant=4, seq=6, use_kernel=False, mesh=mesh, seed=0)
    gp = TP.group_params(params, ["cpu", "cpu"])
    own, pre = SessionRuntime(SCFG, SL, params, **kw), SessionRuntime(SCFG, SL, gp, **kw)
    assert pre._shard_params[0] is gp
    for rt in (own, pre):
        rt.ingest("a", _ints(5, (4, 6)), _ints(6, (4, 6)))
        rt.adapt(["a"], epochs=1, batch_per_tenant=2, generator=torch.Generator().manual_seed(7))
    for k in ("A", "B"):
        assert torch.equal(own.tenant("a").adapters[k], pre.tenant("a").adapters[k])
    prompts = _ints(4, (2, 5))
    assert torch.equal(own.serve([None, "a"], prompts, max_new=3), pre.serve([None, "a"], prompts, max_new=3))
    with pytest.raises(ValueError, match="split beforehand"):
        SessionRuntime(SCFG, SL, TP.group_params(params, ["cpu"] * 3), **kw)
    with pytest.raises(ValueError, match="split beforehand"):
        SessionRuntime(SCFG, SL, gp, **{**kw, "pipeline_stages": 2})


def test_run_cli_2d_pipelined_parity(capsys):
    out = run.main(["--device", "cpu", "--mesh", "2x2", "--pipeline-stages", "2", "--scheduler", "--tenants", "2",
                    "--rounds", "1", "--samples-per-round", "4", "--seq", "8", "--prompt-len", "5", "--gen", "4",
                    "--check-parity"])
    assert "parity OK" in capsys.readouterr().out
    assert out["parity/diffs"] == 0.0 and out["session/model_parallel"] == 2.0
    # reduced stablelm's vocabulary (503) does not split, its layers do
    assert out["session/backbone_bytes_per_device_peak"] < out["session/backbone_bytes_total"]


#: the reference's pipelined session and scheduler on a (1 x 2) mesh of
#: forced host devices: the weights and data from the npz in argv[1], the
#: tokens, counters, bubble and adapters printed as JSON
PIPE_REF_PROG = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 " + os.environ.get("XLA_FLAGS", "")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from repro.core.lm_skiplora import SkipLoRAConfig
from repro.core.runtime import SessionRuntime
from repro.models.config import ModelConfig
from repro.models.lm import init_lm
from repro.runtime.sharding import make_mesh

data = np.load(sys.argv[1])
cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in json.loads(sys.argv[2]).items()})
tree = init_lm(jax.random.key(0), cfg)
params = jax.tree.unflatten(jax.tree.structure(tree),
                            [jax.numpy.asarray(data[f"p{i}"]) for i in range(len(jax.tree.leaves(tree)))])
rt = SessionRuntime(cfg, SkipLoRAConfig(rank=2, mode="full"), params, max_tenants=2, samples_per_tenant=4, seq=6,
                    use_kernel=False, seed=0, pipeline_stages=2,
                    mesh=make_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2]))
for i, t in enumerate(("a", "b")):
    rt.ingest(t, data["tokens"][i], data["labels"][i])
rt.adapt(["a", "b"], epochs=2, batch_per_tenant=2, key=jax.random.key(7))
rt.attach_scheduler(max_batch=4, max_prompt=5, max_new_cap=8, admit_bucket=2, chunk=2)
reqs = [rt.enqueue_serve(t, data["prompts"][j, :5 - j], max_new=6 - j) for j, t in enumerate(("a", None, "b"))]
rt.drain()
print(json.dumps({"tokens": [r.result().tolist() for r in reqs], "counters": dict(rt.scheduler.counters),
                  "bubble": rt.scheduler.predicted_bubble(),
                  "adapters": {t: {k: np.asarray(rt.tenant(t).adapters[k]).tolist() for k in ("A", "B")}
                               for t in ("a", "b")}}))
"""


def test_pipelined_scheduler_matches_the_reference_subprocess(tmp_path):
    """The port's pipelined (1 x 2) session over ``["cpu", "cpu"]`` against
    the reference's over two forced host devices: adapters after ``adapt``
    within rtol 1e-4 / atol 1e-6, then the scheduler's temperature-0 tokens
    (two admission waves of 2 and 1 rows, each pipelined as 2 microbatches),
    its counters and ``predicted_bubble()`` equal. The subprocess has a
    timeout of its own, 120 s."""
    spec = {f.name: getattr(SCFG, f.name) for f in dataclasses.fields(JModelConfig)}
    jcfg = JModelConfig(**spec)
    jp = _live_norms(JL.init_lm(jax.random.key(0), jcfg), jcfg)
    tokens, labels, prompts = _ints(5, (2, 4, 6)), _ints(6, (2, 4, 6)), _ints(4, (3, 5))
    npz = tmp_path / "inputs.npz"
    np.savez(npz, tokens=tokens, labels=labels, prompts=prompts,
             **{f"p{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(jp))})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    ref = subprocess.run([sys.executable, "-c", PIPE_REF_PROG, str(npz), json.dumps(spec)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])

    init = JFF.init_fleet_adapters(jax.random.key(7), jcfg, JSL.SkipLoRAConfig(rank=2, mode="full"), 2)
    stacked = C.adapters_from_reference(jax.tree.map(np.asarray, init))
    rt = SessionRuntime(SCFG, SL, C.params_from_reference(jax.tree.map(np.asarray, jp), SCFG), max_tenants=2,
                        samples_per_tenant=4, seq=6, use_kernel=False, seed=0, pipeline_stages=2,
                        mesh=SH.make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2))
    for i, t in enumerate(("a", "b")):
        rt.ingest(t, tokens[i], labels[i])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFF, "init_fleet_adapters", lambda gen, cfg, sl, n: {k: v[:n].clone() for k, v in stacked.items()})
        rt.adapt(["a", "b"], epochs=2, batch_per_tenant=2)
    for t in ("a", "b"):
        for k in ("A", "B"):
            np.testing.assert_allclose(rt.tenant(t).adapters[k].numpy(), np.asarray(want["adapters"][t][k]),
                                       rtol=1e-4, atol=1e-6)
    rt.attach_scheduler(max_batch=4, max_prompt=5, max_new_cap=8, admit_bucket=2, chunk=2)
    reqs = [rt.enqueue_serve(t, prompts[j, :5 - j], max_new=6 - j) for j, t in enumerate(("a", None, "b"))]
    rt.drain()
    assert [r.result().tolist() for r in reqs] == want["tokens"]
    assert dict(rt.scheduler.counters) == want["counters"] and want["counters"]["dispatch/admit_pipe"] == 2
    assert rt.scheduler.predicted_bubble() == pytest.approx(want["bubble"], abs=1e-12)
