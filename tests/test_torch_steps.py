"""``repro_torch.launch.steps`` against ``repro.launch.steps`` on the CPU.

  - The spec trees: ``rules_for``, and ``build_cell``'s input and output
    spec trees (params, optimizer state, batch, serve caches, adapters) for
    all ten configs x the four shapes (each shape's dry-run step; for
    ``train_4k`` also ``finetune_populate`` / ``finetune_cached``, for
    ``decode_32k`` also ``decode_adapted``) x the meshes (1, 2), (2, 2),
    (1, 16), (16, 16) and (2, 16, 16) x the strategies tp, fsdp and ep,
    leaf by leaf through ``convert.specs_from_reference``. The reference's
    spec code reads only a mesh's axis names and shape, so it runs on a
    stand-in mesh of that shape; inside this test its ``named`` /
    ``replicated`` return the specs themselves and its shape trees are
    memoised (``jax.eval_shape`` of the same function twice). The JAX
    package is not edited.
  - The six step functions at a reduced stablelm-1.6b on one CPU device:
    the reference's ``build_cell`` function (its ``get_config`` / ``SHAPES``
    patched inside the test to the reduced config and a small cell), jitted
    on a one-device mesh, and the port's on the same weights
    (``convert.params_from_reference``) and the same numpy inputs: losses
    within rtol 1e-5, updated params / adapters / cache values within 1e-5
    of each leaf's largest value (1e-4 for the train step's AdamW update,
    whose first step is sign-like), logits within 1e-5, bf16 caches within
    one bf16 ulp at the leaf's scale.

One intra-op thread."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_config as j_reduce_config  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.optim.optimizers import OptState as JOptState  # noqa: E402
from repro.runtime import sharding as JSH  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduce_config  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.shapes import SHAPES, ShapeCell  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.optim.optimizers import OptState  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402

MESHES = [(1, 2), (2, 2), (1, 16), (16, 16), (2, 16, 16)]
STEPS = {"train_4k": ("train", "finetune_populate", "finetune_cached"), "prefill_32k": ("prefill",),
         "decode_32k": ("decode", "decode_adapted"), "long_500k": ("decode",)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    ref = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=object))
    return ref, SH.make_mesh(shape, axes, devices=["meta"] * int(np.prod(shape)))


_J_SHAPES: dict = {}
_T_SHAPES: dict = {}


def _memo_shape_tree(f, *args):
    cells = tuple(repr(c.cell_contents) for c in (f.__closure__ or ()))
    key = (f.__code__, cells, tuple(id(a) for a in args if not isinstance(a, jax.Array)))
    if key not in _J_SHAPES:
        _J_SHAPES[key] = jax.eval_shape(f, *args)
    return _J_SHAPES[key]


@pytest.fixture
def spec_builders(monkeypatch):
    """The reference's ``build_cell`` returning spec trees (``named`` and
    ``replicated`` the identity, shape trees memoised), and the port's
    with its meta param tree and its params' specs (a function of config,
    mesh and strategy) memoised, both inside this test only."""
    monkeypatch.setattr(JSH, "named", lambda mesh, specs: specs)
    monkeypatch.setattr(JSH, "replicated", lambda mesh: P())
    monkeypatch.setattr(JST, "_shape_tree", _memo_shape_tree)
    real = TL.param_shapes

    def shapes(cfg):
        if cfg.name not in _T_SHAPES:
            _T_SHAPES[cfg.name] = real(cfg)
        return _T_SHAPES[cfg.name]

    monkeypatch.setattr(ST.LM, "param_shapes", shapes)
    real_specs = ST.param_specs_for
    memo: dict = {}

    def specs_for(params, mesh, strategy, cfg):
        key = (cfg.name, tuple(mesh.shape), tuple(mesh.axis_names), strategy)
        if key not in memo:
            memo[key] = real_specs(params, mesh, strategy, cfg)
        return memo[key]

    monkeypatch.setattr(ST, "param_specs_for", specs_for)


def _plain(tree):
    """A reference spec tree as the port's: P -> tuple, OptState fields."""
    if tree is None:
        return None
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, JOptState):
        return OptState(step=_plain(tree.step), mu=_plain(tree.mu), nu=_plain(tree.nu))
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    raise TypeError(type(tree))


def _port_form(ref, port, cfg):
    """The reference's plain spec tree mapped onto the port's layout where
    it holds layers (a params tree, a serve-cache tree)."""
    if ref is None or isinstance(ref, tuple):
        return ref
    if isinstance(ref, OptState):
        return OptState(step=ref.step, mu=_port_form(ref.mu, port.mu, cfg), nu=_port_form(ref.nu, port.nu, cfg))
    if isinstance(ref, dict) and "periods" in ref:                       # serve caches
        return C.specs_from_reference({"stack": ref}, cfg)["stack"]
    if isinstance(ref, dict) and "stack" in ref:                         # params
        return C.specs_from_reference(ref, cfg)
    if isinstance(ref, dict):
        return {k: _port_form(v, port[k], cfg) for k, v in ref.items()}
    return [_port_form(v, p, cfg) for v, p in zip(ref, port)]


def _leaf(spec):
    """A spec with ("data",) and "data" alike (PartitionSpec's form)."""
    return tuple(x[0] if isinstance(x, tuple) and len(x) == 1 else x for x in spec)


def _same(a, b) -> bool:
    """Two spec trees equal leaf by leaf (specs normalised by ``_leaf``)."""
    if isinstance(a, OptState):
        return isinstance(b, OptState) and all(_same(getattr(a, f), getattr(b, f)) for f in ("step", "mu", "nu"))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) or (isinstance(a, tuple) and a and not isinstance(a[0], (str, tuple, type(None)))):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return _leaf(a) == _leaf(b)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", list_archs())
def test_rules_and_cell_specs_match_the_reference(arch, shape, spec_builders):
    """Every cell's input and output spec trees, leaf by leaf. The params'
    tree (each cell's first input, and the train step's first output)
    depends on config, mesh and strategy alone: it is held against the
    reference's once a strategy, and in every other cell each side must
    give that same tree again."""
    cfg = get_config(arch)
    jmesh, mesh = _meshes(shape)
    first_params: dict = {}
    for shape_name, kinds in STEPS.items():
        for strategy in ("tp", "fsdp", "ep"):
            rules = ST.rules_for(SHAPES[shape_name], mesh, strategy, cfg.vocab_size)
            jrules = JST.rules_for(JST.SHAPES[shape_name], jmesh, strategy, cfg.vocab_size)
            assert dataclasses.asdict(rules) == dataclasses.asdict(jrules), (shape_name, strategy)
            for kind in kinds:
                where = (shape_name, strategy, kind)
                _, _, ins, outs = ST.build_cell(arch, shape_name, mesh, kind, strategy=strategy)
                _, _, jins, jouts = JST.build_cell(arch, shape_name, jmesh, kind, strategy=strategy)
                if strategy not in first_params:
                    first_params[strategy] = (ins[0], jins[0])
                    assert _same(ins[0], _port_form(_plain(jins[0]), ins[0], cfg)), where
                assert (ins[0], jins[0]) == first_params[strategy], where
                want_in = [_port_form(_plain(j), p, cfg) for j, p in zip(jins[1:], ins[1:])]
                assert _same(list(ins[1:]), want_in), where
                if jouts is None:
                    assert outs is None
                    continue
                outs, jouts = list(outs), list(jouts)
                if kind == "train":       # (params, optimizer state, loss): the inputs' trees again
                    assert outs[:2] == list(ins[:2]) and jouts[:2] == list(jins[:2]), where
                    outs, jouts = outs[2:], jouts[2:]
                want_out = [_port_form(_plain(j), p, cfg) for j, p in zip(jouts, outs)]
                assert _same(outs, want_out), where


def test_cache_and_batch_specs_spot_checks():
    """``tests/test_launch.py``-style pins: long_500k's KV sequence on
    'data', heads on 'model' where they divide, the recurrent states'
    d_inner and heads; a batch that does not divide stays whole."""
    mesh = SH.make_mesh((16, 16), ("data", "model"), devices=["meta"] * 256)
    long = ST.rules_for(SHAPES["long_500k"], mesh)
    assert long.seq == "data"
    jamba = get_config("jamba-1.5-large-398b")
    caches = TL.init_serve_caches(jamba, 1, 524288, device="meta")
    specs = ST.cache_specs(caches, mesh, long)
    kinds = jamba.layer_kinds()
    attn = specs[kinds.index("attn")]
    assert attn["k"] == (None, ("data", "model"), None, None)     # 8 KV heads do not divide 16: seq on both
    mamba = specs[kinds.index("mamba")]
    assert mamba["ssm"] == (None, "model", None) and mamba["conv"] == (None, None, "model")
    x = get_config("xlstm-350m")
    xs = ST.cache_specs(TL.init_serve_caches(x, 128, 8, device="meta"), SH.make_mesh((2, 2), ("data", "model"),
                        devices=["meta"] * 4), SH.AxisRules())
    assert xs[0]["c"] == (("data",), "model", None, None) and xs[0]["n"] == (("data",), None, None)
    odd = torch.empty((3, 5), device="meta")
    assert ST.batch_specs({"t": odd}, mesh, SH.AxisRules())["t"] == (None, None)


# ---------------------------------------------------------------------------
# The step functions at a reduced config, against the reference's
# ---------------------------------------------------------------------------

CELLS = {"train": ShapeCell("tiny_train", "train", 8, 2), "prefill": ShapeCell("tiny_prefill", "prefill", 8, 2),
         "decode": ShapeCell("tiny_decode", "decode", 8, 2)}


@pytest.fixture(scope="module")
def reduced():
    jcfg = dataclasses.replace(j_reduce_config(j_get_config("stablelm-1.6b")), vocab_size=128)
    cfg = dataclasses.replace(reduce_config(get_config("stablelm-1.6b")), vocab_size=128)
    rng = np.random.default_rng(0)
    jp = JST.init_lm(jax.random.key(0), jcfg)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(1 + 0.1 * rng.normal(size=x.shape), x.dtype)
        if getattr(path[-1], "key", None) == "scale" else x, jp)
    return jcfg, cfg, jp, C.params_from_reference(jax.tree.map(np.asarray, jp), cfg)


def _ref_cell(monkeypatch, jcfg, kind, sl):
    cell = CELLS[{"finetune_populate": "train", "finetune_cached": "train", "decode_adapted": "decode"}.get(kind, kind)]
    jshape = JST.ShapeCell(cell.name, cell.kind, cell.seq, cell.batch)
    monkeypatch.setattr(JST, "get_config", lambda arch: jcfg)
    monkeypatch.setattr(JST, "SHAPES", {cell.name: jshape})
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    fn, args, ins, outs = JST.build_cell("stablelm-1.6b", cell.name, jmesh, kind, skiplora=sl)
    jitted = jax.jit(fn, in_shardings=ins, out_shardings=outs) if outs is not None else jax.jit(fn, in_shardings=ins)
    return cell, jmesh, jitted


def _rel(got, want):
    got, want = C.to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _trees_close(got, want, tol):
    g, w = jax.tree.leaves(C._map(C.to_numpy, got)), jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w) and g
    for a, b in zip(g, w):
        assert a.shape == b.shape
        assert _rel(a, b) <= tol


def _ints(seed, shape, high):
    return np.random.default_rng(seed).integers(0, high, shape).astype(np.int32)


@pytest.mark.parametrize("kind", ST.STEP_KINDS)
def test_step_functions_match_the_reference(kind, reduced, monkeypatch):
    jcfg, cfg, jp, tp = reduced
    sl = TSL.SkipLoRAConfig(rank=4, mode="full", cache_dtype="float32")
    jsl = JSL.SkipLoRAConfig(rank=4, mode="full", cache_dtype="float32")
    cell, jmesh, jfn = _ref_cell(monkeypatch, jcfg, kind, jsl)
    fn, _, _, _ = ST.build_cell(cfg, cell, SH.make_mesh((1, 1), ("data", "model"), devices=["cpu"]), kind,
                                skiplora=sl)
    b, s, v = cell.batch, cell.seq, cfg.vocab_size
    rng = np.random.default_rng(1)
    ad = {"A": (rng.normal(size=(cfg.n_layers, cfg.d_model, 4)) / 8).astype(np.float32),
          "B": (0.1 * rng.normal(size=(cfg.n_layers, 4, cfg.d_model))).astype(np.float32)}
    jad, tad = {k: jnp.asarray(x) for k, x in ad.items()}, {k: torch.from_numpy(x.copy()) for k, x in ad.items()}
    with jmesh:
        if kind == "train":
            batch = {"tokens": _ints(2, (b, s), v), "labels": _ints(3, (b, s), v)}
            jopt = JST.adamw(3e-4, weight_decay=0.1)
            jout = jfn(jp, jopt.init(jp), {k: jnp.asarray(x) for k, x in batch.items()})
            tout = fn(tp, fn.opt.init(tp), {k: torch.from_numpy(x) for k, x in batch.items()})
            np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=1e-5)
            got = C._map(lambda x: x, {**tout[0], "stack": tout[0]["stack"]})
            _trees_close(got["stack"], C._flat_layers(jout[0]["stack"], cfg), 1e-4)
            _trees_close(got["embed"], jout[0]["embed"], 1e-4)
        elif kind == "finetune_populate":
            batch = {"tokens": _ints(2, (b, s), v), "labels": _ints(3, (b, s), v)}
            jout = jfn(jp, jad, {}, {k: jnp.asarray(x) for k, x in batch.items()})
            tout = fn(tp, tad, {}, {k: torch.from_numpy(x) for k, x in batch.items()})
            np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=1e-5)
            _trees_close(tout[0], jout[0], 1e-5)
            _trees_close(tout[1], jout[1], 1e-5)
        elif kind == "finetune_cached":
            vals = {"acts": rng.normal(size=(b, cfg.n_layers, s, cfg.d_model)).astype(np.float32),
                    "y_base": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
                    "labels": _ints(4, (b, s), v)}
            jo = JST.adamw(1e-3)
            jout = jfn(jp, jad, {}, jo.init(jad), {k: jnp.asarray(x) for k, x in vals.items()})
            tout = fn(tp, tad, {}, fn.opt.init(tad), {k: torch.from_numpy(x) for k, x in vals.items()})
            np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=1e-5)
            _trees_close(tout[0], jout[0], 1e-5)
        elif kind == "prefill":
            tokens = _ints(5, (b, s), v)
            jout = jfn(jp, jnp.asarray(tokens), JST.init_serve_caches(jcfg, b, s), None)
            tout = fn(tp, torch.from_numpy(tokens), TL.init_serve_caches(cfg, b, s, device="cpu"), None)
            assert _rel(tout[0], jout[0]) <= 1e-5
            _trees_close([{k: c[k].float() for k in c} for c in tout[1]],
                         C._flat_layers(jout[1], cfg) if "periods" in jout[1] else jout[1], 2.0 ** -7)
        else:
            # decode at position 3 of caches a prefill of 3 tokens filled
            tokens = _ints(6, (b, 3), v)
            jc = JST.init_serve_caches(jcfg, b, s)
            _, jc = JST.serve_prefill(jp, jcfg, jnp.asarray(tokens), jc)
            tc = TL.init_serve_caches(cfg, b, s, device="cpu")
            TL.serve_prefill(tp, cfg, torch.from_numpy(tokens), tc)
            tok = _ints(7, (b, 1), v)
            pos = jnp.asarray(3, jnp.int32)
            if kind == "decode":
                jout = jfn(jp, jnp.asarray(tok), pos, jc)
                tout = fn(tp, torch.from_numpy(tok), torch.tensor(3, dtype=torch.int32), tc)
            else:
                jout = jfn(jp, jad, jnp.asarray(tok), pos, jc)
                tout = fn(tp, tad, torch.from_numpy(tok), torch.tensor(3, dtype=torch.int32), tc)
            assert _rel(tout[0], jout[0]) <= 1e-4
