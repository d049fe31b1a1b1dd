"""The model axis's spec trees (``runtime.sharding``) against the
reference's: for all ten configs at full width, the reference's
``param_specs`` of ``jax.eval_shape(init_lm, ...)`` (no allocation) and the
port's of ``lm.param_shapes`` (tensors on the ``meta`` device), compared
leaf by leaf through ``convert.specs_from_reference``, with
``per_device_bytes`` equal, on the (data, model) meshes (1, 2), (2, 2),
(1, 4) and (1, 16); so are ``session_param_specs``, ``zero1_specs``
(idempotent), ``fsdp_param_specs`` (with ``cfg``: a layer leaf counted at
the reference's stacked size; every leaf of 2^16 elements or more split), ``ep_param_specs`` and ``maybe_fsdp_specs``. The reference's spec
functions read only a mesh's axis names and shape, so its side runs on a
stand-in mesh of that shape (no forced host devices). Then
``shard_backbone``: members of the spec's shapes, the replicated leaves
shared on the caller's device."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.lm import init_lm as j_init_lm  # noqa: E402
from repro.runtime import sharding as JSH  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduce_config  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402

MESHES = [(1, 2), (2, 2), (1, 4), (1, 16)]
_SHAPES: dict = {}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes(arch):
    if arch not in _SHAPES:
        j_shapes = jax.eval_shape(lambda k: j_init_lm(k, j_get_config(arch)), jax.random.key(0))
        _SHAPES[arch] = (j_shapes, LM.param_shapes(get_config(arch)))
    return _SHAPES[arch]


def _plain(tree):
    """A reference spec tree as dicts, lists and tuple leaves."""
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    raise TypeError(type(tree))


def _meshes(shape):
    ref = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty(shape, dtype=object))
    return ref, SH.make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


def _same(port_specs, ref_specs, cfg):
    assert port_specs == C.specs_from_reference(_plain(ref_specs), cfg)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_and_bytes_match_the_reference(arch, shape):
    cfg = get_config(arch)
    j_shapes, shapes = _shapes(arch)
    jmesh, mesh = _meshes(shape)
    ref = JSH.param_specs(j_shapes, jmesh)
    specs = SH.param_specs(shapes, mesh)
    _same(specs, ref, cfg)
    assert SH.per_device_bytes(shapes, specs, mesh) == JSH.per_device_bytes(j_shapes, ref, jmesh)
    _same(SH.session_param_specs(shapes, mesh), JSH.session_param_specs(j_shapes, jmesh), cfg)
    assert SH.specs_all_replicated(specs) == JSH.specs_all_replicated(ref) is False
    for leaf, spec in zip(SH._leaves(shapes), SH._leaves(specs)):
        assert len(spec) == leaf.dim()
        assert SH.spec_shards(tuple(leaf.shape), spec, mesh) in (1, shape[1])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list_archs())
def test_zero1_fsdp_and_ep_specs_match_the_reference(arch, shape):
    cfg = get_config(arch)
    j_shapes, shapes = _shapes(arch)
    jmesh, mesh = _meshes(shape)
    ref, specs = JSH.param_specs(j_shapes, jmesh), SH.param_specs(shapes, mesh)
    z1 = SH.zero1_specs(shapes, specs, mesh)
    _same(z1, JSH.zero1_specs(j_shapes, ref, jmesh), cfg)
    assert SH.zero1_specs(shapes, z1, mesh) == z1                       # idempotent
    fsdp = SH.fsdp_param_specs(shapes, mesh, cfg=cfg)
    _same(fsdp, JSH.fsdp_param_specs(j_shapes, jmesh), cfg)
    big = [s for s, leaf in zip(SH._leaves(fsdp), SH._leaves(shapes)) if leaf.numel() >= (1 << 16)]
    if shape[0] > 1 or shape[1] > 1:
        assert all(any(p is not None for p in s) for s in big)
    _same(SH.ep_param_specs(shapes, mesh, cfg=cfg), JSH.ep_param_specs(j_shapes, jmesh), cfg)
    got, applied = SH.maybe_fsdp_specs(shapes, specs, mesh)
    want, j_applied = JSH.maybe_fsdp_specs(j_shapes, ref, jmesh)
    assert applied == j_applied
    _same(got, want, cfg)
    assert SH.per_device_bytes(shapes, fsdp, mesh) == JSH.per_device_bytes(
        j_shapes, JSH.fsdp_param_specs(j_shapes, jmesh), jmesh)


def test_qwen_specs_as_the_reference_test_pins_them():
    """``tests/test_launch.py``'s spot checks on a (2, 4) mesh: experts
    split (60 % 4 == 0), attention heads split, the embedding vocab-split,
    and on a 16-way model axis the expert FFN hidden instead."""
    _, shapes = _shapes("qwen2-moe-a2.7b")
    specs = SH.param_specs(shapes, SH.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8))
    layer = specs["stack"][0]
    assert layer["moe"]["w_gate"] == ("model", None, None)
    assert layer["moe"]["router"] == (None, None)
    assert layer["attn"]["wq"] == (None, "model", None) and layer["attn"]["wo"] == ("model", None, None)
    assert specs["embed"]["table"] == ("model", None)
    wide = SH.param_specs(shapes, SH.make_mesh((1, 16), ("data", "model"), devices=["cpu"] * 16))
    assert wide["stack"][0]["moe"]["w_gate"] == (None, None, "model")
    assert wide["stack"][0]["moe"]["w_down"] == (None, "model", None)


def test_axis_rules_resolve_and_session_rules():
    r = SH.AxisRules()
    assert r.resolve(("data", "model"), "batch") == ("data",)
    assert r.resolve(("pod", "data", "model"), "batch") == ("pod", "data")
    assert r.resolve(("data",), "heads") is None and r.resolve(("data", "model"), "heads") == "model"
    assert r.resolve(("data", "model"), ("pod",)) is None
    t = SH.SESSION_TP_RULES
    assert t.resolve(("model",), "batch") is None and t.resolve(("model",), "layers") == "model"
    scope = SH.ShardScope(SH.group_mesh(["cpu", "cpu"]))
    assert scope.rules is SH.SESSION_TP_RULES and scope.mesh.axis_names == ("model",)
    mesh = SH.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert SH.session_mesh_layout(mesh)[:2] == (2, 2)
    assert SH.shard_submesh(mesh, 1).axis_names == ("model",) and SH.shard_submesh(mesh, 1).size == 2


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "paligemma-3b", "musicgen-medium"])
def test_shard_backbone_members_follow_the_specs(arch):
    """Each member's leaves have the spec's shapes, the split leaves are
    the members' own contiguous copies and concatenate back to the whole,
    and a replicated leaf is the caller's own tensor on its device."""
    cfg = reduce_config(get_config(arch))
    params = LM.init_lm(torch.Generator().manual_seed(0), cfg)
    group = ["cpu", "cpu"]
    members = SH.shard_backbone(params, group)
    specs = SH.param_specs(params, SH.group_mesh(group))
    for path_leaves in zip(SH._leaves(params), SH._leaves(specs), *(SH._leaves(m) for m in members)):
        full, spec, parts = path_leaves[0], path_leaves[1], path_leaves[2:]
        if all(p is None for p in spec):
            assert all(p is full for p in parts)
            continue
        ax = spec.index("model")
        assert all(p.is_contiguous() and p.data_ptr() != full.data_ptr() for p in parts)
        torch.testing.assert_close(torch.cat(parts, dim=ax), full, rtol=0, atol=0)
    got = sum(leaf.numel() * leaf.element_size() for leaf in SH._leaves(members[0]))
    assert got == SH.per_device_bytes(params, specs, SH.group_mesh(group))
