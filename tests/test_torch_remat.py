"""Rematerialisation of the layer stack in training (``models.remat``).

Train mode runs each period of layers as one ``torch.utils.checkpoint``
region, as the reference's ``jax.checkpoint`` around its period scan. The
backward replays a period instead of keeping its internals, so

  - a full-backprop step's loss, gradients and updated parameters, and the
    populate step's adapter gradients, are bitwise those of the same step
    with ``remat.region`` replaced by a plain call (the un-rematerialised
    run), on reduced stablelm-1.6b, qwen2-moe (the MoE aux loss) and jamba
    (one period of eight layers plus a two-layer remainder), on one device
    and on a ``["cpu", "cpu"]`` model group;
  - the tensors autograd keeps outside the regions (``saved_tensors_hooks``)
    are the periods' inputs and what runs outside any period: nothing is
    packed while a region runs, and on a 4-layer reduced stablelm the bytes
    kept fall below half of the un-rematerialised run's;
  - the replay tells ``tp.on_collective`` of its collectives under the
    member that makes them.

The parity against the reference's ``jax.grad`` is ``test_torch_train.py``'s.
One intra-op thread."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import lm_skiplora as SL  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.shapes import ShapeCell  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import remat as RM  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402

SHAPE = ShapeCell("t", "train", 8, 2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    if arch == "jamba-1.5-large-398b":
        cfg = reduce_config(get_config(arch), n_periods=1)
        return dataclasses.replace(cfg, n_layers=cfg.period + 2)     # one period + a 2-layer remainder
    return dataclasses.replace(reduce_config(get_config(arch)), vocab_size=128)


def _live_norms(params):
    """Norm scales around 1 (the reference draws them at 0, which zeroes
    each block's input): the same values in every member of a group."""
    trees = params.members if TP.is_group(params) else [params]
    for tree in trees:
        stack = [tree["final_norm"]] + [v for layer in tree["stack"] for k, v in layer.items() if "norm" in k]
        for norm in stack:
            s = norm["scale"]
            s.copy_(1.0 + 0.1 * torch.sin(torch.arange(s.numel(), dtype=torch.float32)).reshape(s.shape))


def _cell(cfg, kind, n):
    mesh = SH.make_mesh((1, n), ("data", "model"), devices=["meta"] * n)
    cell = D.prepare_cell(cfg, SHAPE, kind, mesh=mesh, group=["cpu"] * n)
    _live_norms(cell.args[0])
    return cell


def _plain(monkeypatch):
    monkeypatch.setattr(RM, "region", lambda fn, *args: fn(*args))


def _train(cfg, n):
    cell = _cell(cfg, "train", n)
    params, opt_state, batch = cell.args
    tree, rebuild = ST.trainable_tree(params)
    loss, grads = ST._value_and_grad(lambda t: LM.train_loss_fn(rebuild(t), cfg, ST._batch(batch)), tree)
    new, _, step_loss = cell.fn(*cell.args)
    new_tree, _ = ST.trainable_tree(new)
    return [loss, step_loss] + tree_leaves(grads) + tree_leaves(new_tree)


def _populate(cfg, n):
    cell = _cell(cfg, "finetune_populate", n)
    params, trainable, static, batch = cell.args
    loss, (acts, y_base, _), grads = SL.value_and_grad(
        lambda t: SL.populate_loss_fn(params, cfg, SL.merge_adapters(t, static), ST._batch(batch)), trainable)
    return [loss, acts, y_base] + tree_leaves(grads)


def _bitwise(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i


ARCHS = ["stablelm-1.6b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_backprop_step_bitwise_the_unrematerialised_one(arch, n, monkeypatch):
    cfg = _cfg(arch)
    got = _train(cfg, n)
    with monkeypatch.context() as m:
        _plain(m)
        want = _train(cfg, n)
    _bitwise(got, want)
    assert any(g.abs().sum() > 0 for g in got[2:4])


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_populate_adapter_gradients_bitwise_the_unrematerialised_ones(arch, n, monkeypatch):
    cfg = _cfg(arch)
    got = _populate(cfg, n)
    with monkeypatch.context() as m:
        _plain(m)
        want = _populate(cfg, n)
    _bitwise(got, want)
    assert all(g.abs().sum() > 0 for g in got[3:])


def test_regions_keep_only_their_inputs(monkeypatch):
    """A 4-layer reduced stablelm's full-backprop loss: what autograd keeps
    outside the regions (distinct storages, the parameters left out)."""
    cfg = dataclasses.replace(reduce_config(get_config("stablelm-1.6b"), n_periods=4), vocab_size=128)
    assert cfg.n_layers == 4 and cfg.period == 1
    gen = torch.Generator().manual_seed(0)
    params = LM.init_lm(gen, cfg)
    _live_norms(params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    param_storages = {p.untyped_storage().data_ptr() for p in leaves}

    def kept():
        storages, in_region = {}, []

        def pack(t):
            in_region.append(RM.in_region())
            ptr = t.untyped_storage().data_ptr()
            if ptr not in param_storages:
                storages[ptr] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = LM.train_loss_fn(params, cfg, batch)
        torch.autograd.grad(loss, leaves)
        return sum(storages.values()), in_region

    remat_bytes, flags = kept()
    assert flags and not any(flags)      # a region's internals go to its own holders
    with monkeypatch.context() as m:
        _plain(m)
        plain_bytes, _ = kept()
    assert remat_bytes < 0.5 * plain_bytes, (remat_bytes, plain_bytes)


def test_the_replay_reports_its_collectives_under_its_member():
    """A group's train loss: the backward replays each period, whose
    all-reduces are told to ``on_collective`` again, with the member loops'
    ``current_member()`` set as in the forward."""
    cfg = _cfg("stablelm-1.6b")
    cell = _cell(cfg, "train", 2)
    params, _, batch = cell.args
    tree, rebuild = ST.trainable_tree(params)
    seen = []

    def listen(op, t):
        seen.append((RM.replaying(), op, tuple(t.shape)))

    with TP.on_collective(listen):
        ST._value_and_grad(lambda t: LM.train_loss_fn(rebuild(t), cfg, ST._batch(batch)), tree)
    fwd = [(op, s) for r, op, s in seen if not r]
    replay = [(op, s) for r, op, s in seen if r]
    # each period's replay stops after the FFN's up projections: its
    # attention output all-reduce comes back, the FFN's does not
    assert len(replay) == cfg.n_periods and all(op == "all-reduce" for op, _ in replay)
    assert set(replay) <= set(fwd)

    seen_members = []
    real_each = TP._each

    def each(g):
        for i, m, d in real_each(g):
            if RM.replaying():
                seen_members.append((i, TP.current_member()))
            yield i, m, d

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "_each", each)
        ST._value_and_grad(lambda t: LM.train_loss_fn(rebuild(t), cfg, ST._batch(batch)), tree)
    assert seen_members and all(i == m for i, m in seen_members)
    assert {i for i, _ in seen_members} == {0, 1}
