"""What a CUDA graph of a model group's steps keys and copies, on the CPU
(``core.cuda_graph``, ``models.tp``, ``core.decode_graph``): no card is
needed, the graphs themselves are held on the card by
``tests/test_torch_model_axis_gpu.py``.

Three small float32 configs over the group ``["cpu", "cpu"]``: an attention
stack whose KV heads split (4 layers, d 16, 4 heads over 2 KV heads), the
same with one KV head (its K/V caches split by sequence) and reduced
xlstm-350m (one period: mLSTM states split by ``d_inner`` and heads).

  - ``storage_sig`` of a ``GroupParams``: equal for the same member
    storages, different when one member's shard is re-made, when the
    devices change; of each kind of ``HeadSplit`` cache: equal for the same
    parts, different when one part, a range or the axis changes;
  - ``HeadSplit.zeros_like`` / ``copy_`` (and ``tp.zeros_like``): a zeroed
    twin with the parts' shapes, dtypes and devices, the ranges and the
    axis; a round trip through it bitwise; a copy across other ranges, axis
    or part shapes refused; a whole cache stays a tensor;
  - ``cuda_graph.capturable``: true for every list of CUDA devices, on one
    card or several, false wherever a ``cpu`` or ``meta`` device appears;
    ``tp.run_devices``; ``cuda_graph.tree_devices``;
  - on the CPU a group's ``decode_scan`` and scheduler chunk run their
    eager steps and capture nothing.

One intra-op thread; well under 30 s."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import decode_graph as DG  # noqa: E402
from repro_torch.core import lm_skiplora as SL  # noqa: E402
from repro_torch.core.cuda_graph import CardPools, capturable, other_cards, storage_sig, tree_devices  # noqa: E402
from repro_torch.core.scheduler import _chunk_scan  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

GROUP = ["cpu", "cpu"]
HEADS = ModelConfig(name="heads", family="test", n_layers=4, d_model=16, n_heads=4, n_kv_heads=2, d_ff=32,
                    vocab_size=64, pattern=("attn",), dtype="float32")
SEQ = dataclasses.replace(HEADS, name="seq", n_kv_heads=1)
KINDS = {"heads": -2, "sequence": -3, "recurrent": None}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(kind):
    if kind == "recurrent":
        return dataclasses.replace(reduce_config(get_config("xlstm-350m"), n_periods=1), vocab_size=64,
                                   dtype="float32")
    return HEADS if kind == "heads" else SEQ


_GROUPS: dict = {}


def _group(kind):
    """The kind's params split over ``GROUP`` (drawn once a module)."""
    if kind not in _GROUPS:
        cfg = _cfg(kind)
        _GROUPS[kind] = cfg, TP.group_params(TL.init_lm(torch.Generator().manual_seed(0), cfg), GROUP)
    return _GROUPS[kind]


def _split_leaf(kind):
    """A cache leaf of the kind, split over the group, filled with draws."""
    cfg, gp = _group(kind)
    caches = TL.init_serve_caches(cfg, 3, 8, device="cpu", params=gp)
    leaf = caches[0]["k"] if kind != "recurrent" else caches[0]["c"]
    assert isinstance(leaf, TP.HeadSplit)
    if KINDS[kind] is not None:
        assert leaf.axis == KINDS[kind]
    g = torch.Generator().manual_seed(3)
    for p in leaf.parts:
        p.copy_(torch.randn(p.shape, generator=g).to(p.dtype))
    return leaf


# ---------------------------------------------------------------------------
# storage_sig
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["heads", "sequence", "recurrent"])
def test_group_sig_follows_every_members_storage(kind):
    _, gp = _group(kind)
    same = TP.GroupParams(list(gp.members), gp.specs, list(gp.devices))
    assert storage_sig(gp) == storage_sig(same)
    assert storage_sig(gp["stack"][1]) == storage_sig(same["stack"][1])
    # member 1's shard of one leaf re-made into new storage of equal shape
    m1 = dict(gp.members[1])
    m1["final_norm"] = {k: v.clone() for k, v in m1["final_norm"].items()}
    moved = TP.GroupParams([gp.members[0], m1], gp.specs, list(gp.devices))
    assert storage_sig(moved) != storage_sig(gp)
    # the same storages named on other devices
    other = TP.GroupParams(list(gp.members), gp.specs, [torch.device("cpu"), torch.device("meta")])
    assert storage_sig(other) != storage_sig(gp)
    # the members in another order
    swapped = TP.GroupParams(gp.members[::-1], gp.specs, list(gp.devices))
    assert storage_sig(swapped) != storage_sig(gp)


@pytest.mark.parametrize("kind", ["heads", "sequence", "recurrent"])
def test_split_cache_sig_follows_parts_ranges_and_axis(kind):
    leaf = _split_leaf(kind)
    sig = storage_sig({"k": leaf})
    assert sig == storage_sig({"k": TP.HeadSplit(list(leaf.parts), leaf.ranges, leaf.axis)})
    assert sig != storage_sig({"k": TP.HeadSplit([leaf.parts[0], leaf.parts[1].clone()], leaf.ranges, leaf.axis)})
    (lo0, hi0), (lo1, hi1) = leaf.ranges
    assert sig != storage_sig({"k": TP.HeadSplit(list(leaf.parts), [(lo0, hi0), (lo0, hi1 - lo1 + lo0)],
                                                 leaf.axis)})
    assert sig != storage_sig({"k": TP.HeadSplit(list(leaf.parts), leaf.ranges, leaf.axis - 1)})
    # a part's storage seen through a split differs from the bare tensors
    assert sig != storage_sig({"k": list(leaf.parts)})


def test_sig_refuses_unknown_leaves():
    with pytest.raises(TypeError, match="unexpected leaf"):
        storage_sig({"x": 1.5})


# ---------------------------------------------------------------------------
# The HeadSplit twin and copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["heads", "sequence", "recurrent"])
def test_twin_round_trip_is_bitwise(kind):
    leaf = _split_leaf(kind)
    want = [p.clone() for p in leaf.parts]
    twin = TP.zeros_like(leaf)
    assert isinstance(twin, TP.HeadSplit)
    assert twin.ranges == leaf.ranges and twin.axis == leaf.axis and twin.shape == leaf.shape
    for t, p in zip(twin.parts, leaf.parts):
        assert t.shape == p.shape and t.dtype == p.dtype and t.device == p.device
        assert t.data_ptr() != p.data_ptr() and not t.any()
    assert twin.copy_(leaf) is twin
    for p in leaf.parts:
        p.zero_()
    leaf.copy_(twin)
    assert all(torch.equal(p, w) for p, w in zip(leaf.parts, want))
    assert torch.equal(leaf.whole(), twin.whole())


@pytest.mark.parametrize("kind", ["heads", "sequence", "recurrent"])
def test_copy_refuses_another_layout(kind):
    leaf = _split_leaf(kind)
    twin = TP.zeros_like(leaf)
    with pytest.raises(ValueError, match="ranges"):
        twin.copy_(TP.HeadSplit(list(leaf.parts), leaf.ranges, leaf.axis - 1))
    with pytest.raises(ValueError, match="ranges"):
        twin.copy_(TP.HeadSplit(list(leaf.parts), leaf.ranges[::-1], leaf.axis))
    with pytest.raises(ValueError, match="ranges"):
        twin.copy_(leaf.whole())
    with pytest.raises(ValueError, match="part"):
        twin.copy_(TP.HeadSplit([p[:1] for p in leaf.parts], leaf.ranges, leaf.axis))


def test_a_whole_cache_stays_a_tensor():
    t = torch.randn(2, 5, 3)
    twin = TP.zeros_like(t)
    assert isinstance(twin, torch.Tensor) and twin.shape == t.shape and not twin.any()


@pytest.mark.parametrize("kind", ["heads", "sequence", "recurrent"])
def test_decode_entry_twins_every_cache_leaf(kind):
    """``decode_graph``'s entry makes a twin of each cache leaf with its
    layout (what ``decode``'s key holds)."""
    cfg, gp = _group(kind)
    caches = TL.init_serve_caches(cfg, 2, 8, device="cpu", params=gp)
    tok0 = torch.zeros((2, 1), dtype=torch.long)
    e = DG._Decode(DG.GraphCache().stats, cfg, tok0, caches, temperature=0.0, pools=None, idx=None,
                   use_kernel=False, fuse_skip=False, unroll=2)
    for mine, theirs in zip(e.state["caches"], caches):
        assert mine.keys() == theirs.keys()
        for n, t in theirs.items():
            assert DG._layout(mine[n]) == DG._layout(t)
            assert type(mine[n]) is type(t)
    kinds = {type(t) for c in caches for t in c.values()}
    assert TP.HeadSplit in kinds
    if kind == "recurrent":
        assert torch.Tensor in kinds     # the states kept whole on the home device


# ---------------------------------------------------------------------------
# The predicate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("devices,want", [
    (["cuda:0"], True),
    (["cuda:0", "cuda:0"], True),
    (["cuda:1", "cuda:1", "cuda:1", "cuda:1"], True),
    ([torch.device("cuda", 0), "cuda:0"], True),
    (["cuda:0", "cuda:1"], True),
    (["cuda:1", "cuda:0", "cuda:0"], True),
    (["cuda:0", "cpu"], False),
    (["cpu"], False),
    (["cpu", "cpu"], False),
    (["meta", "meta"], False),
    ([], False),
    (["cuda:0", "meta"], False),
])
def test_capturable_only_for_one_card(devices, want):
    """True for every list of CUDA devices, on one card or several (the
    name predates captures across cards), false wherever a ``cpu`` or
    ``meta`` device appears."""
    assert capturable(devices) is want


def test_run_devices_lists_the_home_and_the_members():
    _, gp = _group("heads")
    x = torch.zeros(2)
    assert TP.run_devices(gp, x) == [torch.device("cpu")] * 3
    assert TP.run_devices({"embed": {}}, x) == [torch.device("cpu")]
    cross = TP.GroupParams(gp.members, gp.specs, [torch.device("cuda", 0), torch.device("cuda", 1)])
    assert TP.run_devices(cross, x) == [torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)]
    assert not capturable(TP.run_devices(cross, x))      # x on the CPU
    assert capturable(TP.run_devices(cross, x)[1:])


@pytest.mark.parametrize("devices,home,want", [
    (["cuda:0"], 0, []),
    (["cuda:0", "cuda:0"], 0, []),
    (["cuda:0", "cuda:1"], 0, [1]),
    (["cuda:0", "cuda:1", "cuda:1", "cuda:3", "cuda:0"], 0, [1, 3]),
    (["cuda:2", "cuda:0", "cuda"], 2, [0]),
    (["cuda", "cuda:1"], 1, []),
    (["cpu", "cuda:1"], 0, [1]),
])
def test_other_cards_lists_each_card_but_the_home_once(devices, home, want):
    assert other_cards(devices, home) == want


def test_entries_start_with_empty_card_pools():
    """A decode entry and an epoch graph own a ``CardPools`` keyed by their
    home device, empty until a capture reaches another card; dropping an
    empty one touches no device."""
    cfg, gp = _group("heads")
    caches = TL.init_serve_caches(cfg, 2, 8, device="cpu", params=gp)
    e = DG._Decode(DG.GraphCache().stats, cfg, torch.zeros((2, 1), dtype=torch.long), caches, temperature=0.0,
                   pools=None, idx=None, use_kernel=False, fuse_skip=False, unroll=2)
    assert isinstance(e._pools, CardPools) and e._pools.home == torch.device("cpu") and not e._pools
    e.free()
    assert isinstance(e._pools, CardPools) and not e._pools
    pools = CardPools(torch.device("cpu"))
    assert pools == {} and pools.home == torch.device("cpu")
    del pools


@pytest.mark.parametrize("kind", ["heads", "sequence", "recurrent"])
def test_tree_devices_walks_groups_and_split_caches(kind):
    cfg, gp = _group(kind)
    caches = TL.init_serve_caches(cfg, 2, 8, device="cpu", params=gp)
    assert tree_devices((gp, caches, torch.zeros(1))) == [torch.device("cpu")]
    meta = torch.zeros(2, device="meta")
    assert tree_devices([{"a": torch.zeros(1)}, None, (meta, torch.ones(1))]) == [torch.device("cpu"),
                                                                                  torch.device("meta")]
    assert not capturable(tree_devices((gp, meta)))
    assert tree_devices({}) == []


def test_tree_devices_reads_an_epoch_graphs_live_tensors():
    """What ``lm_skiplora.run_epoch_graph`` hands ``tree_devices``: the
    params (a group here), the ``SkipCache`` dataclass, tokens and labels;
    ``storage_sig`` walks the dataclass by its fields too."""
    cfg, gp = _group("heads")
    sl = SL.SkipLoRAConfig(rank=2, mode="full", cache_dtype="float32")
    cache = SL.init_lm_cache(4, cfg, sl, 6, device="cpu")
    tokens = torch.zeros((4, 6), dtype=torch.int32)
    assert tree_devices((gp, cache, tokens, tokens)) == [torch.device("cpu")]
    assert storage_sig(cache) == ("slots",) + storage_sig(cache.slots) + ("valid",) + storage_sig(cache.valid)
    moved = SL.SkipCache(slots={k: v.clone() for k, v in cache.slots.items()}, valid=cache.valid)
    assert storage_sig(moved) != storage_sig(cache)


# ---------------------------------------------------------------------------
# The CPU runs a group's steps eagerly
# ---------------------------------------------------------------------------


def test_cpu_group_decode_and_chunk_capture_nothing():
    cfg, gp = _group("heads")
    before = DG.GRAPHS.stats.copy()
    prompts = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(4))
    caches = TL.init_serve_caches(cfg, 2, 9, device="cpu", params=gp)
    logits, caches = TL.serve_prefill(gp, cfg, prompts, caches)
    tok0 = logits.argmax(-1)
    twin = [{n: TP.zeros_like(t).copy_(t) for n, t in c.items()} for c in caches]
    toks, _ = TL.decode_scan(gp, cfg, tok0, 5, caches, max_new=4, unroll=2)
    want, _ = TL.decode_loop(gp, cfg, tok0, 5, twin, max_new=4)
    assert torch.equal(toks, want)
    stacked = TL.init_stacked_caches(cfg, 2, 9, device="cpu", params=gp)
    tok, pos = tok0.clone(), torch.full((2,), 5, dtype=torch.long)
    active = torch.ones((2,), dtype=torch.bool)
    idx = torch.zeros((2,), dtype=torch.int32)
    _, _, chunk = _chunk_scan(gp, cfg, False, False, 3, None, idx, stacked, tok, pos, active, 0.0, None, 9)
    assert chunk.shape == (3, 2) and torch.equal(pos, torch.full((2,), 8, dtype=torch.long))
    assert DG.GRAPHS.stats == before
