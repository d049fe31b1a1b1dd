"""The port's ``AdapterPool`` and ``grouped_skip_sum`` against
``repro.core.adapter_pool`` on the CPU.

Slot assignment, eviction, version history, gate decisions and statistics
must be identical; pool contents convert to the reference's arrays exactly
(the int8 and 4-bit payloads and scales bitwise), ``register_many`` equals
sequential ``register`` bitwise and ``rollback`` restores a slot bitwise.
``grouped_skip_sum`` is float32 on both sides -> atol 1e-5. After a fleet's
write-back into float, int8, int4 and nf4 pools, ``generate_grouped`` gives
the reference's temperature-0 tokens."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import adapter_pool as JP  # noqa: E402
from repro_torch.convert import pools_to_reference, to_numpy, to_tensor  # noqa: E402
from repro_torch.core import adapter_pool as TP  # noqa: E402

COMPRESS = [None, "int8", "int4", "nf4"]

CFG = reduce_config(get_config("stablelm-1.6b"))
RANK = 4


def _adapters(seed):
    rng = np.random.default_rng(seed)
    l, d = CFG.n_layers, CFG.d_model
    return {
        "A": (rng.normal(size=(l, d, RANK)) / np.sqrt(d)).astype(np.float32),
        "B": (rng.normal(size=(l, RANK, d)) * 0.1).astype(np.float32),
    }


def _pools(compress, n_slots=3):
    return (
        JP.AdapterPool(n_slots, CFG, RANK, compress=compress),
        TP.AdapterPool(n_slots, CFG, RANK, compress=compress, device="cpu"),
    )


@pytest.mark.parametrize("compress", COMPRESS)
def test_zero_slot_stays_exactly_zero(compress):
    _, tp = _pools(compress)
    for i, t in enumerate(["a", "b", "c", "d"]):      # past capacity: evictions
        tp.register(t, _adapters(i))
    for name, arr in tp.pools().items():
        if name == "code":
            continue
        # 4-bit payloads: nibble 0 with scale 0 dequantises to zeros
        assert not arr[0].any()
    assert tp.lookup([None]).tolist() == [TP.ZERO_SLOT]


@pytest.mark.parametrize("compress", COMPRESS)
def test_same_operations_give_the_same_slots_as_the_reference(compress):
    jp, tp = _pools(compress, n_slots=4)
    ops = [
        ("register", "a"), ("register", "b"), ("lookup", ["b", None, "a"]),
        ("register", "c"), ("register", "d"),          # full: evicts LRU "b"
        ("lookup", ["a", "d"]), ("register", "b"),     # evicts "c"
        ("register", "a"),                             # re-register keeps the slot
        ("evict", "d"), ("register", "e"), ("lookup", [None, "e", "a", "b"]),
    ]
    for i, (op, arg) in enumerate(ops):
        if op == "register":
            assert tp.register(arg, _adapters(i)) == jp.register(arg, _adapters(i))
        elif op == "evict":
            jp.evict(arg)
            tp.evict(arg)
        else:
            assert tp.lookup(arg).tolist() == np.asarray(jp.lookup(arg)).tolist()
        assert tp.tenants() == jp.tenants()
    s = jp.stats
    assert (tp.stats.registrations, tp.stats.evictions, tp.stats.lookups, tp.stats.misses) == (
        s.registrations, s.evictions, s.lookups, s.misses)
    with pytest.raises(KeyError):
        tp.lookup(["nobody"])
    with pytest.raises(KeyError):
        jp.lookup(["nobody"])
    assert tp.stats.misses == jp.stats.misses == 1


def test_pinned_tenant_is_never_evicted():
    jp, tp = _pools(None, n_slots=3)
    for pool in (jp, tp):
        pool.register("a", _adapters(0))
        pool.register("b", _adapters(1))
        pool.pin("a")
        pool.lookup(["b"])                      # "a" is now least recent
        pool.register("c", _adapters(2))       # must evict "b", not pinned "a"
        assert pool.has("a") and not pool.has("b")
        pool.pin("c")
        with pytest.raises(RuntimeError, match="pinned"):
            pool.register("d", _adapters(3))
        with pytest.raises(ValueError, match="pinned"):
            pool.evict("a")
        pool.unpin("a")
        pool.register("d", _adapters(3))
        assert not pool.has("a") and pool.has("c")
    assert tp.tenants() == jp.tenants()


@pytest.mark.parametrize("compress", COMPRESS)
def test_pools_convert_to_the_reference_arrays(compress):
    jp, tp = _pools(compress, n_slots=3)
    for i, t in enumerate(["a", "b", "c"]):
        jp.register(t, _adapters(i))
        tp.register(t, {k: to_tensor(v) for k, v in _adapters(i).items()})   # tensors or numpy
    want, got = jp.pools(), tp.pools()
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=k)
    assert tp.nbytes() == jp.nbytes()


@pytest.mark.parametrize("compress", COMPRESS)
def test_grouped_skip_sum_matches_reference(compress):
    jp, tp = _pools(compress, n_slots=4)
    for i, t in enumerate(["a", "b", "c"]):
        jp.register(t, _adapters(i))
        tp.register(t, _adapters(i))
    who = ["c", None, "a", "c", "b"]
    acts = np.random.default_rng(9).normal(size=(CFG.n_layers, len(who), 3, CFG.d_model)).astype(np.float32)
    want = JP.grouped_skip_sum(jnp.asarray(acts), jp.pools(), jp.lookup(who), use_kernel=False)
    got = TP.grouped_skip_sum(to_tensor(acts), tp.pools(), tp.lookup(who))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5)
    assert not to_numpy(got[1]).any()


def test_rejects_bad_geometry_and_unported_compression():
    _, tp = _pools(None)
    with pytest.raises(ValueError, match="shapes"):
        tp.register("a", {"A": np.zeros((1, 2, 3), np.float32), "B": np.zeros((1, 3, 2), np.float32)})
    with pytest.raises(ValueError, match="compression"):
        TP.AdapterPool(3, CFG, RANK, compress="fp8", device="cpu")
    with pytest.raises(ValueError, match="even"):
        TP.AdapterPool(3, CFG, 3, compress="nf4", device="cpu")
    with pytest.raises(ValueError):
        TP.AdapterPool(1, CFG, RANK, device="cpu")


def _stack(seeds):
    ads = [_adapters(i) for i in seeds]
    return {k: np.stack([a[k] for a in ads]) for k in ("A", "B")}


def _same_pools(tp, jp):
    want, got = jp.pools(), pools_to_reference(tp.pools())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].view(np.uint8), np.asarray(want[k]).view(np.uint8), err_msg=k)


@pytest.mark.parametrize("compress", COMPRESS)
def test_register_many_equals_sequential_register_and_the_reference(compress):
    jp, tp = _pools(compress, n_slots=4)
    seq = TP.AdapterPool(4, CFG, RANK, compress=compress, device="cpu")
    for pool in (jp, tp, seq):
        pool.register("x", _adapters(9))
    tenants = ["a", "x", "b"]
    stacked = _stack([3, 4, 5])
    assert tp.register_many(tenants, {k: to_tensor(v) for k, v in stacked.items()}) == \
        jp.register_many(tenants, stacked)
    for i, t in enumerate(tenants):
        seq.register(t, {k: v[i] for k, v in stacked.items()})
    assert tp.tenants() == seq.tenants() == jp.tenants()
    for k, v in tp.pools().items():
        assert torch.equal(v, seq.pools()[k]), k
    _same_pools(tp, jp)
    assert tp.stats.registrations == seq.stats.registrations == jp.stats.registrations == 4
    tp.register_many(["c", "d"], _stack([6, 7]))          # full: evicts the LRU tenants
    jp.register_many(["c", "d"], _stack([6, 7]))
    assert tp.tenants() == jp.tenants() and tp.stats.evictions == jp.stats.evictions
    _same_pools(tp, jp)
    with pytest.raises(ValueError, match="duplicate"):
        tp.register_many(["c", "c"], _stack([1, 2]))
    with pytest.raises(ValueError, match="capacity"):
        tp.register_many(["p", "q", "r", "s"], _stack([1, 2, 3, 4]))


@pytest.mark.parametrize("compress", [None, "nf4"])
def test_gate_decisions_and_version_meta_match_the_reference(compress):
    jp, tp = _pools(compress, n_slots=5)
    for pool in (jp, tp):
        pool.history_depth = 2
        pool.register_many(["a", "b", "c"], _stack([0, 1, 2]), meta={"a": {"step": 3, "eval_loss": 1.5}})
    decisions = {"a": "reject", "b": "quarantine", "c": "accept", "d": "reject"}
    before = {t: tp.slot_payload(t) for t in ("a", "b")}
    meta = {"c": {"step": 7, "eval_loss": 0.25}, "d": {"step": 1}}
    slots_t = tp.register_many(["a", "b", "c", "d"], _stack([5, 6, 7, 8]), gate=decisions.get, meta=meta)
    slots_j = jp.register_many(["a", "b", "c", "d"], _stack([5, 6, 7, 8]), gate=decisions.get, meta=meta)
    assert slots_t == slots_j and tp.tenants() == jp.tenants()
    for t in ("a", "b"):          # gated out: the served version stays, bitwise
        for k, v in tp.slot_payload(t).items():
            assert torch.equal(v, before[t][k])
    for t in ("a", "b", "c", "d"):
        assert tp.version_info(t) == jp.version_info(t)
    assert tp.version_info("a") == {"step": 3, "eval_loss": 1.5, "history": 0}
    assert tp.history_len("c") == 1 and tp.version_info("c")["step"] == 7
    s, js = tp.stats, jp.stats
    assert (s.gate_rejected, s.gate_quarantined, s.registrations) == \
        (js.gate_rejected, js.gate_quarantined, js.registrations) == (1, 1, 5)
    _same_pools(tp, jp)
    with pytest.raises(ValueError, match="gate decision"):
        tp.register_many(["a"], _stack([1]), gate=lambda t: "maybe")


@pytest.mark.parametrize("compress", COMPRESS)
def test_history_and_rollback_are_bitwise(compress):
    jp = JP.AdapterPool(3, CFG, RANK, compress=compress, history=2)
    tp = TP.AdapterPool(3, CFG, RANK, compress=compress, device="cpu", history=2)
    for pool in (jp, tp):
        pool.register("a", _adapters(0), meta={"step": 1, "eval_loss": 2.0})
        pool.register("b", _adapters(1))
    first = tp.slot_payload("a")
    for i in (2, 3, 4):               # three re-registrations: history keeps the last two
        jp.register("a", _adapters(i), meta={"step": i})
        tp.register("a", _adapters(i), meta={"step": i})
    assert tp.history_len("a") == jp.history_len("a") == 2
    second = {k: v.clone() for k, v in tp.slot_payload("a").items()}
    tp.set_eval_loss("a", 0.5)
    jp.set_eval_loss("a", 0.5)
    assert tp.rollback("a") == jp.rollback("a") == {"step": 3, "eval_loss": None}
    assert tp.stats.rollbacks == jp.stats.rollbacks == 1
    _same_pools(tp, jp)
    assert any(not torch.equal(v, second[k]) for k, v in tp.slot_payload("a").items())
    jp.rollback("a")
    tp.rollback("a")
    _same_pools(tp, jp)
    assert tp.version_info("a") == jp.version_info("a") == {"step": 2, "eval_loss": None, "history": 0}
    tp.register("a", _adapters(0), meta={"step": 1})       # the first payload again
    for k, v in tp.slot_payload("a").items():
        assert torch.equal(v, first[k])
    for pool in (jp, tp):
        with pytest.raises(KeyError, match="history"):
            pool.rollback("b")
        with pytest.raises(KeyError):
            pool.version_info("nobody")
    tp.evict("b")
    jp.evict("b")
    assert tp.history_len("b") == 0 and tp.tenants() == jp.tenants()


# ---------------------------------------------------------------------------
# Fleet write-back, then grouped serving from every pool layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compress", [None, "int8"])
def test_version_trail_matches_the_reference(compress):
    """``version`` moves where the reference's does: a new slot assignment
    (also inside ``register_many`` and when it evicts), ``evict`` and
    ``rollback``; never on a re-registration into the tenant's own slot, a
    lookup, a ``touch``, a pin or a gated-out write."""
    pools = (JP.AdapterPool(3, CFG, RANK, compress=compress, history=1),
             TP.AdapterPool(3, CFG, RANK, compress=compress, device="cpu", history=1))
    stacked = {k: np.stack([_adapters(5)[k], _adapters(6)[k]]) for k in ("A", "B")}
    ops = [
        lambda p: p.register("a", _adapters(0)),
        lambda p: p.register("b", _adapters(1)),
        lambda p: p.register("a", _adapters(2)),          # own slot again
        lambda p: p.lookup(["a", None, "b"]),
        lambda p: p.touch(["b", "zz", None]),
        lambda p: p.pin("b"),
        lambda p: p.register("c", _adapters(3)),          # evicts a (b pinned)
        lambda p: p.unpin("b"),
        lambda p: p.rollback("c") if p.history_len("c") else None,
        lambda p: p.register("c", _adapters(4)),
        lambda p: p.rollback("c"),
        lambda p: p.evict("c"),
        lambda p: p.register_many(["b", "d"], stacked),
        lambda p: p.register_many(["b", "d"], stacked, gate=lambda t: "reject"),
    ]
    trails = []
    for pool in pools:
        trail = [pool.version]
        for op in ops:
            op(pool)
            trail.append(pool.version)
        trails.append(trail)
    assert trails[0] == trails[1]
    assert trails[1][-1] > trails[1][0]
    assert trails[1][2] == trails[1][3] == trails[1][4] == trails[1][5] == trails[1][6]


@pytest.fixture(scope="module")
def trained_fleet():
    """A 3-tenant fleet trained by the reference (reduced stablelm-1.6b,
    rank 4, two epochs), and both packages' params."""
    import jax

    from repro.core import fleet_finetune as JFF
    from repro.core import lm_skiplora as JSL
    from repro.models.lm import init_lm
    from repro_torch import convert as C

    jparams = init_lm(jax.random.key(0), CFG)
    tok = jax.random.randint(jax.random.key(1), (3, 4, 8), 0, CFG.vocab_size)
    lab = jax.random.randint(jax.random.key(2), (3, 4, 8), 0, CFG.vocab_size)
    sl = JSL.SkipLoRAConfig(rank=RANK, mode="full", cache_dtype="float32")
    res = JFF.fleet_finetune(jax.random.key(3), CFG, sl, jparams, tok, lab, epochs=2,
                             batch_per_tenant=2, lr=5e-2, use_kernel=False)
    stacked = jax.tree.map(np.asarray, res.adapters)
    return jparams, C.params_from_reference(jax.tree.map(np.asarray, jparams), CFG), stacked


@pytest.mark.parametrize("compress", COMPRESS)
def test_generate_grouped_after_fleet_write_back_gives_the_reference_tokens(trained_fleet, compress):
    from repro.core import fleet_finetune as JFF
    from repro.core.runtime import generate as j_generate
    from repro.core.runtime import generate_grouped as j_generate_grouped
    from repro_torch import convert as C
    from repro_torch.core import fleet_finetune as TFF
    from repro_torch.core.runtime import generate, generate_grouped

    jparams, tparams, stacked = trained_fleet
    jp, tp = _pools(compress, n_slots=4)
    tenants = ["t0", "t1", "t2"]
    assert TFF.write_back_to_pool(tp, tenants, C.adapters_from_reference(stacked)) == \
        JFF.write_back_to_pool(jp, tenants, {k: jnp.asarray(v) for k, v in stacked.items()})
    _same_pools(tp, jp)
    who = ["t2", None, "t0", "t1"]
    prompts = np.random.default_rng(4).integers(0, CFG.vocab_size, (4, 9)).astype(np.int32)
    want = j_generate_grouped(jparams, CFG, jnp.asarray(prompts), jp.pools(), jp.lookup(who), max_new=6,
                              use_kernel=False)
    got = generate_grouped(tparams, CFG, prompts, tp.pools(), tp.lookup(who), max_new=6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    base = generate(tparams, CFG, prompts, max_new=6, device="cpu")
    assert torch.equal(got[1], base[1])                       # the zero slot's row is base-model
    np.testing.assert_array_equal(base.numpy(), np.asarray(j_generate(jparams, CFG, jnp.asarray(prompts),
                                                                      max_new=6)))


def test_len_counts_tenants_as_the_reference_does():
    """``len(pool)`` is the tenant count, as the reference's pool gives it
    (``tests/test_adapter_pool.py``): after registers, a re-register, an
    eviction past capacity and an explicit evict; the sharded pool sums its
    shards'."""
    jp, tp = _pools(None, n_slots=3)
    assert len(tp) == len(jp) == 0
    for i, t in enumerate(["a", "b", "a", "c", "d"]):
        jp.register(t, _adapters(i))
        tp.register(t, _adapters(i))
        assert len(tp) == len(jp)
    jp.evict("d")
    tp.evict("d")
    assert len(tp) == len(jp) == 1
    sharded = TP.ShardedAdapterPool(3, CFG, RANK, n_shards=2, devices=["cpu"])
    for i, t in enumerate(["a", "b", "c"]):
        sharded.register(t, _adapters(i))
    assert len(sharded) == sum(len(p) for p in sharded.shards) == 3
