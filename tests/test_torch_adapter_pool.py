"""The port's ``AdapterPool`` and ``grouped_skip_sum`` against
``repro.core.adapter_pool`` on the CPU.

Slot assignment, eviction and statistics must be identical; pool contents
convert to the reference's arrays exactly (the int8 payload and scales
bitwise). ``grouped_skip_sum`` is float32 on both sides -> atol 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import adapter_pool as JP  # noqa: E402
from repro_torch.convert import to_numpy, to_tensor  # noqa: E402
from repro_torch.core import adapter_pool as TP  # noqa: E402

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


@pytest.mark.parametrize("compress", [None, "int8"])
def test_zero_slot_stays_exactly_zero(compress):
    _, tp = _pools(compress)
    for i, t in enumerate(["a", "b", "c", "d"]):      # past capacity: evictions
        tp.register(t, _adapters(i))
    for arr in tp.pools().values():
        assert not arr[0].any()
    assert tp.lookup([None]).tolist() == [TP.ZERO_SLOT]


@pytest.mark.parametrize("compress", [None, "int8"])
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


@pytest.mark.parametrize("compress", [None, "int8"])
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


@pytest.mark.parametrize("compress", [None, "int8"])
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
    with pytest.raises(ValueError):
        TP.AdapterPool(3, CFG, RANK, compress="nf4", device="cpu")
    with pytest.raises(ValueError):
        TP.AdapterPool(1, CFG, RANK, device="cpu")
