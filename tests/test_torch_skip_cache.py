"""The port's Skip-Cache (``repro_torch.core.skip_cache``) against
``repro.core.skip_cache``: writes, masked writes, reads, hits and sizes
give the same slots and validity bits (exact: they only move data)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import skip_cache as JC  # noqa: E402
from repro_torch.convert import cache_from_reference, cache_to_numpy, to_numpy  # noqa: E402
from repro_torch.core import skip_cache as TC  # noqa: E402

SHAPES = {"x1": (3,), "y_base": (2, 2)}


def _assert_same(tcache, jcache):
    got = cache_to_numpy(tcache)
    for name, arr in jcache.slots.items():
        np.testing.assert_array_equal(got[name], np.asarray(arr))
    np.testing.assert_array_equal(got["valid"], np.asarray(jcache.valid))


def test_write_masked_write_and_read_match_reference():
    rng = np.random.default_rng(0)
    jc, tc = JC.init_cache(6, SHAPES), TC.init_cache(6, SHAPES)
    steps = [
        (np.array([4, 1]), None),
        (np.array([0, 5, 2]), np.array([True, False, True])),
        (np.array([1, 3]), np.array([False, True])),
    ]
    for idx, mask in steps:
        vals = {k: rng.normal(size=(len(idx),) + s).astype(np.float32) for k, s in SHAPES.items()}
        jv = {k: jnp.asarray(v) for k, v in vals.items()}
        tv = {k: torch.as_tensor(v) for k, v in vals.items()}
        if mask is None:
            jc = JC.cache_write(jc, jnp.asarray(idx), jv)
            out = TC.cache_write(tc, torch.as_tensor(idx), tv)
        else:
            jc = JC.cache_write_masked(jc, jnp.asarray(idx), jv, jnp.asarray(mask))
            out = TC.cache_write_masked(tc, torch.as_tensor(idx), tv, torch.as_tensor(mask))
        assert out is tc   # written in place
        _assert_same(tc, jc)
    idx = np.array([3, 0, 4])
    want = JC.cache_read(jc, jnp.asarray(idx))
    got = TC.cache_read(tc, torch.as_tensor(idx))
    for k in SHAPES:
        np.testing.assert_array_equal(to_numpy(got[k]), np.asarray(want[k]))
    np.testing.assert_array_equal(to_numpy(TC.cache_hits(tc, torch.as_tensor(idx))),
                                  np.asarray(JC.cache_hits(jc, jnp.asarray(idx))))
    assert int(tc.hit_count()) == int(jc.hit_count()) == 5
    assert TC.cache_nbytes(tc) == JC.cache_nbytes(jc)
    assert tc.num_samples == jc.num_samples


def test_mlp_layout_and_conversion_from_reference():
    jc = JC.cache_for_mlp(5, (8, 6, 6, 3))
    tc = TC.cache_for_mlp(5, (8, 6, 6, 3))
    assert {k: tuple(v.shape) for k, v in tc.slots.items()} == {k: v.shape for k, v in jc.slots.items()}
    jc = JC.cache_write(jc, jnp.asarray([2]), {"x1": jnp.ones((1, 6)), "x2": jnp.ones((1, 6)),
                                              "y_base": jnp.ones((1, 3))})
    _assert_same(cache_from_reference(jax.tree.map(np.asarray, jc)), jc)
