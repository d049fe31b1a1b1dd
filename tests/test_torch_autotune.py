"""The port's kernel autotuner (``repro_torch.kernels.autotune``) and the
grouped wrappers' tuned defaults (``ops.set_default_tile``), on the CPU.

The twins of the reference's ``tests/test_kernel_speed.py`` autotune and
tile-threading tests, on CPU tensors (the wrappers' plain versions, which
ignore the tile and geometry; ``tests/test_torch_autotune_gpu.py`` sweeps
the kernels on the card): a fake timer decides the winner, a warm cache
times nothing, the cache file is byte-stable and readable by the
reference's ``AutotuneCache``, the tile candidates keep the kernels' range,
the default tile installs and refuses what the kernels do not take, the
plan follows an installed tile, and the roofline prediction is the
reference's formula over the same constants.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import autotune as JAT  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import kv_pool as KV  # noqa: E402
from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels.skip_lora import kernel as K  # noqa: E402
from repro_torch.kernels.skip_lora import ops as O  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread_and_default_tile():
    """Small products on one intra-op thread; the process-wide tile and KV
    block restored whatever a test installs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    O.set_default_tile(None, None)
    KV.set_default_block(None)


def _inputs(m=8, d=32, r=4, lnum=2, n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(lnum, m, d)).astype(np.float32))
    a = torch.as_tensor((rng.normal(size=(n, lnum, d, r)) * 0.1).astype(np.float32))
    b = torch.as_tensor((rng.normal(size=(n, lnum, r, d)) * 0.1).astype(np.float32))
    idx = torch.arange(m, dtype=torch.int32) % n
    return x, a, b, idx


def fake_timer(times):
    calls = []

    def timer(fn):
        out = fn()            # still runs the dispatch (shape checks)
        assert out is not None
        calls.append(None)
        return times[len(calls) - 1]

    return timer


def poisoned(fn):
    raise AssertionError("a cache hit must not re-time")


@pytest.mark.parametrize("variant", AT.VARIANTS)
def test_choice_deterministic_and_cached(tmp_path, variant):
    x, a, b, idx = _inputs()
    tiles, geos = (8, O.TM), ("rule", "few_rows")
    # 4 candidates in sweep order: (8,rule) (8,few) (16,rule) (16,few)
    times = {0: 0.5, 1: 0.2, 2: 0.9, 3: 0.8}
    path = str(tmp_path / "at.json")
    cache = AT.AutotuneCache(path)
    record = []
    ch = AT.tune_grouped(x, a, b, idx, variant, config="t", cache=cache, device="fake", tiles=tiles,
                         geometries=geos, timer=fake_timer(times), record=record)
    assert (ch.tm, ch.grid_order) == (8, "few_rows")
    assert ch.time_s == 0.2 and ch.default_time_s == 0.9
    assert ch.time_s <= ch.default_time_s
    assert cache.misses == 1 and cache.hits == 0
    assert [(tm, g) for tm, g, *_ in record] == [(8, "rule"), (8, "few_rows"), (16, "rule"), (16, "few_rows")]
    outs = [o for *_, o in record]
    assert all(torch.equal(o, outs[0]) for o in outs) and outs[0].shape == (8, 32)

    ch2 = AT.tune_grouped(x, a, b, idx, variant, config="t", cache=AT.AutotuneCache(path), device="fake",
                          tiles=tiles, geometries=geos, timer=poisoned)
    assert (ch2.tm, ch2.grid_order, ch2.source) == (8, "few_rows", "cache")


def test_default_is_always_a_candidate():
    x, a, b, idx = _inputs()
    record = []
    ch = AT.tune_grouped(x, a, b, idx, config="t", device="fake", tiles=(4,), geometries=("many_rows",),
                         timer=fake_timer({0: 0.3, 1: 0.1}), record=record)
    assert [(tm, g) for tm, g, *_ in record] == [(4, "many_rows"), (O.TM, "rule")]
    assert (ch.tm, ch.grid_order, ch.default_time_s) == (O.TM, "rule", 0.1)


def test_cache_round_trip_byte_identical_and_read_by_the_reference(tmp_path):
    x, a, b, idx = _inputs()
    path = str(tmp_path / "at.json")
    cache = AT.AutotuneCache(path)
    AT.tune_grouped(x, a, b, idx, config="t", cache=cache, device="fake", tiles=(8,),
                    timer=fake_timer({0: 0.4, 1: 0.3, 2: 0.5, 3: 0.6}))
    cache.put("t", "fake", "kv_block", AT.Choice(tm=16, grid_order="na", time_s=1e-3, default_time_s=2e-3))
    blob = open(path).read()
    warm = AT.AutotuneCache(path)
    warm.save(path)
    assert open(path).read() == blob
    assert json.loads(blob)["version"] == AT.AutotuneCache.VERSION == JAT.AutotuneCache.VERSION
    ref = JAT.AutotuneCache(path)
    assert ref.entries == warm.entries
    for key in ("grouped", "kv_block"):
        want = warm.get("t", "fake", key)
        got = ref.get("t", "fake", key)
        assert got.as_dict() == want.as_dict()
        assert JAT.Choice.from_dict(json.loads(blob)["entries"][f"t|fake|{key}"]).as_dict() == {
            **want.as_dict(), "source": "measured"}
    assert [f.name for f in AT.dataclasses.fields(AT.Choice)] == [f.name for f in JAT.dataclasses.fields(JAT.Choice)]
    assert AT.config_key(reduce_config(get_config("stablelm-1.6b")), 8) == "stablelm-1.6b-d64-L2-r8"


def test_tile_candidates_keep_floor_max_and_default():
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for m in (1, 4, 5, 8, 1024):
            cands = AT.tile_candidates(m, dtype)
            assert min(cands) == 1 and max(cands) <= K.TM_MAX and O.TM in cands
            assert all(c & (c - 1) == 0 for c in cands)
    assert AT.tile_candidates(4, torch.bfloat16) == (1, 2, 4, 8, 16)
    assert AT.tile_candidates(1024, torch.bfloat16) == (1, 2, 4, 8, 16, 32)
    assert AT.tile_candidates(64, torch.float32, max_tile=8) == (1, 2, 4, 8, 16)
    assert AT.GEOMETRIES == ("rule", "few_rows", "many_rows")
    assert AT.KV_BLOCK_CANDIDATES == JAT.KV_BLOCK_CANDIDATES and AT.UNROLL_CANDIDATES == JAT.UNROLL_CANDIDATES


def test_default_tile_round_trip_and_refusals():
    assert O.get_default_tile() == (O.TM, "rule") == (16, "rule")
    x, a, b, idx = _inputs()
    want = O.skip_lora_grouped(x[:, :, None], a, b, idx)
    try:
        O.set_default_tile(tm=4, geometry="many_rows")
        assert O.get_default_tile() == (4, "many_rows")
        assert torch.equal(O.skip_lora_grouped(x[:, :, None], a, b, idx), want)
        AT.apply_choice(AT.Choice(tm=32, grid_order="few_rows"))
        assert O.get_default_tile() == (32, "few_rows")
        for bad in (0, 33, -16, 2.0, True):
            with pytest.raises(ValueError):
                O.set_default_tile(tm=bad)
        with pytest.raises(ValueError):
            O.set_default_tile(geometry="lm")
        assert O.get_default_tile() == (32, "few_rows")   # a refusal installs nothing
    finally:
        O.set_default_tile(None, None)
    assert O.get_default_tile() == (O.TM, "rule")
    O.set_default_tile(tm=8)
    assert O.get_default_tile() == (8, "rule")
    O.set_default_tile()
    assert O.get_default_tile() == (O.TM, "rule")


def test_plan_follows_the_installed_tile():
    idx = torch.tensor([0, 2, 2, 1, 0], dtype=torch.int32)
    for tm in (1, 4, 16, 32):
        O.set_default_tile(tm=tm)
        row_src, tile_slot = O.grouped_plan(idx, 3)
        m_pad = (5 + tm - 1) // tm * tm + min(3, 5) * tm
        assert row_src.shape == (m_pad,) and tile_slot.shape == (m_pad // tm,)
        assert O.plan_tile((row_src, tile_slot)) == tm
        assert sorted(row_src[row_src >= 0].tolist()) == list(range(5))
        # an explicit tile wins over the default
        assert O.plan_tile(O.grouped_plan(idx, 3, tm=2)) == 2
    O.set_default_tile(None)
    assert O.plan_tile(O.grouped_plan(idx, 3)) == O.TM
    # the serve cell's decode: 4 rows in 4 slots at the untuned tile
    assert O.grouped_plan(torch.arange(4), 4)[0].shape == (80,)


def test_launch_geometry_forces_the_tensor_core_route_only():
    assert K._launch_geometry(torch.bfloat16, 4, 80, None) == K.grouped_fwd_geometry(4, 80) == "few_rows"
    assert K._launch_geometry(torch.bfloat16, 4, 80, "many_rows") == "many_rows"
    assert K._launch_geometry(torch.int8, 1024, 1088, "few_rows") == "few_rows"
    assert K._launch_geometry(torch.bfloat16, 1024, 1088, "rule") == "many_rows"
    # fp32 rows: the CUDA-core route has one geometry; its row class is the rule's
    assert K._launch_geometry(torch.float32, 4, 80, "many_rows") == "few_rows"
    with pytest.raises(ValueError):
        K._launch_geometry(torch.bfloat16, 4, 80, "ml")


@pytest.mark.parametrize("tm", [1, 8, 16, 32])
@pytest.mark.parametrize("bpe", [2, 4])
def test_predict_grouped_time_is_the_reference_formula(monkeypatch, tm, bpe):
    monkeypatch.setattr(JAT, "PEAK_FLOPS", TR.PEAK_FLOPS)
    monkeypatch.setattr(JAT, "HBM_BW", TR.HBM_BW)
    for m, d, r, lnum, n in ((4, 2048, 8, 24, 4), (5, 2048, 8, 24, 6), (1024, 2048, 8, 24, 4)):
        got = AT.predict_grouped_time(m, d, r, lnum, min(n, m), tm, bpe)
        assert got == JAT.predict_grouped_time(m, d, r, lnum, min(n, m), tm, bpe)
        assert got > 0


def test_tune_decode_unroll_with_a_fake_timer():
    x, a, b, idx = _inputs(m=4)
    u, t = AT.tune_decode_unroll(x, a, b, idx, tm=O.TM, grid_order="rule", steps=16,
                                 timer=fake_timer({0: 0.3, 1: 0.1, 2: 0.2}))
    assert (u, t) == (2, 0.1)
    u, t = AT.tune_decode_unroll(x, a, b, idx, tm=4, grid_order="few_rows", steps=3, candidates=(2,),
                                 timer=fake_timer({0: 0.5}))
    assert (u, t) == (2, 0.5)


def test_tune_kv_block_with_a_fake_timer():
    cfg = reduce_config(get_config("stablelm-1.6b"))
    seen = iter([3e-3, 2e-3, 1e-3])   # sweep order (4, 8, 16): 16 fastest

    def timer(fn):
        out = fn()
        assert out.shape[0] == cfg.n_layers and out.shape[1] == 2   # (L, batch, seq, n_kv, hd)
        return next(seen)

    cache = AT.AutotuneCache()
    choice = AT.tune_kv_block(cfg, config="test", seq=16, batch=2, cache=cache, device="fake", timer=timer,
                              on="cpu")
    assert (choice.tm, choice.grid_order, choice.time_s, choice.default_time_s) == (16, "na", 1e-3, 2e-3)
    assert KV.DEFAULT_BLOCK == 8
    again = AT.tune_kv_block(cfg, config="test", seq=16, batch=2, cache=cache, device="fake", timer=poisoned,
                             on="cpu")
    assert (again.tm, again.time_s, again.source) == (16, 1e-3, "cache")
    try:
        AT.apply_kv_block(choice)
        assert KV.get_default_block() == 16
    finally:
        KV.set_default_block(None)
    assert KV.get_default_block() == KV.DEFAULT_BLOCK


def test_device_kind_and_median_timer_on_cpu():
    x, *_ = _inputs()
    assert AT.device_kind(x) == "cpu-plain"
    calls = []
    t = AT.median_timer(iters=3, warmup=2)(lambda: calls.append(1) or x)
    assert len(calls) == 5 and t >= 0.0


@pytest.mark.parametrize("variant", ["grouped", "grouped_nf4"])
def test_cli_smoke_cold_then_warm(tmp_path, capsys, variant):
    path = tmp_path / "at.json"
    AT.main(["--device", "cpu", "--quick", "--cache", str(path), "--variant", variant])
    assert "warm run hit cache" in capsys.readouterr().out
    entries = json.loads(path.read_text())["entries"]
    assert list(entries) == [f"smoke|cpu-plain|{variant}"]
