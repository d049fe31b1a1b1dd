"""The port's checkpoint plane (``repro_torch.checkpoint``, the pools' and
the session runtime's state, ``repro_torch.runtime.fault``) against the
reference's, and the reference's own bars held by the port against itself,
on the CPU.

  - The file format across packages: a tree of bfloat16, int8, uint8, int32,
    bool and float32 leaves saved by either package restores bit for bit
    through the other's ``restore_checkpoint`` / ``_load_dict_tree``, with the
    same manifest. The manager cases of ``tests/test_substrate.py``
    (rotation, ``should_save``, stale ``.tmp`` reaped, in-flight ``.tmp``
    spared) and its ``Supervisor`` / ``StragglerMonitor`` cases.
  - The port against itself, bitwise (``tests/test_runtime.py``'s
    ``TestCheckpoint`` with one shard): save -> restore -> continue equals the
    uninterrupted run (losses, adapters, optimizer moments, pool arrays,
    ``slot_table()``, temperature-0 tokens) in modes full and int8, over a
    resident engine and a disk host tier, with float, int8, int4 and nf4
    pools; quantised pools round-trip their bytes; the loud failures.
  - The control plane and the KV pool (``tests/test_control_plane.py``'s
    ``TestControlCheckpoint``, ``tests/test_kv_pool.py``'s
    ``TestRuntimeCheckpoint``).
  - The port against the reference: a reference session saved with the
    reference's ``save_runtime_session`` is restored into the port
    (``_load_dict_tree`` + ``convert.session_from_reference``) and both
    continue ``adapt(epochs=1)`` + serve: losses within ``LOSS_RTOL``, adapters
    and pools within ``ADAPTER_ATOL`` (``tests/test_torch_runtime.py``'s
    bars), temperature-0 tokens equal; the port's meta equals the
    reference's. A reference KV pool and radix tree restore bitwise.
  - ``SessionSupervisor`` (``tests/test_session_shard.py``'s cases, one
    shard): zero replay and the bitwise continuation; giving up past
    ``max_restarts``.

Reduced stablelm-1.6b, float32, 2 tenants x 4 samples x seq 8, rank 4,
params from the reference's ``init_lm`` carried across by
``repro_torch.convert``; data made with numpy from seeds."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as JCK  # noqa: E402
from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.core.control_plane import ControlConfig as JControl  # noqa: E402
from repro.core.runtime import SessionRuntime as JRuntime  # noqa: E402
from repro.models.lm import init_lm as j_init_lm  # noqa: E402
from repro.models.lm import init_serve_caches as j_init_serve_caches  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.checkpoint import checkpoint as CK  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.core.control_plane import ControlConfig  # noqa: E402
from repro_torch.core.runtime import SessionRuntime  # noqa: E402
from repro_torch.models.lm import init_stacked_caches  # noqa: E402
from repro_torch.runtime import SessionSupervisor, StragglerMonitor, Supervisor, healthy_mesh_shape  # noqa: E402

RANK, N_T, N_PER, SEQ, BPT, LR, NEW = 4, 2, 4, 8, 2, 1e-2, 3
LOSS_RTOL, ADAPTER_ATOL = 1e-5, 2e-5        # tests/test_torch_runtime.py
CFG = reduce_config(get_config("stablelm-1.6b"))
NEVER = dict(holdout_every=4, threshold=float("inf"))


@pytest.fixture(scope="module")
def jp():
    return j_init_lm(jax.random.key(0), CFG)


@pytest.fixture(scope="module")
def tp(jp):
    return C.params_from_reference(jax.tree.map(np.asarray, jp), CFG)


def _sl(mod, mode="full"):
    return mod.SkipLoRAConfig(rank=RANK, mode=mode, cache_dtype="float32")


def _runtime(tp, mode="full", *, n_t=N_T, n_per=N_PER, **kw):
    return SessionRuntime(CFG, _sl(TSL, mode), tp, max_tenants=n_t, samples_per_tenant=n_per, seq=SEQ,
                          lr=LR, device="cpu", **kw)


def _data(n_t=N_T, n_per=N_PER, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.integers(0, CFG.vocab_size, (n_t, n_per, SEQ)).astype(np.int32))
                 for _ in range(2))


def _prompts(n=N_T, seed=9):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, CFG.vocab_size, (n, 6)).astype(np.int32))


def _gen():
    return torch.Generator().manual_seed(3)


def _start(tp, mode="full", *, adapts=1, bpt=BPT, n_per=N_PER, **kw):
    """ingest every tenant, then ``adapts`` adapt calls of one epoch."""
    tok, lab = _data(n_per=n_per)
    rt = _runtime(tp, mode, n_per=n_per, **kw)
    for t in range(N_T):
        rt.ingest(f"u{t}", tok[t], lab[t])
    for a in range(adapts):
        rt.adapt(epochs=1, batch_per_tenant=bpt, generator=_gen() if a == 0 else None)
    return rt


def _bits(x) -> np.ndarray:
    """Any leaf (tensor, jax or numpy array) as its raw bytes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint8)
    x = np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


# ---------------------------------------------------------------------------
# The file format, across packages
# ---------------------------------------------------------------------------


def _kinds_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 5)).astype(np.float32),
        "bf": rng.standard_normal((4, 6)).astype(np.float32),   # stored as bfloat16
        "q": rng.integers(-128, 128, (2, 7)).astype(np.int8),
        "packed": rng.integers(0, 256, (9,)).astype(np.uint8),
        "nest": [{"c": rng.standard_normal((2, 2)).astype(np.float32)}, {"i": np.arange(5, dtype=np.int32)}],
        "flag": np.array([True, False, True]),
    }


def _port_tree(kinds):
    tree = C._map(torch.as_tensor, kinds)
    tree["bf"] = tree["bf"].to(torch.bfloat16)
    tree["nest"][0]["c"] = tree["nest"][0]["c"].to(torch.bfloat16)
    return tree


def _ref_tree(kinds):
    tree = jax.tree.map(jnp.asarray, kinds)
    tree["bf"] = tree["bf"].astype(jnp.bfloat16)
    tree["nest"][0]["c"] = tree["nest"][0]["c"].astype(jnp.bfloat16)
    return tree


def _leaves_bits(tree):
    return {n: _bits(v) for n, v in CK._flatten_with_names(tree)}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_files_cross_read_bitwise(tmp_path, writer):
    """A tree saved by one package restores bit for bit through the other's
    ``restore_checkpoint`` and ``_load_dict_tree``, with the same manifest."""
    kinds = _kinds_np()
    port, ref = _port_tree(kinds), _ref_tree(kinds)
    want = _leaves_bits(port)
    ref_bits = _leaves_bits(ref)
    assert sorted(ref_bits) == sorted(want) and all(np.array_equal(want[k], v) for k, v in ref_bits.items())
    if writer == "port":
        path = CK.save_checkpoint(str(tmp_path), 7, port, extra={"note": "x"})
        got, manifest = JCK.restore_checkpoint(path, jax.tree.map(jnp.zeros_like, ref))
        tree, _ = JCK._load_dict_tree(path)
        assert got["bf"].dtype == jnp.bfloat16 and tree["nest"]["0"]["c"].dtype == jnp.bfloat16
    else:
        path = JCK.save_checkpoint(str(tmp_path), 7, ref, extra={"note": "x"})
        got, manifest = CK.restore_checkpoint(path, C._map(torch.zeros_like, port))
        tree, _ = CK._load_dict_tree(path)
        assert got["bf"].dtype == torch.bfloat16 and tree["nest"]["0"]["c"].dtype == torch.bfloat16
    for name, bits in _leaves_bits(got).items():
        np.testing.assert_array_equal(bits, want[name], err_msg=name)
    for name in want:      # the dict tree: lists come back as dicts keyed "0", "1", ...
        node = tree
        for p in name.split("/"):
            node = node[p]
        np.testing.assert_array_equal(_bits(node), want[name], err_msg=name)
    assert os.path.basename(path) == "ckpt_00000007" and sorted(os.listdir(path)) == ["host_0.npz", "manifest.json"]
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"} and manifest["format"] == 1
    assert {n: m["dtype"] for n, m in manifest["leaves"].items()} == {
        "w": "float32", "bf": "bfloat16", "q": "int8", "packed": "uint8", "nest/0/c": "bfloat16",
        "nest/1/i": "int32", "flag": "bool",
    }


def test_manifests_of_both_packages_agree(tmp_path):
    kinds = _kinds_np(1)
    a = CK.save_checkpoint(str(tmp_path / "port"), 3, _port_tree(kinds))
    b = JCK.save_checkpoint(str(tmp_path / "ref"), 3, _ref_tree(kinds))
    ma, mb = (json.load(open(os.path.join(p, "manifest.json"))) for p in (a, b))
    assert ma["leaves"] == mb["leaves"] and sorted(ma) == sorted(mb)
    za, zb = np.load(os.path.join(a, "host_0.npz")), np.load(os.path.join(b, "host_0.npz"))
    assert sorted(za.files) == sorted(zb.files)
    for n in za.files:
        assert za[n].dtype == zb[n].dtype and np.array_equal(za[n], zb[n]), n


def test_restore_takes_like_leaves_device_and_dtype_and_refuses_shardings(tmp_path):
    path = CK.save_checkpoint(str(tmp_path), 1, {"a": torch.arange(4, dtype=torch.float32)})
    got, _ = CK.restore_checkpoint(path, {"a": torch.zeros(4, dtype=torch.float64)})
    assert got["a"].dtype == torch.float64 and got["a"].device.type == "cpu"
    assert torch.equal(got["a"], torch.arange(4, dtype=torch.float64))
    got, _ = CK.restore_checkpoint(path, {"a": torch.zeros(4)}, shardings={"a": torch.device("cpu")})
    assert got["a"].device.type == "cpu" and torch.equal(got["a"], torch.arange(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="tree of torch.device"):
        CK.restore_checkpoint(path, {"a": torch.zeros(4)}, shardings={"a": "a jax sharding"})


def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(10.0), "b": [{"c": torch.ones((3, 4), dtype=torch.bfloat16)}]}
    path = CK.save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    restored, manifest = CK.restore_checkpoint(path, C._map(torch.zeros_like, tree))
    assert manifest["step"] == 7 and manifest["extra"]["note"] == "x"
    assert torch.equal(restored["a"], torch.arange(10.0))
    assert restored["b"][0]["c"].dtype == torch.bfloat16 and torch.equal(restored["b"][0]["c"], tree["b"][0]["c"])


def test_manager_rotation_and_latest(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path), keep=2, save_every=10)
    tree = {"x": torch.zeros(())}
    for step in (10, 20, 30):
        mgr.save(step, {"x": tree["x"] + step})
    assert len([d for d in os.listdir(tmp_path) if d.startswith("ckpt_")]) == 2
    restored, manifest = CK.restore_checkpoint(CK.latest_checkpoint(str(tmp_path)), tree)
    assert manifest["step"] == 30 and float(restored["x"]) == 30
    assert mgr.restore_latest(tree)[1]["step"] == 30


def test_should_save(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path), save_every=5)
    assert not mgr.should_save(0) and mgr.should_save(5) and not mgr.should_save(6)


def test_crash_leaves_no_corrupt_latest(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"x": torch.ones(())})
    stale = tmp_path / "ckpt_00000002.tmp"    # a crashed write older than the grace window
    os.makedirs(stale)
    old = os.path.getmtime(stale) - mgr.tmp_grace_s - 1
    os.utime(stale, (old, old))
    assert CK.latest_checkpoint(str(tmp_path)).endswith("ckpt_00000001")
    mgr.save(3, {"x": torch.ones(())})        # gc reaps the stale tmp
    assert not stale.exists()


def test_gc_spares_in_flight_tmp_within_grace(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path), keep=1)
    live = tmp_path / "ckpt_00000009.tmp"     # a concurrent atomic write
    os.makedirs(live)
    mgr.save(1, {"x": torch.ones(())})
    assert live.exists()
    old = os.path.getmtime(live) - mgr.tmp_grace_s - 1
    os.utime(live, (old, old))
    mgr.save(2, {"x": torch.ones(())})
    assert not live.exists()


def test_supervisor_restarts_from_checkpoint(tmp_path):
    sup = Supervisor(CK.CheckpointManager(str(tmp_path), keep=3, save_every=2), max_restarts=2)
    calls = {"n": 0, "crashed": False}

    def step_fn(state, step):
        calls["n"] += 1
        if step == 3 and not calls["crashed"]:
            calls["crashed"] = True
            raise RuntimeError("simulated node failure")
        return {"x": state["x"] + 1}

    out = sup.run({"x": torch.zeros(())}, step_fn, num_steps=5)
    # steps 0, 1 (saved at 2), 2, 3 crashes -> back to the checkpoint -> 2, 3, 4
    assert float(out["x"]) == 5.0 and calls["crashed"] and calls["n"] == 7


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    sup = Supervisor(CK.CheckpointManager(str(tmp_path), save_every=100), max_restarts=1)

    def bad_step(state, step):
        raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent"):
        sup.run({"x": torch.zeros(())}, bad_step, num_steps=3)


def test_straggler_detection_and_healthy_mesh_shape():
    mon = StragglerMonitor(window=16, factor=2.0)
    for _ in range(10):
        assert not mon.record(1.0)
    assert mon.record(5.0)       # 5x the median
    assert not mon.record(1.1)
    assert mon.median == 1.0
    assert healthy_mesh_shape(256, 16) == (16, 16)
    assert healthy_mesh_shape(240, 16) == (15, 16)
    with pytest.raises(RuntimeError):
        healthy_mesh_shape(8, 16)


# ---------------------------------------------------------------------------
# The port against itself, bitwise
# ---------------------------------------------------------------------------


def _state(rt):
    """Everything the continuation bars compare, as host copies."""
    return {
        "adapters": {t: {k: v.clone() for k, v in rt.tenant(t).adapters.items()} for t in rt.pool.tenants()},
        "moments": {t: {k: v.clone() for k, v in rt.tenant(t).opt_mu.items()} for t in rt.pool.tenants()},
        "pools": {k: v.clone() for k, v in rt.pool.pools().items()},
        "table": rt.pool.slot_table(),
    }


def _assert_same(a, b):
    for t in a["adapters"]:
        for k in ("A", "B"):
            assert torch.equal(a["adapters"][t][k], b["adapters"][t][k]), (t, k)
            assert torch.equal(a["moments"][t][k], b["moments"][t][k]), (t, k)
    assert a["pools"].keys() == b["pools"].keys()
    for k in a["pools"]:
        assert a["pools"][k].dtype == b["pools"][k].dtype and torch.equal(a["pools"][k], b["pools"][k]), k
    assert a["table"] == b["table"]


@pytest.mark.parametrize("mode,engine,compress", [
    ("full", "resident", None),
    ("full", "disk", None),
    ("int8", "resident", "int8"),
    ("int8", "disk", "int8"),
    ("full", "resident", "int4"),
    ("full", "resident", "nf4"),
])
def test_save_restore_continue_equals_uninterrupted_run(tp, tmp_path, mode, engine, compress):
    """A session checkpoint round-trips the whole session, and continuing the
    restored session reproduces the uninterrupted run bitwise: losses,
    adapters, optimizer moments, pool arrays, ``slot_table()`` and
    temperature-0 tokens."""
    def kw(tag):
        out = {"pool_compress": compress}
        if engine == "disk":
            out.update(cache_capacity=N_T * N_PER // 2, cache_dir=str(tmp_path / tag))
        return out

    prompts = _prompts()
    rt_ref = _start(tp, mode, **kw("ref"))                   # uninterrupted
    path = CK.save_runtime_session(str(tmp_path / "ck"), 1, _start(tp, mode, **kw("saved")))
    rt_new = _runtime(tp, mode, **kw("new"))                 # restart
    CK.restore_runtime_session(path, rt_new)
    _assert_same(_state(rt_new), _state(rt_ref))
    assert [(t, rt_new.tenant(t).step, rt_new.tenant(t).epochs_done) for t in ("u0", "u1")] == \
           [(t, rt_ref.tenant(t).step, rt_ref.tenant(t).epochs_done) for t in ("u0", "u1")]
    outs = [rt.adapt(epochs=1, batch_per_tenant=BPT) for rt in (rt_ref, rt_new)]
    assert outs[0]["path"] == outs[1]["path"] == ("stream" if engine == "disk" else "scan")
    for t in ("u0", "u1"):
        np.testing.assert_array_equal(outs[0]["losses"][t], outs[1]["losses"][t])
    _assert_same(_state(rt_new), _state(rt_ref))
    assert torch.equal(rt_ref.serve(["u0", "u1"], prompts, max_new=NEW),
                       rt_new.serve(["u0", "u1"], prompts, max_new=NEW))
    if engine == "disk":
        assert rt_new.engine.stats.spills > 0 and any(p.suffix == ".bin" for p in (tmp_path / "new").iterdir())
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    lay = manifest["extra"]["session"]["layout"]
    assert (lay["n_shards"], lay["mesh_shape"], lay["mesh_axes"], lay["model_parallel"], lay["pipeline_stages"]) \
        == (1, [1], ["data"], 1, 0)
    assert (lay["pool_compress"], lay["pool_slots"], lay["max_tenants"]) == (compress, N_T + 1, N_T)


@pytest.mark.parametrize("compress", ["int4", "nf4"])
def test_quantized_pool_roundtrip_bitwise(tp, tmp_path, compress):
    """Quantised pool state is bytes: packed nibbles, rowwise scales and the
    16-entry codebook survive save -> restore bit for bit, and the restored
    session serves the same tokens."""
    rt = _start(tp, pool_compress=compress)
    prompts = _prompts()
    served = rt.serve(["u0", "u1"], prompts, max_new=NEW)
    path = CK.save_runtime_session(str(tmp_path), 1, rt)
    rt_new = _runtime(tp, pool_compress=compress)
    CK.restore_runtime_session(path, rt_new)
    for t in ("u0", "u1"):
        old, new = rt.pool.slot_payload(t), rt_new.pool.slot_payload(t)
        assert set(old) == set(new) == {"qa4", "sa", "qb4", "sb"}
        for n in old:
            assert old[n].dtype == new[n].dtype and torch.equal(old[n], new[n]), n
    assert torch.equal(rt.pool.pools()["code"], rt_new.pool.pools()["code"])
    assert rt_new.pool.version > 0
    assert torch.equal(served, rt_new.serve(["u0", "u1"], prompts, max_new=NEW))


def test_restore_rejects_mismatched_configuration(tp, tmp_path):
    """The manifest records the pool's compression, slot count and tenant
    capacity, and the session's layout: a restore into another session fails
    loudly."""
    rt = _runtime(tp, n_t=1, pool_compress="int4")
    tok, lab = _data()
    rt.ingest("u0", tok[0], lab[0])
    rt.adapt(epochs=1, batch_per_tenant=2, generator=_gen())
    path = CK.save_runtime_session(str(tmp_path), 0, rt)
    for bad in ({"pool_compress": "int8"}, {"pool_compress": None}, {"pool_compress": "int4", "n_t": 3},
                {"pool_compress": "int4", "n_t": 1, "pool_slots": 4}):
        with pytest.raises(ValueError, match="identically-configured"):
            CK.restore_runtime_session(path, _runtime(tp, **bad))
    with pytest.raises(ValueError, match="layout"):
        CK.restore_runtime_session(path, _runtime(tp, n_t=1, n_per=8, pool_compress="int4"))
    with pytest.raises(ValueError, match="layout"):
        CK.restore_runtime_session(path, _runtime(tp, "int8", n_t=1, pool_compress="int4"))


def test_restore_requires_fresh_runtime(tp, tmp_path):
    rt = _runtime(tp)
    tok, lab = _data(n_t=1)
    rt.ingest("u0", tok[0], lab[0])
    path = CK.save_runtime_session(str(tmp_path), 0, rt)
    with pytest.raises(RuntimeError, match="fresh"):
        CK.restore_runtime_session(path, rt)


def test_restored_partitions_and_untrained_tenants(tp, tmp_path):
    """An ingested but untrained tenant keeps its partition and rows; the
    free partitions stay smallest first; the next ingest of a new tenant
    lands where it would have in the uninterrupted session."""
    tok, lab = _data(n_t=3)
    runs = []
    for restore in (False, True):
        rt = _runtime(tp, n_t=3)
        rt.ingest("a", tok[0], lab[0])
        rt.ingest("b", tok[1], lab[1])
        rt.adapt(["a"], epochs=1, batch_per_tenant=2, generator=_gen())
        rt.release("a")
        if restore:
            new = _runtime(tp, n_t=3)
            CK.restore_runtime_session(CK.save_runtime_session(str(tmp_path), 0, rt), new)
            assert not new.tenant("b").trained and new._free_partitions == rt._free_partitions == [2, 0]
            rt = new
        rt.ingest("c", tok[2], lab[2])
        runs.append(rt)
    assert runs[0].tenant("c").partition == runs[1].tenant("c").partition == 0
    ids = list(range(3 * N_PER))
    ids = [i for i in ids if runs[0].engine.has(i)]
    assert ids == [i for i in range(3 * N_PER) if runs[1].engine.has(i)]
    a, b = runs[0].engine.read(ids), runs[1].engine.read(ids)
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# The control plane and the KV pool
# ---------------------------------------------------------------------------


def _controlled(tp, control):
    """Two adapts over 8 rows a tenant: version 1 goes to history."""
    return _start(tp, n_per=8, bpt=4, adapts=2, control=ControlConfig(**control))


def test_history_and_ledger_survive_restore(tp, tmp_path):
    rt = _controlled(tp, NEVER)
    assert rt.pool.history_len("u0") == 1
    path = CK.save_runtime_session(str(tmp_path), 1, rt)
    rt_new = _runtime(tp, n_per=8, control=ControlConfig(**NEVER))
    CK.restore_runtime_session(path, rt_new)
    assert rt_new.control_metrics() == rt.control_metrics()
    assert rt_new.pool.version_info("u0") == rt.pool.version_info("u0")
    assert rt_new.pool.history_len("u0") == 1
    # rolling both back lands on the same payload and the same tokens
    assert rt.rollback("u0") == rt_new.rollback("u0")
    for n, v in rt.pool.slot_payload("u0").items():
        assert torch.equal(v, rt_new.pool.slot_payload("u0")[n]), n
    prompts = _prompts(n=1)
    assert torch.equal(rt.serve(["u0"], prompts, max_new=4), rt_new.serve(["u0"], prompts, max_new=4))


def test_quarantine_set_survives_restore(tp, tmp_path):
    quar = dict(holdout_every=4, threshold=float("-inf"), mode="quarantine")
    rt = _controlled(tp, quar)
    assert rt.control.is_quarantined("u0")
    rt_new = _runtime(tp, n_per=8, control=ControlConfig(**quar))
    CK.restore_runtime_session(CK.save_runtime_session(str(tmp_path), 1, rt), rt_new)
    assert rt_new.control.is_quarantined("u0")
    assert rt_new.control.quarantined == rt.control.quarantined


def test_restore_into_uncontrolled_runtime_fails_loudly(tp, tmp_path):
    path = CK.save_runtime_session(str(tmp_path), 1, _controlled(tp, NEVER))
    with pytest.raises(ValueError, match="control"):
        CK.restore_runtime_session(path, _runtime(tp, n_per=8))


def _random_caches(seed):
    caches = init_stacked_caches(CFG, 1, 8, device="cpu")
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g).to(v.dtype) for k, v in caches.items()}


def test_session_state_roundtrips_kv_pool_and_radix(tp, tmp_path):
    """Pool bytes, refs, free list and radix matches round-trip, through a
    file; the refcounts are rebuilt from the tree, so nothing leaks."""
    rt = _runtime(tp)
    pool = rt.kv_pool(block=4, n_blocks=8)
    idx = rt.prefix_index()
    t = np.random.default_rng(18).integers(0, 50, 10).astype(np.int32)
    created = idx.insert("t0", t)
    pool.publish(_random_caches(19), 0, [bid for bid, _ in created], [slot for _, slot in created])
    path = CK.save_runtime_session(str(tmp_path), 0, rt)
    meta = json.load(open(os.path.join(path, "manifest.json")))["extra"]["session"]
    assert set(meta["kv_pool"]) == {"0"} and meta["kv_pool"]["0"]["radix"] == idx.state()
    rt2 = _runtime(tp)
    CK.restore_runtime_session(path, rt2)
    pool2 = rt2.kv_pool()
    assert (pool2.n_blocks, pool2.block) == (8, 4) and pool2.generation == 1
    np.testing.assert_array_equal(pool2.refs, pool.refs)
    assert pool2.free == pool.free
    assert rt2.prefix_index().match("t0", t) == idx.match("t0", t)
    for n in ("k", "v"):
        assert pool2.data[n].dtype == torch.bfloat16 and torch.equal(pool2.data[n], pool.data[n])
    rt2.check_prefix_no_leaks()
    with pytest.raises(ValueError, match="identically-sized"):
        rt3 = _runtime(tp)
        rt3.kv_pool(block=4, n_blocks=4)
        CK.restore_runtime_session(path, rt3)


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------


def _j_runtime(jp, **kw):
    return JRuntime(CFG, _sl(JSL), jp, max_tenants=N_T, samples_per_tenant=8, seq=SEQ, lr=LR,
                    use_kernel=False, **kw)


def test_reference_session_restores_into_the_port(jp, tp, tmp_path):
    """serve -> ingest -> adapt in the reference, saved with its own
    ``save_runtime_session``; the port restores the files and both continue
    ``adapt(epochs=1)`` and a serve within the port's bars, with equal
    temperature-0 tokens and equal meta."""
    tok, lab = _data(n_per=8, seed=4)
    prompts = _prompts(n=N_T + 1)
    jrt = _j_runtime(jp, control=JControl(**NEVER))
    jrt.serve([None] * (N_T + 1), jnp.asarray(prompts.numpy()), max_new=NEW)
    for t in range(N_T):
        jrt.ingest(f"u{t}", jnp.asarray(tok[t].numpy()), jnp.asarray(lab[t].numpy()))
    jrt.adapt(epochs=1, batch_per_tenant=4, key=jax.random.key(3))
    path = JCK.save_runtime_session(str(tmp_path), 1, jrt)

    arrays, manifest = CK._load_dict_tree(path)
    arrays, meta = C.session_from_reference(arrays, manifest["extra"]["session"], CFG)
    trt = SessionRuntime(CFG, _sl(TSL), tp, max_tenants=N_T, samples_per_tenant=8, seq=SEQ, lr=LR,
                         device="cpu", control=ControlConfig(**NEVER))
    trt.load_session_state(arrays, meta)
    jmeta = manifest["extra"]["session"]
    _, tmeta = trt.session_state()
    for k in ("tenants", "trained", "present", "control"):
        assert tmeta[k] == jmeta[k], k
    assert tmeta["pool_table"] == jmeta["pool_table"]["shards"][0]

    jout = jrt.adapt(epochs=1, batch_per_tenant=4)
    tout = trt.adapt(epochs=1, batch_per_tenant=4)
    scale = max(1.0, float(arrays["cache"]["acts"].abs().max()))
    for t in ("u0", "u1"):
        np.testing.assert_allclose(tout["losses"][t], np.asarray(jout["losses"][t]), rtol=LOSS_RTOL)
        for k in ("A", "B"):
            np.testing.assert_allclose(trt.tenant(t).adapters[k].numpy(), np.asarray(jrt.tenant(t).adapters[k]),
                                       atol=ADAPTER_ATOL * scale)
    jpool = jrt.pool.shards[0].pools()
    for k, v in trt.pool.pools().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jpool[k]), atol=ADAPTER_ATOL * scale)
    assert trt.pool.slot_table() == jrt.pool.shards[0].slot_table()
    assert trt.control_metrics() == jrt.control_metrics()
    who = [None, "u0", "u1"]
    np.testing.assert_array_equal(trt.serve(who, prompts, max_new=NEW).numpy(),
                                  np.asarray(jrt.serve(who, jnp.asarray(prompts.numpy()), max_new=NEW)))


def test_reference_kv_pool_and_radix_restore_into_the_port_bitwise(jp, tp, tmp_path):
    """The reference's periods/remainder KV capture lands in the port's
    {"k", "v"} layout bit for bit (bf16 through the file), with the same
    refs, free list and radix matches, and no leaks."""
    jrt = _j_runtime(jp)
    pool = jrt.kv_pool(0, block=4, n_blocks=8)
    idx = jrt.prefix_index(0)
    t = np.random.default_rng(18).integers(0, 50, 10).astype(np.int32)
    created = idx.insert("t0", t)
    caches = j_init_serve_caches(CFG, 1, 8)
    leaves, treedef = jax.tree.flatten(caches)
    keys = jax.random.split(jax.random.key(19), len(leaves))
    caches = jax.tree.unflatten(treedef, [jax.random.normal(k, x.shape).astype(x.dtype)
                                          for k, x in zip(keys, leaves)])
    pool.publish(caches, 0, [bid for bid, _ in created], [slot for _, slot in created])
    path = JCK.save_runtime_session(str(tmp_path), 0, jrt)
    arrays, manifest = CK._load_dict_tree(path)
    trt = SessionRuntime(CFG, _sl(TSL), tp, max_tenants=N_T, samples_per_tenant=8, seq=SEQ, device="cpu")
    trt.load_session_state(*C.session_from_reference(arrays, manifest["extra"]["session"], CFG))
    tpool = trt.kv_pool()
    got = C.stacked_to_reference(tpool.data, CFG)
    want = jax.tree.map(lambda x: np.asarray(x, np.float32), pool.data)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tpool.refs, pool.refs)
    assert tpool.free == pool.free
    assert trt.prefix_index().match("t0", t) == idx.match("t0", t)
    trt.check_prefix_no_leaks()


def test_session_from_reference_refuses_several_shards(jp):
    """A capture whose pool table disagrees with its layout's shard count is
    refused (a multi-shard capture itself converts: test_torch_session_shard)."""
    meta = {"layout": {"n_shards": 2}, "pool_table": {"n_shards": 1, "placement": [], "shards": [{}]}}
    with pytest.raises(ValueError, match="laid out for 2"):
        C.session_from_reference({"pool": {}}, meta, CFG)


# ---------------------------------------------------------------------------
# The session supervisor
# ---------------------------------------------------------------------------


def test_zero_replay_restart_reproduces_uninterrupted_run(tp, tmp_path):
    """A crash drill: every completed event runs once across incarnations,
    the failed event twice (its first attempt's partial state goes with the
    runtime), and the final adapters and slot table equal the uninterrupted
    run's bitwise."""
    tok, lab = _data()
    prompts = _prompts()
    counts = [0] * 4
    armed = {"on": True}

    def events(counting):
        def ingest(t):
            def run(rt, i):
                counts[i] += counting
                return rt.ingest(f"u{t}", tok[t], lab[t])
            return run

        def adapt(rt, i):
            counts[i] += counting
            if counting and armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected mid-adapt failure")
            return rt.adapt(epochs=1, batch_per_tenant=2, generator=_gen())

        def serve(rt, i):
            counts[i] += counting
            return rt.serve(["u0", "u1"], prompts, max_new=NEW)

        return [ingest(0), ingest(1), adapt, serve]

    rt_ref = _runtime(tp)
    results_ref = [ev(rt_ref, i) for i, ev in enumerate(events(False))]
    rt, info = SessionSupervisor(str(tmp_path / "ckpt"), save_every=1).run(lambda: _runtime(tp), events(True))
    assert info["restarts"] == 1 and info["resumed_at"] == 2
    assert counts == [1, 1, 2, 1]
    assert sorted(info["results"]) == [0, 1, 2, 3] and torch.equal(info["results"][3], results_ref[3])
    for t in ("u0", "u1"):
        for k in ("A", "B"):
            assert torch.equal(rt.tenant(t).adapters[k], rt_ref.tenant(t).adapters[k])
    assert rt.pool.slot_table() == rt_ref.pool.slot_table()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_00000002", "ckpt_00000003", "ckpt_00000004"]


def test_session_supervisor_gives_up_past_max_restarts(tp, tmp_path):
    calls = []

    def always_fails(rt, i):
        calls.append(i)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        SessionSupervisor(str(tmp_path / "ckpt"), max_restarts=1).run(lambda: _runtime(tp), [always_fails])
    assert calls == [0, 0]


@pytest.mark.parametrize("compress", ["int4", "nf4"])
def test_quantized_pool_roundtrip_bitwise_sharded(tp, tmp_path, compress):
    """``test_quantized_pool_roundtrip_bitwise`` over 2 logical shards
    (``tests/test_runtime.py``'s ``shards=2`` case): each shard's packed
    nibbles, scales and codebook survive save -> restore bit for bit, the
    arrays keyed ``s<i>``, and the restored session serves the same tokens."""
    rt = _start(tp, pool_compress=compress, placement_shards=2)
    prompts = _prompts()
    served = rt.serve(["u0", "u1"], prompts, max_new=NEW)
    path = CK.save_runtime_session(str(tmp_path), 1, rt)
    rt_new = _runtime(tp, pool_compress=compress, placement_shards=2)
    CK.restore_runtime_session(path, rt_new)
    arrays, _ = CK._load_dict_tree(path)
    assert set(arrays["pool"]) == {"s0", "s1"}
    for t, s in (("u0", 0), ("u1", 1)):
        assert rt_new.pool.shard_of(t) == s
        old, new = rt.pool.slot_payload(t), rt_new.pool.slot_payload(t)
        assert set(old) == set(new) == {"qa4", "sa", "qb4", "sb"}
        for n in old:
            assert old[n].dtype == new[n].dtype and torch.equal(old[n], new[n]), n
        assert torch.equal(rt.pool.shard_pools(s)["code"], rt_new.pool.shard_pools(s)["code"])
    assert rt_new.pool.slot_table() == rt.pool.slot_table()
    assert torch.equal(served, rt_new.serve(["u0", "u1"], prompts, max_new=NEW))
