"""The session's data axis in the port (``runtime.sharding``,
``ShardedAdapterPool``, the multi-shard ``SessionRuntime``, its scheduler,
checkpoints, the elastic restore and the CLIs), on the CPU: counterparts of
``tests/test_session_shard.py``.

  - ``TestLogicalShards``: several logical shards on one device. A 2-shard
    session equals its 1-shard twin bitwise in adapters, losses and
    temperature-0 tokens (the reference holds the adapters and tokens; the
    port's CPU products are row-independent here, so the losses hold too);
    tenants and partitions go round robin and same-shard tenants form one
    adapt group; a 2-shard checkpoint continues bitwise; a shard-count
    mismatch is refused; a shard's partitions fill on their own.
  - ``TestShardedPool``: placement, routing, the split write-back and the
    one-shard pool surface.
  - ``TestSupervisor``: the crash drill over 2 shards, zero replay; giving up.
  - ``make_mesh`` and the mesh helpers; a model axis's layout and the
    reference's refusals on it.
  - The multi-device tier in one process, over meshes that repeat the CPU
    device (the port's form of the reference's forced host devices):
    ``launch.run --devices 2 --check-parity`` prints ``parity OK``, an
    elastic 4 -> 2 restore continues bitwise, the CLI's elastic crash drill.
  - Against the JAX package: the reference's 2-shard session and the port's,
    both from the same weights (``convert``), after ingest -> adapt -> serve:
    losses within rtol 1e-5 and adapters and pools within atol 2e-5
    (``tests/test_torch_runtime.py``'s bars), temperature-0 tokens equal;
    a reference 2-shard capture restored through
    ``convert.session_from_reference`` continues as the reference does.

Reduced stablelm-1.6b, float32, rank 4, seq 8, one intra-op thread."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as JCK  # noqa: E402
from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import fleet_finetune as JFF  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.core.runtime import SessionRuntime as JRuntime  # noqa: E402
from repro.models.lm import init_lm as j_init_lm  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.checkpoint import checkpoint as CK  # noqa: E402
from repro_torch.core import fleet_finetune as TFF  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.core.adapter_pool import ShardedAdapterPool  # noqa: E402
from repro_torch.core.runtime import SessionRuntime  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import run  # noqa: E402
from repro_torch.runtime import SessionSupervisor, elastic_remesh, elastic_session_mesh  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402

RANK, SEQ, NEW, LR = 4, 8, 3, 1e-2
LOSS_RTOL, ADAPTER_ATOL = 1e-5, 2e-5        # tests/test_torch_runtime.py
CFG = reduce_config(get_config("stablelm-1.6b"))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jp():
    return j_init_lm(jax.random.key(0), CFG)


@pytest.fixture(scope="module")
def tp(jp):
    return C.params_from_reference(jax.tree.map(np.asarray, jp), CFG)


def _sl(mod=TSL):
    return mod.SkipLoRAConfig(rank=RANK, mode="full", cache_dtype="float32")


def _runtime(tp, *, n_t=2, n_per=4, shards=1, devices=None, **kw):
    mesh = None if devices is None else SH.make_mesh((devices,), ("data",), devices=[CPU] * devices)
    return SessionRuntime(CFG, _sl(), tp, max_tenants=n_t, samples_per_tenant=n_per, seq=SEQ, lr=LR,
                          placement_shards=shards, mesh=mesh, device=None if mesh is not None else "cpu", **kw)


def _data(n_t, n_per, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.integers(0, CFG.vocab_size, (n_t, n_per, SEQ)).astype(np.int32))
                 for _ in range(2))


def _prompts(n, seed=5):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, CFG.vocab_size, (n, 6)).astype(np.int32))


def _gen():
    return torch.Generator().manual_seed(3)


def _session(rt, tokens, labels, prompts, *, epochs=1, bpt=2):
    """serve (base) -> ingest every tenant -> adapt -> serve the tenants."""
    n_t = tokens.shape[0]
    rt.serve([None] * prompts.shape[0], prompts, max_new=NEW)
    for t in range(n_t):
        rt.ingest(f"u{t}", tokens[t], labels[t])
    out = rt.adapt(epochs=epochs, batch_per_tenant=bpt, generator=_gen())
    toks = rt.serve([f"u{t}" for t in range(n_t)][: prompts.shape[0]], prompts, max_new=NEW)
    return out, toks


def _same_tenants(a, b, names, what=("adapters", "opt_mu", "opt_nu")):
    for n in names:
        for name in what:
            for k in ("A", "B"):
                assert torch.equal(getattr(a.tenant(n), name)[k], getattr(b.tenant(n), name)[k]), (n, name, k)


# ---------------------------------------------------------------------------
# Several logical shards on one device
# ---------------------------------------------------------------------------


class TestLogicalShards:
    def test_multi_shard_adapters_bitwise_vs_single(self, tp):
        """Splitting the session into logical shards regroups the adapt
        calls by shard; adapters, losses, moments and temperature-0 tokens
        do not move."""
        tokens, labels = _data(2, 4)
        prompts = _prompts(2)
        rt1, rt2 = _runtime(tp, shards=1), _runtime(tp, shards=2)
        out1, toks1 = _session(rt1, tokens, labels, prompts)
        out2, toks2 = _session(rt2, tokens, labels, prompts)
        assert out2["groups"] == [["u0"], ["u1"]] and out1["groups"] == [["u0", "u1"]]
        _same_tenants(rt1, rt2, ["u0", "u1"])
        for n in ("u0", "u1"):
            np.testing.assert_array_equal(out1["losses"][n], out2["losses"][n])
        assert torch.equal(toks1, toks2)
        assert rt2.counters["serve/shard_dispatches"] == 2 and "serve/shard_dispatches" not in rt1.counters

    def test_partition_and_slot_placement_round_robin(self, tp):
        rt = _runtime(tp, n_t=4, shards=2)
        tokens, labels = _data(4, 4)
        for t in range(4):
            rt.ingest(f"u{t}", tokens[t], labels[t])
        for t in range(4):   # tenant t -> shard t % 2, partition t (its shard's smallest free)
            assert rt.tenant(f"u{t}").partition == t and rt.pool.shard_of(f"u{t}") == t % 2
        out = rt.adapt(epochs=1, batch_per_tenant=2, generator=_gen())
        assert out["groups"] == [["u0", "u2"], ["u1", "u3"]]
        assert [p.tenants() for p in rt.pool.shards] == [["u0", "u2"], ["u1", "u3"]]
        assert [len(e._present) for e in rt.engines] == [8, 8] and rt.engines[0].num_samples == 8

    def test_sharded_checkpoint_roundtrip_continue(self, tp, tmp_path):
        tokens, labels = _data(2, 4)
        prompts = _prompts(2, seed=9)

        def start():
            rt = _runtime(tp, shards=2)
            _session(rt, tokens, labels, prompts)
            return rt

        ref = start()
        path = CK.save_runtime_session(str(tmp_path), 1, start())
        new = _runtime(tp, shards=2)
        CK.restore_runtime_session(path, new)
        assert new.pool.slot_table() == ref.pool.slot_table() and new.pool.slot_table()["n_shards"] == 2
        out_ref, out_new = (r.adapt(epochs=1, batch_per_tenant=2) for r in (ref, new))
        for n in ("u0", "u1"):
            np.testing.assert_array_equal(out_ref["losses"][n], out_new["losses"][n])
        _same_tenants(ref, new, ["u0", "u1"])
        for s in range(2):
            assert all(torch.equal(v, new.pool.shard_pools(s)[k]) for k, v in ref.pool.shard_pools(s).items())
        assert torch.equal(ref.serve(["u0", "u1"], prompts, max_new=NEW), new.serve(["u0", "u1"], prompts, max_new=NEW))

    def test_restore_rejects_shard_count_mismatch(self, tp, tmp_path):
        """The logical shard count is a layout property: an elastic restart
        changes devices, never shards."""
        rt = _runtime(tp, shards=2)
        tokens, labels = _data(1, 4)
        rt.ingest("u0", tokens[0], labels[0])
        path = CK.save_runtime_session(str(tmp_path), 0, rt)
        with pytest.raises(ValueError, match="layout|shard"):
            CK.restore_runtime_session(path, _runtime(tp, shards=1))
        arrays, meta = rt.session_state()
        with pytest.raises(ValueError, match="shard"):
            _runtime(tp, shards=1).pool.load_state(arrays["pool"], meta["pool_table"])

    def test_session_full_per_shard(self, tp):
        rt = _runtime(tp, n_t=2, shards=2)
        tokens, labels = _data(3, 4)
        rt.ingest("u0", tokens[0], labels[0])
        rt.ingest("u1", tokens[1], labels[1])
        with pytest.raises(RuntimeError, match="session full"):
            rt.ingest("u2", tokens[2], labels[2])
        rt.release("u0")
        rt.ingest("u2", tokens[2], labels[2])   # shard 0's partition recycled
        assert rt.pool.shard_of("u2") == 0 and rt.tenant("u2").partition == 0


# ---------------------------------------------------------------------------
# The sharded pool
# ---------------------------------------------------------------------------


def _stacked(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape_a, shape_b = (n, CFG.n_layers, CFG.d_model, RANK), (n, CFG.n_layers, RANK, CFG.d_model)
    return {"A": torch.randn(shape_a, generator=g), "B": torch.randn(shape_b, generator=g)}


class TestShardedPool:
    def test_placement_balanced_and_sticky(self):
        pool = ShardedAdapterPool(3, CFG, RANK, n_shards=3, devices=[CPU])
        assert [pool.place(f"t{i}") for i in range(6)] == [0, 1, 2, 0, 1, 2]
        assert pool.place("t4") == 1   # sticky
        pool.unplace("t4")
        assert pool.place("fresh") == 1   # t4 gone: shard 1 has the fewest placed tenants
        with pytest.raises(KeyError, match="placement"):
            pool.shard_of("stranger")

    def test_route_and_register_many_mixed_shards(self):
        pool = ShardedAdapterPool(3, CFG, RANK, n_shards=2, devices=[CPU])
        stacked = _stacked(4)
        tenants = [f"t{i}" for i in range(4)]
        pool.register_many(tenants, stacked)
        for i, t in enumerate(tenants):
            s = pool.shard_of(t)
            assert s == i % 2
            slot = int(pool.lookup_local(s, [t])[0])
            assert torch.equal(pool.shard_pools(s)["A"][slot], stacked["A"][i])
        assert pool.route([None, "t3", "t0", "t2"]) == [([0, 2, 3], [None, "t0", "t2"]), ([1], ["t3"])]
        assert len(pool) == 4 and pool.version == 4 and pool.stats.registrations == 4
        table = pool.slot_table()
        assert table["n_shards"] == 2 and table["placement"] == [[t, i % 2] for i, t in enumerate(tenants)]
        assert set(pool.state_arrays()) == {"s0", "s1"}
        with pytest.raises(RuntimeError, match="multi-shard"):
            pool.pools()

    def test_single_shard_delegates_plain_pool_surface(self):
        pool = ShardedAdapterPool(3, CFG, RANK, n_shards=1, devices=[CPU])
        pool.register("t0", {k: v[0] for k, v in _stacked(1).items()})
        assert pool.has("t0") and len(pool) == 1 and pool.shard_of("t0") == 0
        assert int(pool.lookup(["t0"])[0]) == 1 and set(pool.pools()) == {"A", "B"}
        assert pool.slot_table() == pool.shards[0].slot_table()
        assert pool.state_arrays().keys() == pool.shards[0].state_arrays().keys()
        assert pool.stats is pool.shards[0].stats


# ---------------------------------------------------------------------------
# The supervisor over two shards
# ---------------------------------------------------------------------------


class TestSupervisor:
    def test_zero_replay_restart_reproduces_uninterrupted_run(self, tp, tmp_path):
        tokens, labels = _data(2, 4)
        prompts = _prompts(2)
        counts = [0] * 4
        armed = {"on": True}

        def events(counting):
            def ingest(t):
                def go(rt, i):
                    counts[i] += counting
                    return rt.ingest(f"u{t}", tokens[t], labels[t])
                return go

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

        ref = _runtime(tp, shards=2)
        for i, ev in enumerate(events(False)):
            ev(ref, i)
        rt, info = SessionSupervisor(str(tmp_path / "ck"), save_every=1).run(
            lambda: _runtime(tp, shards=2), events(True))
        assert info["restarts"] == 1 and info["resumed_at"] == 2 and counts == [1, 1, 2, 1]
        _same_tenants(rt, ref, ["u0", "u1"])
        assert rt.pool.slot_table() == ref.pool.slot_table()

    def test_supervisor_gives_up_past_max_restarts(self, tp, tmp_path):
        def always_fails(rt, i):
            raise RuntimeError("boom")

        with pytest.raises(RuntimeError, match="boom"):
            SessionSupervisor(str(tmp_path / "ck"), max_restarts=1).run(lambda: _runtime(tp, shards=2),
                                                                        [always_fails])


# ---------------------------------------------------------------------------
# Meshes, and the model axis's refusals
# ---------------------------------------------------------------------------


def test_make_mesh_validates():
    with pytest.raises(ValueError, match="axes"):
        SH.make_mesh((1, 1), ("data",), devices=["cpu"])
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        SH.make_mesh((2,), ("data",), devices=["cpu"])
    with pytest.raises(ValueError, match="listed twice"):
        SH.make_mesh((2,), ("data",), devices=[torch.device("cuda", 0)] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SH.make_mesh((1,), ("data",))
        with pytest.raises(RuntimeError, match="CUDA"):
            LM.make_production_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            elastic_session_mesh()
    mesh = SH.make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 3)
    assert mesh.shape == (2, 1) and mesh.axis_names == ("data", "model") and LM.mesh_chip_count(mesh) == 2
    assert SH.session_mesh_layout(mesh) == (2, 1, [[CPU], [CPU]]) and SH.session_devices(mesh) == [CPU, CPU]
    assert LM.mesh_batch_axes(mesh) == ("data",)
    assert LM.mesh_batch_axes(SH.make_mesh((1, 2, 1), ("pod", "data", "model"), devices=["cpu"] * 2)) == \
        ("pod", "data")
    assert elastic_session_mesh(["cpu"] * 3).shape == (3,) and elastic_remesh(1, ["cpu"] * 2).shape == (2, 1)


def test_model_axis_and_pipelines_name_slice_7b(tp):
    """The model axis runs since slice 7b (``test_torch_model_axis.py`` holds
    its values): a (2, 2) mesh's layout and session, and the reference's
    remaining refusals."""
    debug = LM.make_debug_mesh(2, 2, devices=["cpu"] * 4)
    assert SH.session_devices(debug) == [CPU, CPU] and SH.session_mesh_layout(debug)[:2] == (2, 2)
    rt = SessionRuntime(CFG, _sl(), tp, max_tenants=2, samples_per_tenant=4, seq=SEQ, mesh=debug, use_kernel=False)
    assert rt.model_parallel == 2 and rt.n_shards == 2 and rt._scope[1].mesh.axis_names == ("model",)
    with pytest.raises(ValueError, match="use_kernel=False"):
        SessionRuntime(CFG, _sl(), tp, max_tenants=2, samples_per_tenant=4, seq=SEQ, mesh=debug)
    with pytest.raises(ValueError, match="must equal the mesh's model-axis size"):
        _runtime(tp, pipeline_stages=2)
    assert elastic_remesh(2, ["cpu"] * 4).shape == (2, 2)
    with pytest.raises(RuntimeError, match="cannot keep model_parallel=2"):
        elastic_remesh(2, ["cpu"])
    with pytest.raises(ValueError, match="divide over 3 shards"):
        _runtime(tp, shards=3)


def test_replicate_backbone_shares_a_device_and_copies_to_others(tp):
    reps = SH.replicate_backbone(tp, [CPU, CPU])
    assert reps[0] is tp and reps[1] is tp
    rt = _runtime(tp, shards=2, devices=2)
    assert rt.params is tp and all(p is tp for p in rt._shard_params)
    meta = torch.device("meta")
    a, b = SH.replicate_backbone({"w": torch.ones(2)}, [CPU, meta])
    assert a["w"].device == CPU and b["w"].device == meta


# ---------------------------------------------------------------------------
# Several devices in one process (the CPU repeated)
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--tenants", "2", "--rounds", "1", "--samples-per-round", "4", "--seq", "8",
        "--gen", "4", "--rank", "4", "--adapt-epochs", "2"]


def test_run_cli_twin_parity_zero_tolerance(capsys):
    """``launch.run --devices 2 --check-parity``: the 2-device session equals
    its 1-device same-layout twin at zero tolerance."""
    metrics = run.main([*TINY, "--devices", "2", "--check-parity"])
    out = capsys.readouterr().out
    assert "parity OK" in out and "on 2 device(s)" in out and "/ 2 shard(s)" in out
    assert metrics["parity/diffs"] == 0.0 and metrics["session/devices"] == 2.0 and metrics["session/shards"] == 2.0
    assert metrics["runtime/serve/shard_dispatches"] == 2


def test_elastic_restore_different_device_count(tp, tmp_path):
    """A 2-shard session saved on 4 devices and restored onto 2 continues as
    the uninterrupted run, bitwise: the logical layout travels in the
    checkpoint, only the placement changes."""
    n_t, n_per = 4, 4
    tokens, labels = _data(n_t, n_per)
    prompts = _prompts(n_t)

    def first(rt):
        for t in range(n_t):
            rt.ingest(f"u{t}", tokens[t, :2], labels[t, :2])
        return rt.adapt(epochs=1, batch_per_tenant=2, generator=_gen())

    def second(rt):
        for t in range(n_t):
            rt.ingest(f"u{t}", tokens[t, 2:], labels[t, 2:])
        out = rt.adapt(epochs=2, batch_per_tenant=2)
        return out, rt.serve([f"u{t}" for t in range(n_t)], prompts, max_new=NEW)

    ref = _runtime(tp, n_t=n_t, n_per=n_per, shards=2, devices=4)
    first(ref)
    out_ref, toks_ref = second(ref)
    a = _runtime(tp, n_t=n_t, n_per=n_per, shards=2, devices=4)
    first(a)
    path = CK.save_runtime_session(str(tmp_path), 1, a)
    b = _runtime(tp, n_t=n_t, n_per=n_per, shards=2, devices=2)
    CK.restore_runtime_session(path, b)
    assert b.n_shards == 2 and len(b.devices) == 2
    out_b, toks_b = second(b)
    for t in range(n_t):
        np.testing.assert_array_equal(out_ref["losses"][f"u{t}"], out_b["losses"][f"u{t}"])
    _same_tenants(ref, b, [f"u{t}" for t in range(n_t)])
    assert torch.equal(toks_ref, toks_b) and ref.pool.slot_table() == b.pool.slot_table()


def test_supervised_elastic_failure_cli(tmp_path, capsys):
    """The CLI's crash drill restarts on fewer devices and ends as the
    uninterrupted 2-device run."""
    args = ["--device", "cpu", "--tenants", "2", "--rounds", "2", "--samples-per-round", "2", "--seq", "8",
            "--gen", "4", "--rank", "4", "--adapt-epochs", "1", "--devices", "2"]
    plain = run.main(args)["runtime"]
    sup = run.main([*args, "--checkpoint-dir", str(tmp_path / "ck"), "--inject-failure", "3",
                    "--elastic-devices", "1"])
    out = capsys.readouterr().out
    assert "1 restarts" in out and "on 1 device(s) at the end" in out
    rt = sup["runtime"]
    assert len(rt.devices) == 1 and rt.n_shards == 2
    _same_tenants(rt, plain, ["tenant-0", "tenant-1"])
    assert rt.pool.slot_table() == plain.pool.slot_table()


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _j_runtime(jp, n_t, n_per, **kw):
    return JRuntime(CFG, _sl(JSL), jp, max_tenants=n_t, samples_per_tenant=n_per, seq=SEQ, lr=LR,
                    use_kernel=True, placement_shards=2, **kw)


def _initial(n, mp):
    """The port's fresh tenants start from the reference's key-3 draw."""
    init = C.adapters_from_reference(jax.tree.map(np.asarray, JFF.init_fleet_adapters(
        jax.random.key(3), CFG, _sl(JSL), n)))
    mp.setattr(TFF, "init_fleet_adapters", lambda gen, cfg, sl, k: {a: v[:k].clone() for a, v in init.items()})


def _close(trt, jrt, names, scale):
    for n in names:
        for k in ("A", "B"):
            np.testing.assert_allclose(trt.tenant(n).adapters[k].numpy(), np.asarray(jrt.tenant(n).adapters[k]),
                                       atol=ADAPTER_ATOL * scale)
    for s in range(2):
        jpool = jrt.pool.shard_pools(s)
        for k, v in trt.pool.shard_pools(s).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jpool[k]), atol=ADAPTER_ATOL * scale)


def test_two_shard_session_matches_the_reference(jp, tp, monkeypatch):
    n_t, n_per = 4, 4
    tokens, labels = _data(n_t, n_per, seed=6)
    prompts = _prompts(n_t + 1, seed=7)
    who = [None] + [f"u{t}" for t in range(n_t)]
    jrt = _j_runtime(jp, n_t, n_per)
    trt = _runtime(tp, n_t=n_t, n_per=n_per, shards=2, use_kernel=True)
    _initial(n_t, monkeypatch)
    for t in range(n_t):
        jrt.ingest(f"u{t}", jnp.asarray(tokens[t].numpy()), jnp.asarray(labels[t].numpy()))
        trt.ingest(f"u{t}", tokens[t], labels[t])
    jout = jrt.adapt(epochs=2, batch_per_tenant=2, key=jax.random.key(3))
    tout = trt.adapt(epochs=2, batch_per_tenant=2)
    assert tout["groups"] == jout["groups"] == [["u0", "u2"], ["u1", "u3"]]
    for n in tout["losses"]:
        np.testing.assert_allclose(tout["losses"][n], np.asarray(jout["losses"][n]), rtol=LOSS_RTOL)
    scale = max(1.0, float(trt.engines[0].export_skipcache().slots["acts"].abs().max()))
    _close(trt, jrt, tout["losses"], scale)
    assert trt.pool.slot_table() == jrt.pool.slot_table()
    np.testing.assert_array_equal(trt.serve(who, prompts, max_new=NEW).numpy(),
                                  np.asarray(jrt.serve(who, jnp.asarray(prompts.numpy()), max_new=NEW)))
    assert trt.counters["serve/shard_dispatches"] == jrt.counters["serve/shard_dispatches"] == 2


def test_reference_two_shard_capture_continues_in_the_port(jp, tp, tmp_path, monkeypatch):
    """A reference 2-shard session saved with its own ``save_runtime_session``
    restores into a 2-shard port runtime through
    ``convert.session_from_reference``; both continue one adapt epoch and a
    serve within the bars, with equal meta and tokens."""
    n_t, n_per = 2, 8
    tokens, labels = _data(n_t, n_per, seed=4)
    prompts = _prompts(n_t + 1, seed=8)
    jrt = _j_runtime(jp, n_t, n_per)
    for t in range(n_t):
        jrt.ingest(f"u{t}", jnp.asarray(tokens[t, :4].numpy()), jnp.asarray(labels[t, :4].numpy()))
    jrt.adapt(epochs=1, batch_per_tenant=2, key=jax.random.key(3))
    jrt.ingest("u0", jnp.asarray(tokens[0, 4:].numpy()), jnp.asarray(labels[0, 4:].numpy()))
    path = JCK.save_runtime_session(str(tmp_path), 1, jrt)
    arrays, manifest = CK._load_dict_tree(path)
    jmeta = manifest["extra"]["session"]
    trt = _runtime(tp, n_t=n_t, n_per=n_per, shards=2, use_kernel=True)
    trt.load_session_state(*C.session_from_reference(arrays, jmeta, CFG))
    _, tmeta = trt.session_state()
    for k in ("tenants", "trained", "present", "pool_table"):
        assert tmeta[k] == jmeta[k], k
    jout = jrt.adapt(epochs=1, batch_per_tenant=2)
    tout = trt.adapt(epochs=1, batch_per_tenant=2)
    for n in ("u0", "u1"):
        np.testing.assert_allclose(tout["losses"][n], np.asarray(jout["losses"][n]), rtol=LOSS_RTOL)
    scale = max(1.0, float(arrays["cache"]["acts"].abs().max()))
    _close(trt, jrt, ["u0", "u1"], scale)
    who = [None, "u0", "u1"]
    np.testing.assert_array_equal(trt.serve(who, prompts, max_new=NEW).numpy(),
                                  np.asarray(jrt.serve(who, jnp.asarray(prompts.numpy()), max_new=NEW)))
