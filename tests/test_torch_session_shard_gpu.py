"""The session's data axis on the card: logical shards over CUDA devices.

Every test here needs a CUDA device and the CUDA toolkit's ``nvcc`` (the
grouped kernels run on each shard's device); without one they skip, and the
tests over two cards skip below two. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_session_shard_gpu.py

Reduced stablelm-1.6b with seeded weights, float32, rank 4, the kernels on.
Bars: a 2-shard session on one card equals its 1-shard twin bitwise
(adapters, losses, moments, temperature-0 tokens), and so does its
scheduler with a KV pool per shard (no leaks on either); over two cards,
``launch.run --devices 2 --check-parity`` holds the 2-card session to its
1-card twin at zero tolerance, and a 2-shard session saved on two cards
continues bitwise on one."""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpoint as CK  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import lm_skiplora as SL  # noqa: E402
from repro_torch.core.runtime import SessionRuntime  # noqa: E402
from repro_torch.models.lm import init_lm  # noqa: E402
from repro_torch.runtime.sharding import make_mesh  # noqa: E402

pytestmark = pytest.mark.gpu

CFG = reduce_config(get_config("stablelm-1.6b"))
N_T, N_PER, SEQ, NEW = 4, 4, 16, 4


@pytest.fixture(scope="module")
def params():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return init_lm(torch.Generator(device="cuda").manual_seed(0), CFG)


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


def _runtime(params, shards, devices=("cuda:0",)):
    sl = SL.SkipLoRAConfig(rank=4, mode="full", cache_dtype="float32", use_fused_kernel=True)
    mesh = make_mesh((len(devices),), ("data",), devices=list(devices))
    return SessionRuntime(CFG, sl, params, max_tenants=N_T, samples_per_tenant=N_PER, seq=SEQ, lr=1e-2,
                          use_kernel=True, mesh=mesh, placement_shards=shards)


def _data(seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, CFG.vocab_size, (N_T, N_PER, SEQ), generator=g),
            torch.randint(0, CFG.vocab_size, (N_T, N_PER, SEQ), generator=g),
            torch.randint(0, CFG.vocab_size, (N_T + 1, 8), generator=g))


def _session(rt, tokens, labels, prompts, halves=(0, 1)):
    outs = []
    for h in halves:
        for t in range(N_T):
            rt.ingest(f"u{t}", tokens[t, 2 * h:2 * h + 2], labels[t, 2 * h:2 * h + 2])
        outs.append(rt.adapt(epochs=2, batch_per_tenant=2, generator=torch.Generator().manual_seed(3)))
    who = [None] + [f"u{t}" for t in range(N_T)]
    return outs, rt.serve(who, prompts, max_new=NEW).cpu()


def _same(a, b):
    for t in range(N_T):
        for name in ("adapters", "opt_mu", "opt_nu"):
            for k in ("A", "B"):
                assert torch.equal(getattr(a.tenant(f"u{t}"), name)[k].cpu(),
                                   getattr(b.tenant(f"u{t}"), name)[k].cpu()), (t, name, k)


def test_two_shards_on_one_card_equal_one_shard(params):
    tokens, labels, prompts = _data()
    rt1, rt2 = _runtime(params, 1), _runtime(params, 2)
    out1, toks1 = _session(rt1, tokens, labels, prompts)
    out2, toks2 = _session(rt2, tokens, labels, prompts)
    assert out2[0]["groups"] == [["u0", "u2"], ["u1", "u3"]]
    _same(rt1, rt2)
    for o1, o2 in zip(out1, out2):
        for t in o1["losses"]:
            np.testing.assert_array_equal(o1["losses"][t], o2["losses"][t])
    assert torch.equal(toks1, toks2) and rt2.counters["serve/shard_dispatches"] == 2


def test_two_shard_scheduler_keeps_a_kv_pool_per_shard(params):
    tokens, labels, _ = _data()
    rng = np.random.default_rng(4)
    shared = rng.integers(0, CFG.vocab_size, 12).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, CFG.vocab_size, 4).astype(np.int32)]) for _ in range(6)]
    who = ["u0", "u1", "u1", None, "u0", "u1"]
    toks = []
    for shards in (1, 2):
        rt = _runtime(params, shards)
        for t in range(N_T):
            rt.ingest(f"u{t}", tokens[t, :2], labels[t, :2])
        rt.adapt(epochs=1, batch_per_tenant=2, generator=torch.Generator().manual_seed(3))
        sched = rt.attach_scheduler(max_batch=4, max_prompt=16, max_new_cap=3, admit_bucket=2,
                                    inflight_per_tenant=4, chunk=2, kv_block=4)
        reqs = [rt.enqueue_serve(t, p, max_new=3) for t, p in zip(who, prompts)]
        rt.drain()
        rt.check_prefix_no_leaks()
        assert sorted(sched.prefix_metrics()["pools"]) == [str(s) for s in range(shards)]
        toks.append([r.result() for r in reqs])
    for a, b in zip(*toks):
        np.testing.assert_array_equal(a, b)


def test_two_cards_check_parity():
    _two_cards()
    from repro_torch.launch import run

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        metrics = run.main(["--device", "cuda", "--use-kernel", "--devices", "2", "--check-parity", "--tenants", "2",
                            "--rounds", "1", "--samples-per-round", "4", "--seq", "8", "--gen", "4",
                            "--adapt-epochs", "2"])
    assert "parity OK" in log.getvalue() and metrics["parity/diffs"] == 0.0


def test_two_card_session_restores_onto_one(params, tmp_path):
    _two_cards()
    tokens, labels, prompts = _data(seed=2)
    ref = _runtime(params, 2, ("cuda:0", "cuda:1"))
    out_ref, toks_ref = _session(ref, tokens, labels, prompts)
    a = _runtime(params, 2, ("cuda:0", "cuda:1"))
    _session(a, tokens, labels, prompts, halves=(0,))
    assert {st.adapters["A"].device.index for st in a._tenants.values()} == {0, 1}
    path = CK.save_runtime_session(str(tmp_path), 1, a)
    b = _runtime(params, 2)
    CK.restore_runtime_session(path, b)
    out_b, toks_b = _session(b, tokens, labels, prompts, halves=(1,))
    _same(ref, b)
    for t in out_ref[1]["losses"]:
        np.testing.assert_array_equal(out_ref[1]["losses"][t], out_b[0]["losses"][t])
    assert torch.equal(toks_ref, toks_b)
