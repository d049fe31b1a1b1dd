"""One-dispatch decode of the port (``core.decode_graph``, ``lm.decode_scan``,
``lm.decode_step_``) on the CPU, where the steps that the card captures
into CUDA graphs run eagerly.

Reduced float32 configs, params from the reference's ``init_lm`` carried
across by ``repro_torch.convert``, inputs made with numpy from seeds.

Bars: the 0-d device-tensor position step gives the int step's bits
(logits and bf16 caches); ``decode_scan`` (the step a graph captures) gives
``decode_loop``'s (the eager per-step loop) tokens and caches bitwise,
greedy and sampled; temperature-0 tokens equal the reference's
(``generate_loop``, the fused decode of ``tests/test_kernel_speed.py``, the
scheduler with a fused skip term); a ``use_kernel=False`` serve and
scheduler launch no grouped kernel even where the wrappers take the kernel
route; the launch bookkeeping of a capture and its replays; the graph
cache's LRU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.core.runtime import SessionRuntime as JRuntime  # noqa: E402
from repro.core.runtime import generate_grouped as j_generate_grouped  # noqa: E402
from repro.core.runtime import generate_loop as j_generate_loop  # noqa: E402
from repro.core.scheduler import RequestScheduler as JScheduler  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import decode_graph as DG  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.core import prefill_graph as PG  # noqa: E402
from repro_torch.core.runtime import SessionRuntime, generate, generate_grouped, generate_loop  # noqa: E402
from repro_torch.core.scheduler import RequestScheduler  # noqa: E402
from repro_torch.kernels.skip_lora import kernel as K  # noqa: E402
from repro_torch.kernels.skip_lora import ops  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402

RANK = 4
CFG = reduce_config(get_config("stablelm-1.6b"))


def _adapters(seed, cfg=CFG):
    rng = np.random.default_rng(seed)
    l, d = cfg.n_layers, cfg.d_model
    return {"A": (rng.normal(size=(l, d, RANK)) / np.sqrt(d)).astype(np.float32),
            "B": (rng.normal(size=(l, RANK, d)) * 0.1).astype(np.float32)}


class Setup:
    def __init__(self, cfg):
        self.cfg = cfg
        self.jp = JL.init_lm(jax.random.key(0), cfg)
        self.tp = C.params_from_reference(jax.tree.map(np.asarray, self.jp), cfg)
        self.tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)

    def runtimes(self, *, fuse=False, use_kernel=True):
        """(reference runtime, port runtime) holding adapters u0, u1."""
        jrt = JRuntime(self.cfg, JSL.SkipLoRAConfig(rank=RANK), self.jp, max_tenants=2, samples_per_tenant=1,
                       seq=8, use_kernel=False, decode_fuse=fuse)
        trt = SessionRuntime(self.cfg, TSL.SkipLoRAConfig(rank=RANK), self.tp, max_tenants=2,
                             samples_per_tenant=1, seq=8, use_kernel=use_kernel, decode_fuse=fuse, device="cpu")
        for i in range(2):
            jrt.pool.register(f"u{i}", _adapters(10 + i, self.cfg))
            trt.pool.register(f"u{i}", _adapters(10 + i, self.cfg))
        return jrt, trt


@pytest.fixture(scope="module")
def setup():
    return Setup(CFG)


def _prefilled(s, pools=None, idx=None, adapters=None):
    """(tok0, caches) after a prefill of ``s.tokens``, room for 5 steps."""
    b, n = s.tokens.shape
    caches = TL.init_serve_caches(s.cfg, b, n + 5, device="cpu")
    tokens = torch.as_tensor(s.tokens)
    if pools is not None:
        logits, caches = TL.serve_prefill_grouped(s.tp, s.cfg, tokens, caches, pools, idx)
    else:
        logits, caches = TL.serve_prefill(s.tp, s.cfg, tokens, caches, adapters=adapters)
    return TL.sample_token(logits, 0.0), caches


def _clone(caches):
    return [{n: t.clone() for n, t in c.items()} for c in caches]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma2-9b"])
def test_device_position_step_equals_the_int_step(arch):
    """``attn_decode``'s whole-batch branch at a 0-d tensor position: the
    int branch's logits and caches, bitwise, at every step (gemma2-9b's
    local layers bring the window into the mask)."""
    s = Setup(reduce_config(get_config(arch)))
    tok, caches = _prefilled(s)
    other = _clone(caches)
    n = s.tokens.shape[1]
    for i in range(5):
        want, caches = TL.serve_decode(s.tp, s.cfg, tok, n + i, caches)
        got, other = TL.serve_decode(s.tp, s.cfg, tok, torch.tensor(n + i), other)
        assert torch.equal(got, want)
        assert all(torch.equal(a[k], b[k]) for a, b in zip(caches, other) for k in a)
        tok = TL.sample_token(want, 0.0)


@pytest.mark.parametrize("temperature", [0.0, 0.7, "rows"])
@pytest.mark.parametrize("grouped", [False, True], ids=["single", "grouped"])
def test_decode_scan_equals_decode_loop_bitwise(setup, grouped, temperature):
    """The in-place step that the card captures (``decode_scan``) against
    the eager per-step loop (``decode_loop``): tokens, caches and the
    generator's state bitwise, greedy, at one temperature and per row."""
    s = setup
    _, trt = s.runtimes()
    kw = {}
    if grouped:
        kw = dict(pools=trt.pool.pools(), idx=trt.pool.lookup(["u1", None, "u0"]))
    else:
        kw = dict(adapters=TSL.adapters_to_stack(C.adapters_from_reference(_adapters(12))))
    if temperature == "rows":
        temperature = torch.tensor([0.0, 0.9, 1.3])
    tok0, caches = _prefilled(s, kw.get("pools"), kw.get("idx"), kw.get("adapters"))
    other = _clone(caches)
    n = s.tokens.shape[1]
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    got, got_c = TL.decode_scan(s.tp, s.cfg, tok0, n, caches, max_new=5, temperature=temperature,
                                generator=g1, unroll=3, **kw)
    want, want_c = TL.decode_loop(s.tp, s.cfg, tok0, n, other, max_new=5, temperature=temperature,
                                  generator=g2, **kw)
    assert torch.equal(got, want) and got.shape == (3, 5)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(got_c, want_c) for k in a)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_generate_loop_equals_the_reference_and_unroll_keeps_the_tokens(setup):
    """The port's ``generate_loop`` against the reference's, greedy, without
    and with single-stack adapters; ``generate(unroll=3)`` gives
    ``unroll=1``'s tokens."""
    s = setup
    ad = _adapters(12)
    for js, ts in ((None, None), (JSL.adapters_to_stack(jax.tree.map(jnp.asarray, ad), s.cfg),
                                   TSL.adapters_to_stack(C.adapters_from_reference(ad)))):
        want = np.asarray(j_generate_loop(s.jp, s.cfg, jnp.asarray(s.tokens), max_new=5, adapters_stack=js))
        got = generate_loop(s.tp, s.cfg, s.tokens, max_new=5, adapters_stack=ts, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        for unroll in (1, 3):
            scan = generate(s.tp, s.cfg, s.tokens, max_new=5, adapters_stack=ts, unroll=unroll, device="cpu")
            assert torch.equal(scan, got)
    assert len(PG.GRAPHS) == 0 and not PG.GRAPHS.stats     # the CPU's prefills are eager: nothing captured


@pytest.mark.parametrize("via", ["generate", "runtime"])
def test_fused_decode_temp0_token_parity(setup, via):
    """The mirror of the reference's ``test_fused_decode_temp0_token_parity``:
    the decode skip term as dense per-row math (``fuse_skip`` /
    ``decode_fuse``) gives the split path's temperature-0 tokens, and both
    equal the reference's."""
    s = setup
    who = [None, "u0", "u1"]
    jrt, trt = s.runtimes()
    jfused, tfused = s.runtimes(fuse=True)
    if via == "generate":
        jidx, tidx = jrt.pool.lookup(who), trt.pool.lookup(who)
        want = np.asarray(j_generate_grouped(s.jp, s.cfg, jnp.asarray(s.tokens), jrt.pool.pools(), jidx,
                                             max_new=5, use_kernel=False, fuse_skip=True))
        split = generate_grouped(s.tp, s.cfg, s.tokens, trt.pool.pools(), tidx, max_new=5, device="cpu")
        fused = generate_grouped(s.tp, s.cfg, s.tokens, trt.pool.pools(), tidx, max_new=5, fuse_skip=True,
                                 device="cpu")
    else:
        want = np.asarray(jfused.serve(who, jnp.asarray(s.tokens), max_new=5))
        split = trt.serve(who, s.tokens, max_new=5)
        fused = tfused.serve(who, s.tokens, max_new=5)
    assert torch.equal(split, fused)
    np.testing.assert_array_equal(fused.numpy(), want)
    assert len(PG.GRAPHS) == 0 and not PG.GRAPHS.stats


def test_scheduler_chunk_scan_with_a_fused_skip_term(setup):
    """The scheduler's chunks under ``decode_fuse=True``: the reference's
    temperature-0 tokens and counters on its mid-decode trace, and the split
    chunks' tokens."""
    s = setup
    prompts = np.random.default_rng(5).integers(0, s.cfg.vocab_size, (3, 6)).astype(np.int32)
    who = ["u0", "u1", "u0"]
    kw = dict(max_batch=3, max_prompt=6, max_new_cap=4, admit_bucket=1, inflight_per_tenant=3, chunk=2)
    out = {}
    for name, (jrt, trt) in (("split", s.runtimes()), ("fused", s.runtimes(fuse=True))):
        for pkg, cls, rt in (("ref", JScheduler, jrt), ("port", RequestScheduler, trt)):
            sched = cls(rt, **kw)
            reqs = [sched.submit(t, p, max_new=4) for t, p in zip(who, prompts)]
            sched.drain()
            out[name, pkg] = ([np.asarray(r.result()).tolist() for r in reqs], dict(sched.counters))
        if name == "fused":
            assert sched._how == (True, True, False)
    assert out["fused", "port"] == out["fused", "ref"]
    assert out["fused", "port"][0] == out["split", "port"][0]


@pytest.fixture
def kernel_route(monkeypatch):
    """The grouped wrappers take the kernel route on CPU tensors, with
    ``K.LIB.launch`` replaced by a recorder that counts as the real one does
    (``tests/test_torch_skip_tc_plan.py``) and computes nothing."""
    calls = []

    def launch(name, x, *args):
        calls.append(name)
        K.LIB.launches[name] += 1

    monkeypatch.setattr(K.LIB, "launch", launch)
    monkeypatch.setattr(ops, "_device_kind", lambda x: "cuda")
    K.reset_launches()
    return calls


@pytest.mark.parametrize("scheduler", [False, True], ids=["serve", "scheduler"])
def test_use_kernel_false_serving_launches_no_grouped_kernel(setup, kernel_route, scheduler):
    """``SessionRuntime(use_kernel=False)`` serves through the plain versions
    on any device, as the reference routes its serve and its scheduler: no
    grouped launch where the wrappers would launch one, and the plain
    versions' tokens. With ``use_kernel=True`` the same serve launches one
    grouped forward for each prefill and one a decode step."""
    s = setup
    who = [None, "u0", "u1"]

    def serve(use_kernel):
        _, trt = s.runtimes(use_kernel=use_kernel)
        K.reset_launches()
        if not scheduler:
            return trt.serve(who, s.tokens, max_new=4).numpy(), 1 + 4
        sched = trt.attach_scheduler(max_batch=3, max_prompt=6, max_new_cap=4, admit_bucket=2, chunk=2)
        reqs = [trt.enqueue_serve(t, p, max_new=4) for t, p in zip(who, s.tokens)]
        trt.drain()
        c = sched.counters
        return np.stack([r.result() for r in reqs]), 3 * c["dispatch/admit"] + 2 * c["dispatch/step"]

    plain, _ = serve(False)
    assert K.LAUNCHES["grouped_skip_sum_fwd"] == 0 and not kernel_route
    _, want = serve(True)
    assert K.LAUNCHES["grouped_skip_sum_fwd"] == len(kernel_route) == want and sum(K.LAUNCHES.values()) == want
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_device_kind", lambda x: "cpu")
        np.testing.assert_array_equal(plain, serve(True)[0])


def test_launch_tape_adds_captured_launches_at_every_replay(monkeypatch):
    """What a capture counted is taken back (a capture executes nothing) and
    each replay adds it again, by kernel and by row class."""
    K.reset_launches()
    K.LIB.launches["grouped_skip_sum_fwd"] = 1          # an eager launch before the capture
    K._count_rows("grouped_skip_sum_fwd", "few_rows")
    tape = DG.LaunchTape()
    with tape.recording():
        for _ in range(3):                                # three captured steps
            K.LIB.launches["grouped_skip_sum_fwd"] += 1
            K._count_rows("grouped_skip_sum_fwd", "few_rows")
        K.LIB.launches["grouped_skip_sum_fwd_q4"] += 1
        K._count_rows("grouped_skip_sum_fwd_q4", "many_rows")
    assert K.LAUNCHES["grouped_skip_sum_fwd"] == 1 and K.LAUNCHES["grouped_skip_sum_fwd_q4"] == 0
    assert K.ROW_LAUNCHES == {("grouped_skip_sum_fwd", "few_rows"): 1}
    tape.replayed()
    tape.replayed(2)
    assert K.LAUNCHES["grouped_skip_sum_fwd"] == 1 + 9 and K.LAUNCHES["grouped_skip_sum_fwd_q4"] == 3
    assert K.ROW_LAUNCHES == {("grouped_skip_sum_fwd", "few_rows"): 10,
                              ("grouped_skip_sum_fwd_q4", "many_rows"): 3}
    assert sum(K.LAUNCHES.values()) == 13
    K.reset_launches()


@pytest.mark.parametrize("steps,unroll,want", [
    (32, 1, [1] * 32), (32, 3, [3] * 10 + [2]), (32, 32, [32]), (31, 32, [31]), (5, 2, [2, 2, 1]), (0, 3, []),
])
def test_segments_cover_every_step(steps, unroll, want):
    assert DG.segments(steps, unroll) == want
    assert sum(want) == steps and len(want) == -(-steps // unroll)


def test_graph_cache_evicts_least_recently_used_and_frees():
    class Entry:
        freed = 0

        def free(self):
            self.freed += 1

    cache = DG.GraphCache(capacity=2)
    a, b, c = Entry(), Entry(), Entry()
    assert cache.entry("a", lambda: a) is a and cache.entry("b", lambda: b) is b
    assert cache.entry("a", lambda: Entry()) is a                    # hit: "b" is now least recent
    assert cache.entry("c", lambda: c) is c and b.freed == 1 and not a.freed
    assert len(cache) == 2 and dict(cache.stats) == {"misses": 3, "hits": 1, "evictions": 1}
    cache.clear()
    assert len(cache) == 0 and a.freed == c.freed == 1
    with pytest.raises(ValueError):
        DG.GraphCache(capacity=0)


def test_plan_is_checked_against_the_launch(kernel_route):
    """A plan handed to a grouped wrapper must be one of its rows."""
    x = torch.zeros((2, 1, 3, 8))
    a, b = torch.zeros((4, 2, 8, 2)), torch.zeros((4, 2, 2, 8))
    idx = torch.tensor([1, 0, 3], dtype=torch.int32)
    ops.skip_lora_grouped(x, a, b, idx, plan=ops.grouped_plan(idx, 4))
    assert kernel_route == ["grouped_skip_sum_fwd"]
    with pytest.raises(ValueError, match="plan"):
        ops.skip_lora_grouped(x, a, b, idx, plan=ops.grouped_plan(idx[:2], 4))
