"""The port's serving path against the reference, end to end on the CPU.

Reduced stablelm-1.6b, gemma-7b and gemma2-9b (float32; gemma2-9b brings
local attention, which the 17 positions of a generation run past its
8-token window, sandwich norms and softcaps; gemma3-27b's parity runs in
the fine-tuning and fleet files, where it costs the tier-1 run less), params
from ``repro.models.lm.init_lm`` carried across by ``repro_torch.convert``.

Bars: logits within atol 1e-4 (float32, different GEMM summation orders);
temperature-0 tokens equal; final bf16 KV caches within one bf16 ulp at the
scale of each cached head vector (a cache entry differs by one ulp when the
two float32 values round apart, and decode steps read those caches, so later
entries carry that difference)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.core.adapter_pool import AdapterPool as JPool  # noqa: E402
from repro.core.runtime import generate as j_generate  # noqa: E402
from repro.core.runtime import generate_grouped as j_generate_grouped  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.core.runtime import generate, generate_grouped  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402

ARCHS = ["stablelm-1.6b", "gemma-7b", "gemma2-9b"]
RANK, NEW = 4, 8
LOGIT_ATOL = 1e-4


def assert_within_bf16_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    # ulp at the scale of each cached (position, head) vector: a value near
    # zero from cancellation carries the error of its vector's scale
    mag = np.maximum(np.abs(got), np.abs(want)).max(axis=-1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert not (np.abs(got - want) > ulp).any()


def assert_caches_close(port_caches, ref_caches, cfg):
    got = C.caches_to_reference(port_caches, cfg)
    want = jax.tree.map(lambda x: np.asarray(x, np.float32), ref_caches)
    flat_g, flat_w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w) and flat_g
    for g, w in zip(flat_g, flat_w):
        assert g.shape == w.shape
        assert_within_bf16_ulp(g, w)


class Setup:
    def __init__(self, arch):
        cfg = self.cfg = reduce_config(get_config(arch))
        self.jp = JL.init_lm(jax.random.key(0), cfg)
        self.tp = C.params_from_reference(jax.tree.map(np.asarray, self.jp), cfg)
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, cfg.vocab_size, (4, 9)).astype(np.int32)
        self.adapters = []
        for _ in range(2):
            self.adapters.append({
                "A": (rng.normal(size=(cfg.n_layers, cfg.d_model, RANK)) / np.sqrt(cfg.d_model)).astype(np.float32),
                "B": (rng.normal(size=(cfg.n_layers, RANK, cfg.d_model)) * 0.1).astype(np.float32),
            })
        self.who = ["u1", None, "u0", "u1"]
        self.pools = {}
        for compress in (None, "int8"):
            pool = JPool(3, cfg, RANK, compress=compress)
            for i, ad in enumerate(self.adapters):
                pool.register(f"u{i}", ad)
            jpools = pool.pools()
            self.idx = np.array(pool.lookup(self.who))
            self.pools[compress] = (jpools, C.pools_from_reference(jax.tree.map(np.asarray, jpools)))

    def stacks(self, i):
        ad = self.adapters[i]
        return (
            JSL.adapters_to_stack(jax.tree.map(jnp.asarray, ad), self.cfg),
            TSL.adapters_to_stack(C.adapters_from_reference(ad)),
        )


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return Setup(request.param)


@pytest.mark.parametrize("with_adapters", [False, True])
def test_serve_prefill_logits(setup, with_adapters):
    s = setup
    js, ts = s.stacks(0) if with_adapters else (None, None)
    b, n = s.tokens.shape
    want, _ = JL.serve_prefill(s.jp, s.cfg, jnp.asarray(s.tokens), JL.init_serve_caches(s.cfg, b, n), adapters=js)
    got, _ = TL.serve_prefill(s.tp, s.cfg, torch.as_tensor(s.tokens), TL.init_serve_caches(s.cfg, b, n, device="cpu"),
                              adapters=ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


@pytest.mark.parametrize("compress", [None, "int8"])
def test_serve_prefill_grouped_logits(setup, compress):
    s = setup
    jpools, tpools = s.pools[compress]
    b, n = s.tokens.shape
    want, jc = JL.serve_prefill_grouped(s.jp, s.cfg, jnp.asarray(s.tokens), JL.init_serve_caches(s.cfg, b, n),
                                        jpools, jnp.asarray(s.idx), use_kernel=False)
    got, tc = TL.serve_prefill_grouped(s.tp, s.cfg, torch.as_tensor(s.tokens),
                                       TL.init_serve_caches(s.cfg, b, n, device="cpu"), tpools, torch.as_tensor(s.idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    assert_caches_close(tc, jc, s.cfg)


def test_serve_prefill_grouped_against_reference_kernel_in_interpret_mode():
    s = Setup("stablelm-1.6b")
    jpools, tpools = s.pools[None]
    b, n = s.tokens.shape
    want, _ = JL.serve_prefill_grouped(s.jp, s.cfg, jnp.asarray(s.tokens), JL.init_serve_caches(s.cfg, b, n),
                                       jpools, jnp.asarray(s.idx), use_kernel=True)
    got, _ = TL.serve_prefill_grouped(s.tp, s.cfg, torch.as_tensor(s.tokens),
                                      TL.init_serve_caches(s.cfg, b, n, device="cpu"), tpools, torch.as_tensor(s.idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


@pytest.mark.parametrize("compress", [None, "int8"])
def test_generate_grouped_tokens_and_final_caches(setup, compress):
    s = setup
    jpools, tpools = s.pools[compress]
    want = j_generate_grouped(s.jp, s.cfg, jnp.asarray(s.tokens), jpools, jnp.asarray(s.idx), max_new=NEW,
                              use_kernel=False)
    got = generate_grouped(s.tp, s.cfg, s.tokens, tpools, torch.as_tensor(s.idx), max_new=NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # The same two stages by hand, to compare the caches decode leaves.
    b, n = s.tokens.shape
    jl, jc = JL.serve_prefill_grouped(s.jp, s.cfg, jnp.asarray(s.tokens), JL.init_serve_caches(s.cfg, b, n + NEW),
                                      jpools, jnp.asarray(s.idx), use_kernel=False)
    tok0, key = JL.sample_token(jl, jax.random.key(0), 0.0)
    jt, jc = JL.decode_scan(s.jp, s.cfg, tok0, jnp.asarray(n, jnp.int32), jc, key, max_new=NEW,
                            pools=jpools, idx=jnp.asarray(s.idx), use_kernel=False)
    tl, tc = TL.serve_prefill_grouped(s.tp, s.cfg, torch.as_tensor(s.tokens),
                                      TL.init_serve_caches(s.cfg, b, n + NEW, device="cpu"), tpools,
                                      torch.as_tensor(s.idx))
    tt, tc = TL.decode_scan(s.tp, s.cfg, TL.sample_token(tl, 0.0), n, tc, max_new=NEW,
                            pools=tpools, idx=torch.as_tensor(s.idx))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tt.numpy(), got.numpy())
    assert_caches_close(tc, jc, s.cfg)


def test_generate_with_adapters_tokens_and_final_caches(setup):
    s = setup
    js, ts = s.stacks(1)
    want = j_generate(s.jp, s.cfg, jnp.asarray(s.tokens), max_new=NEW, adapters_stack=js)
    got = generate(s.tp, s.cfg, s.tokens, max_new=NEW, adapters_stack=ts, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    b, n = s.tokens.shape
    jl, jc = JL.serve_prefill(s.jp, s.cfg, jnp.asarray(s.tokens), JL.init_serve_caches(s.cfg, b, n + NEW),
                              adapters=js)
    tok0, key = JL.sample_token(jl, jax.random.key(0), 0.0)
    _, jc = JL.decode_scan(s.jp, s.cfg, tok0, jnp.asarray(n, jnp.int32), jc, key, max_new=NEW, adapters=js)
    tl, tc = TL.serve_prefill(s.tp, s.cfg, torch.as_tensor(s.tokens),
                              TL.init_serve_caches(s.cfg, b, n + NEW, device="cpu"), adapters=ts)
    _, tc = TL.decode_scan(s.tp, s.cfg, TL.sample_token(tl, 0.0), n, tc, max_new=NEW, adapters=ts)
    assert_caches_close(tc, jc, s.cfg)


def test_zero_slot_row_equals_base_generate(setup):
    s = setup
    _, tpools = s.pools[None]
    grouped = generate_grouped(s.tp, s.cfg, s.tokens, tpools, torch.as_tensor(s.idx), max_new=NEW, device="cpu")
    base = generate(s.tp, s.cfg, s.tokens, max_new=NEW, device="cpu")
    row = s.who.index(None)
    np.testing.assert_array_equal(grouped[row].numpy(), base[row].numpy())
    assert not torch.equal(grouped, base)


def test_entry_points_default_to_cuda():
    """Params on the CPU and no ``device``: the call refuses instead of
    quietly running on the CPU."""
    s = Setup("stablelm-1.6b")
    with pytest.raises(ValueError, match="cuda"):
        generate(s.tp, s.cfg, s.tokens, max_new=2)
    _, tpools = s.pools[None]
    with pytest.raises(ValueError, match="cuda"):
        generate_grouped(s.tp, s.cfg, s.tokens, tpools, torch.as_tensor(s.idx), max_new=2)


@pytest.mark.parametrize("extra", [[], ["--pool-compress", "int8"]])
def test_serve_cli_tenants(capsys, extra):
    cli.main(["--tenants", "2", "--device", "cpu", "--batch", "3", "--prompt-len", "6", "--gen", "3", *extra])
    out = capsys.readouterr().out
    assert "generated (3, 3)" in out and "grouped x2 tenants" in out


def test_serve_cli_flags(capsys):
    """``--loop`` serves single-stack through the per-token loop and is a
    usage error with ``--tenants`` or ``--scheduler``, as in the reference;
    ``--unroll 3`` gives ``--unroll 1``'s tokens."""
    small = ["--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen", "5"]
    outs = {}
    for flags in ([], ["--loop"], ["--unroll", "3"]):
        cli.main([*small, *flags])
        outs[" ".join(flags)] = capsys.readouterr().out.splitlines()
    assert all(lines[0].startswith("generated (2, 5)") for lines in outs.values())
    assert "5 eager decode steps (per-token loop)" in outs["--loop"][0]
    assert outs["--loop"][1] == outs[""][1] == outs["--unroll 3"][1]
    for flags in (["--loop", "--tenants", "2"], ["--loop", "--scheduler"]):
        with pytest.raises(SystemExit):
            cli.main([*small, *flags])
        assert "--loop" in capsys.readouterr().err
    # a recurrent config builds as the reference's does: same leaves, shapes and dtypes
    cfg = reduce_config(get_config("xlstm-350m"))
    got = TL.init_lm(torch.Generator().manual_seed(0), cfg)
    want = C.params_from_reference(jax.tree.map(np.asarray, JL.init_lm(jax.random.key(0), cfg)), cfg)
    meta = lambda tree: [(tuple(t.shape), t.dtype) for t in jax.tree.leaves(tree)]  # noqa: E731
    assert jax.tree.structure(C._map(lambda t: 0, got)) == jax.tree.structure(C._map(lambda t: 0, want))
    assert meta(got) == meta(want)


def test_configs_are_copies_of_the_reference():
    import dataclasses

    from repro.configs import list_archs
    from repro_torch import configs as TC

    assert TC.list_archs() == list_archs()
    for arch in list_archs():
        want, got = get_config(arch), TC.get_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert dataclasses.asdict(TC.reduce_config(got)) == dataclasses.asdict(reduce_config(want)), arch


def test_adapter_layouts_round_trip():
    rng = np.random.default_rng(5)
    flat = {"A": rng.normal(size=(3, 8, 2)).astype(np.float32), "B": rng.normal(size=(3, 2, 8)).astype(np.float32)}
    stack = TSL.adapters_to_stack(C.adapters_from_reference(flat))
    assert len(stack) == 3 and tuple(stack[1]["A"].shape) == (8, 2)
    back = TSL.stack_to_adapters(stack)
    for k in ("A", "B"):
        np.testing.assert_array_equal(back[k].numpy(), flat[k])


def test_sample_token_greedy_and_temperature():
    logits = np.random.default_rng(6).normal(size=(3, 1, 50)).astype(np.float32)
    want, _ = JL.sample_token(jnp.asarray(logits), jax.random.key(0), 0.0)
    got = TL.sample_token(torch.as_tensor(logits), 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    draws = [TL.sample_token(torch.as_tensor(logits), 0.7, torch.Generator().manual_seed(4)) for _ in range(2)]
    assert tuple(draws[0].shape) == (3, 1) and torch.equal(draws[0], draws[1])
    assert bool(((draws[0] >= 0) & (draws[0] < 50)).all())
