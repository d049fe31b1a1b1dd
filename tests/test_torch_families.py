"""The other model families against the reference on the CPU: the MoE FFN,
the mamba / mLSTM / sLSTM cells, the frontend prefix, and the six configs
that need them (qwen2-moe-a2.7b, phi3.5-moe, jamba-1.5-large, xlstm-350m,
paligemma-3b, musicgen-medium), reduced and in float32.

A config's params are the port's ``init_lm`` draw moved into the
reference's periods / remainder layout (``to_reference``; the reference's
eager init takes seconds a config), cells' and blocks' come from the
reference's ``init_*``; both through ``repro_torch.convert``, with the norm
scales drawn around 1 (``live_norms``: the reference's zero RMSNorm scales
would zero every block's input). Inputs are numpy from a seed, fed to both
packages. One intra-op thread.

Bars (float32): ``route`` and ``moe_ffn`` outputs and aux within 1e-5, with
tokens dropped at capacity in one case and a decode group (S = 1, C = K) in
another; the routing has no near-tie at its top-k boundary (checked, so
``torch.topk`` and ``lax.top_k`` pick the same experts in the same order);
the three cells' sequence and step forms and final states within 1e-5, and
step-by-step decode equal to the sequence form within 1e-5; every block kind
in every mode (hidden, cache, aux) within 1e-5; per config, the logits
within 1e-4, temperature-0 tokens equal (grouped serving, and for the two
frontend configs a prefilled prefix), the train loss with its aux within
rtol 1e-5, the Skip2-LoRA populate and cached losses within rtol 1e-5
(``test_torch_finetune.py``'s bar), and the reference's own arch-smoke bars
(``tests/test_arch_smoke.py``) on the port: a train step lowers the loss,
and a decode step matches teacher forcing within 3e-3 (MoE configs at a
capacity where no token drops; float32 serve caches)."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.core.adapter_pool import AdapterPool as JPool  # noqa: E402
from repro.core.runtime import SessionRuntime as JRuntime  # noqa: E402
from repro.core.runtime import generate_grouped as j_generate_grouped  # noqa: E402
from repro.core.scheduler import RequestScheduler as JScheduler  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import frontend as JF  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.core.runtime import SessionRuntime, generate_grouped  # noqa: E402
from repro_torch.core.scheduler import RequestScheduler  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import frontend as TF  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.optim import make_optimizer as t_make_optimizer  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b", "xlstm-350m",
         "paligemma-3b", "musicgen-medium"]
RANK, NEW, LR = 4, 6, 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """Small products: one intra-op thread runs them fastest and spares the
    other test processes' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(C.to_numpy(got) if isinstance(got, torch.Tensor) else got,
                               np.asarray(want, np.float32), atol=atol, rtol=rtol)


def trees_close(got, want, atol=1e-5):
    """Port tree (tensors) against reference tree (arrays), leaf by leaf in
    key order, within ``atol`` of each leaf's largest value."""
    g, w = jax.tree.leaves(C._map(C.to_numpy, got)), jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w) and g
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=atol * max(1.0, float(np.abs(b).max())))


def reduced(arch):
    """``reduce_config``, with one period for the two 8-layer-period
    families: xlstm-350m keeps its 7 mLSTM + 1 sLSTM period, and jamba its
    attn / mamba period with MoE on every other layer plus a 2-layer
    remainder (a mamba with a dense FFN, a mamba with MoE), the only config
    here whose stack has one."""
    if arch == "xlstm-350m":
        return reduce_config(get_config(arch), n_periods=1)
    if arch == "jamba-1.5-large-398b":
        return dataclasses.replace(reduce_config(get_config(arch), n_periods=1), n_layers=10)
    return reduce_config(get_config(arch))


def to_reference(tree, cfg):
    """The port's params or serve caches (per-layer ``"stack"`` list, or the
    list itself) -> the reference's periods / remainder layout, as numpy
    (bf16 leaves as float32); ``convert``'s ``*_from_reference`` invert it."""
    layers = tree["stack"] if isinstance(tree, dict) else tree
    flat = [C._map(C.to_numpy, layer) for layer in layers]
    n, per = cfg.n_periods, cfg.period
    stack = {"periods": [jax.tree.map(lambda *xs: np.stack(xs), *flat[i : n * per : per]) for i in range(per)],
             "remainder": flat[n * per :]}
    if not isinstance(tree, dict):
        return stack
    return {**{k: C._map(C.to_numpy, v) for k, v in tree.items() if k != "stack"}, "stack": stack}


def live_norms(tree, cfg, seed=0):
    """The reference initialises every RMSNorm scale at 0, which without
    gemma's unit offset zeroes each block's input (and the readout's): draw
    the norm scales so that each norm's effective scale is around 1 and the
    parity cases reach every block."""
    rng = np.random.default_rng(seed)
    base = 0.0 if cfg.rmsnorm_unit_offset else 1.0

    def draw(path, x):
        if getattr(path[-1], "key", None) != "scale":
            return x
        return jnp.asarray(base + 0.1 * rng.normal(size=x.shape), x.dtype)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _no_near_ties(probs, k, eps=1e-6):
    """The top k+1 routing probabilities of every token are apart by more
    than ``eps``: both packages then pick the same experts, in order."""
    top = -np.sort(-np.asarray(probs), axis=-1)[..., : k + 1]
    return bool((np.diff(-top, axis=-1) > eps).all())


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_case(g, s, *, cf, shared, seed):
    base = reduce_config(get_config("qwen2-moe-a2.7b"))
    mcfg = dataclasses.replace(base.moe, capacity_factor=cf, n_shared=int(shared),
                               shared_d_ff=64 if shared else 0)
    x = np.random.default_rng(seed).normal(size=(g, s, base.d_model)).astype(np.float32)

    def ref(key, x):
        jp = JM.init_moe(key, base.d_model, mcfg)
        return jp, JM.route(jp["router"], x, mcfg), JM.moe_ffn(jp, x, mcfg)

    jp, jroute, jout = jax.jit(ref)(jax.random.key(seed), jnp.asarray(x))
    return mcfg, C._map(C.to_tensor, jax.tree.map(np.asarray, jp)), x, jroute, jout


@pytest.mark.parametrize("g,s,cf,shared", [(3, 16, 0.5, True), (2, 16, 4.0, False), (4, 1, 1.25, True)],
                         ids=["drops", "no-drops", "decode"])
def test_route_and_moe_ffn(g, s, cf, shared):
    mcfg, tp, x, (jg, ji, jprobs), (jy, jaux) = _moe_case(g, s, cf=cf, shared=shared, seed=g + s)
    assert _no_near_ties(jprobs, mcfg.top_k)
    tg, ti, tprobs = TM.route(tp["router"], torch.as_tensor(x), mcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tg, jg)
    close(tprobs, jprobs)
    # the case's drops, from the reference's own routing
    c = JM._capacity(s, mcfg)
    assert TM._capacity(s, mcfg) == c
    if s == 1:
        assert c == mcfg.top_k
    counts = np.stack([np.bincount(row.reshape(-1), minlength=mcfg.n_experts) for row in np.asarray(ji)])
    assert (counts > c).any() == (cf < 1)
    ty, taux = TM.moe_ffn(tp, torch.as_tensor(x), mcfg)
    close(ty, jy)
    close(taux, jaux)


# ---------------------------------------------------------------------------
# Recurrent cells
# ---------------------------------------------------------------------------

CELLS = {
    "mamba": ("jamba-1.5-large-398b", JS.init_mamba, JS.init_mamba_state, JS.mamba_seq, JS.mamba_step,
              TS.init_mamba_state, TS.mamba_seq, TS.mamba_step),
    "mlstm": ("xlstm-350m", JS.init_mlstm, JS.init_mlstm_state, JS.mlstm_seq, JS.mlstm_step,
              TS.init_mlstm_state, TS.mlstm_seq, TS.mlstm_step),
    "slstm": ("xlstm-350m", JS.init_slstm, JS.init_slstm_state, JS.slstm_seq, JS.slstm_step,
              TS.init_slstm_state, TS.slstm_seq, TS.slstm_step),
}


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_seq_step_and_states(kind):
    arch, j_init, j_state, j_seq, j_step, t_state, t_seq, t_step = CELLS[kind]
    cfg = reduced(arch)
    b, s = 2, 7
    x = np.random.default_rng(4).normal(size=(b, s, cfg.d_model)).astype(np.float32)

    def ref(key, x):
        jp = j_init(key, cfg)
        jy, jst = j_seq(jp, x, cfg, None)
        return jp, (jy, jst), j_seq(jp, x[:, ::-1], cfg, jst)

    jp, (jy, jst), (jy2, jst2) = jax.jit(ref)(jax.random.key(3), jnp.asarray(x))
    j_step = jax.jit(j_step, static_argnums=2)
    tp = C._map(C.to_tensor, jax.tree.map(np.asarray, jp))
    # the sequence form from no state, and from a state it left
    ty, tst = t_seq(tp, torch.as_tensor(x), cfg, None)
    close(ty, jy)
    trees_close(tst, jst)
    ty2, tst2 = t_seq(tp, torch.as_tensor(x[:, ::-1].copy()), cfg, tst)
    close(ty2, jy2)
    trees_close(tst2, jst2)
    # step by step from a zero state (the serve cache's dtypes) equals the sequence form
    jstate = j_state(b, cfg, jnp.float32)
    tstate = t_state(b, cfg, torch.float32)
    trees_close(tstate, jstate)
    ys = []
    for t in range(s):
        jyt, jstate = j_step(jp, jnp.asarray(x[:, t : t + 1]), cfg, jstate)
        yt, tstate = t_step(tp, torch.as_tensor(x[:, t : t + 1]), cfg, tstate)
        close(yt, jyt)
        ys.append(yt)
    close(torch.cat(ys, dim=1), jy)
    close(torch.cat(ys, dim=1), C.to_numpy(ty))
    trees_close(tstate, jst)
    # bf16 states keep their dtypes through a step
    bstate = t_state(b, cfg, torch.bfloat16)
    _, nb = t_step(tp, torch.as_tensor(x[:, :1]), cfg, bstate)
    assert {k: v.dtype for k, v in nb.items()} == {k: v.dtype for k, v in bstate.items()}


def test_causal_conv():
    rng = np.random.default_rng(0)
    x, w, st = (rng.normal(size=sh).astype(np.float32) for sh in ((2, 5, 6), (4, 6), (2, 3, 6)))
    for state in (None, st):
        jy, jn = JS._causal_conv1d(jnp.asarray(x), jnp.asarray(w), None if state is None else jnp.asarray(state))
        ty, tn = TS._causal_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                                   None if state is None else torch.as_tensor(state))
        close(ty, jy, atol=1e-6)
        close(tn, jn, atol=0)


# ---------------------------------------------------------------------------
# Blocks: every kind in every mode
# ---------------------------------------------------------------------------

# (arch, layer): qwen2's attention + MoE with a shared FFN, jamba's mamba with
# MoE (layer 1) and with a dense FFN (layer 0), xlstm's mLSTM (0) and sLSTM
# (7), musicgen's attention + ungated FFN, gemma2's local attention with
# sandwich norms (0)
BLOCKS = [("qwen2-moe-a2.7b", 0), ("jamba-1.5-large-398b", 0), ("jamba-1.5-large-398b", 1),
          ("xlstm-350m", 0), ("xlstm-350m", 7), ("musicgen-medium", 0), ("gemma2-9b", 0)]


@pytest.mark.parametrize("arch,layer", BLOCKS, ids=[f"{a}-{i}" for a, i in BLOCKS])
def test_block_forward_every_mode(arch, layer):
    cfg = reduced(arch)
    kind = cfg.layer_kinds()[layer]
    jp = live_norms(jax.jit(JB.init_block, static_argnums=(1, 2, 3, 4))(jax.random.key(layer), kind, layer, cfg,
                                                                        jnp.float32), cfg, layer)
    tp = C._map(C.to_tensor, jax.tree.map(np.asarray, jp))
    assert ("moe" in tp) == cfg.layer_has_moe(layer)
    b, s, seq = 2, 5, 8
    x = np.random.default_rng(layer).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    xd = np.random.default_rng(9).normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    jc0 = JB.init_block_cache(kind, b, seq, cfg, jnp.bfloat16)

    def ref(jp, x, xd, jc):
        train = JB.block_forward(kind, jp, x, cfg, mode="train")
        prefill = JB.block_forward(kind, jp, x, cfg, mode="prefill", cache=jc)
        return train, prefill, JB.block_forward(kind, jp, xd, cfg, mode="decode", cache=prefill[1],
                                                pos=jnp.asarray(s, jnp.int32))

    (jh, _, jaux), (jhp, jc, _), (jhd, _, jauxd) = jax.jit(ref)(jp, jnp.asarray(x), jnp.asarray(xd), jc0)
    th, tc, taux = TB.block_forward(kind, tp, torch.as_tensor(x), cfg, mode="train")
    close(th, jh)
    assert tc is None
    close(taux if taux is not None else 0.0, jaux)
    tc = TB.init_block_cache(kind, b, seq, cfg, torch.bfloat16)
    trees_close(tc, jc0)
    th, tc2, _ = TB.block_forward(kind, tp, torch.as_tensor(x), cfg, mode="prefill", cache=tc)
    assert tc2 is tc                       # written in place
    close(th, jhp)
    trees_close(tc, jc, atol=2 ** -8)      # bf16 leaves: one ulp of the leaf's scale
    th, tc, taux = TB.block_forward(kind, tp, torch.as_tensor(xd), cfg, mode="decode", cache=tc, pos=s)
    close(th, jhd, atol=1e-4)
    close(taux if taux is not None else 0.0, jauxd)


# ---------------------------------------------------------------------------
# The six configs end to end
# ---------------------------------------------------------------------------


class Setup:
    """One reduced config's params on both sides, inputs, and the
    reference's jitted prefill of them (drawn once for the module)."""

    def __init__(self, arch):
        cfg = self.cfg = reduced(arch)
        drawn = to_reference(TL.init_lm(torch.Generator().manual_seed(0), cfg), cfg)
        self.jp = live_norms(jax.tree.map(jnp.asarray, drawn), cfg)
        self.tp = C.params_from_reference(jax.tree.map(np.asarray, self.jp), cfg)
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, cfg.vocab_size, (4, 9)).astype(np.int32)
        self.prefix = (rng.normal(size=(4, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
                       if cfg.frontend else None)
        self.adapters = {"A": (rng.normal(size=(cfg.n_layers, cfg.d_model, RANK)) / np.sqrt(cfg.d_model)
                               ).astype(np.float32),
                         "B": (rng.normal(size=(cfg.n_layers, RANK, cfg.d_model)) * 0.1).astype(np.float32)}

    def jprefix(self, rows=slice(None)):
        return None if self.prefix is None else jnp.asarray(self.prefix[rows])

    def tprefix(self, rows=slice(None)):
        return None if self.prefix is None else torch.as_tensor(self.prefix[rows])

    @functools.cached_property
    def jprefill(self):
        """The reference's ``serve_prefill`` of the tokens (behind the
        prefix) into caches with room for ``NEW`` more: (logits, caches)."""
        b, n = self.tokens.shape
        caches = JL.init_serve_caches(self.cfg, b, TF.frontend_prefix_len(self.cfg) + n + NEW)
        return jax.jit(JL.serve_prefill, static_argnums=1)(self.jp, self.cfg, jnp.asarray(self.tokens), caches,
                                                           prefix_embeds=self.jprefix())


@functools.cache
def make_setup(arch):
    return Setup(arch)


@pytest.fixture(params=ARCHS)
def setup(request):
    return make_setup(request.param)


def test_forward_logits_and_train_loss(setup):
    s, cfg = setup, setup.cfg
    labels = np.roll(s.tokens, -1, axis=1)
    labels[0, 2] = -1
    jb = {"tokens": jnp.asarray(s.tokens), "labels": jnp.asarray(labels), "prefix_embeds": s.jprefix()}
    tb = {"tokens": torch.as_tensor(s.tokens), "labels": torch.as_tensor(labels), "prefix_embeds": s.tprefix()}

    def ref(jp, jb):
        jo = JL.lm_forward(jp, cfg, jb["tokens"], prefix_embeds=jb["prefix_embeds"])
        return JL.readout(jp, cfg, jo["h"]), jo["aux"], JL.train_loss_fn(jp, cfg, jb)

    jlogits, jaux, jloss = jax.jit(ref)(s.jp, jb)
    to = TL.lm_forward(s.tp, cfg, tb["tokens"], mode="train", prefix_embeds=s.tprefix())
    assert to["h"].shape == (4, 9 + TF.frontend_prefix_len(cfg), cfg.d_model)
    close(TL.readout(s.tp, cfg, to["h"]), jlogits, atol=1e-4)
    close(to["aux"], jaux)
    assert (float(to["aux"]) > 0) == (cfg.moe is not None)
    close(TL.train_loss_fn(s.tp, cfg, tb), jloss, atol=0)


def test_serve_tokens_equal_the_reference(setup):
    s, cfg = setup, setup.cfg
    if cfg.frontend is None:
        pool = JPool(3, cfg, RANK)
        pool.register("u0", s.adapters)
        idx = np.array(pool.lookup(["u0", None, "u0", None]))
        jpools = pool.pools()
        want = j_generate_grouped(s.jp, cfg, jnp.asarray(s.tokens), jpools, jnp.asarray(idx), max_new=NEW,
                                  use_kernel=False)
        got = generate_grouped(s.tp, cfg, torch.as_tensor(s.tokens),
                               C.pools_from_reference(jax.tree.map(np.asarray, jpools)), torch.as_tensor(idx),
                               max_new=NEW, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    # a frontend config: prefill behind the prefix, then decode from P + S
    b, n = s.tokens.shape
    p = TF.frontend_prefix_len(cfg)
    assert TF.prefix_spec(cfg, b) == ((b, p, cfg.d_model), torch.bfloat16)
    assert JF.prefix_spec(cfg, b).shape == (b, p, cfg.d_model)
    jl, jc = s.jprefill
    tl, tc = TL.serve_prefill(s.tp, cfg, torch.as_tensor(s.tokens),
                              TL.init_serve_caches(cfg, b, p + n + NEW, device="cpu"), prefix_embeds=s.tprefix())
    close(tl, jl, atol=1e-4)
    jtok0 = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    tok0 = TL.sample_token(tl, 0.0)
    np.testing.assert_array_equal(tok0.numpy(), np.asarray(jtok0))
    want, jc = JL.decode_scan(s.jp, cfg, jtok0, jnp.asarray(p + n, jnp.int32), jc, jax.random.key(0),
                              max_new=NEW)
    got, tc = TL.decode_scan(s.tp, cfg, tok0, p + n, tc, max_new=NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_skiplora_populate_and_cached_losses(setup):
    _populate_and_cached(setup, "full")


def test_skiplora_int8_cache_over_recurrent_acts():
    _populate_and_cached(make_setup("xlstm-350m"), "int8")


def _populate_and_cached(setup, mode):
    s, cfg = setup, setup.cfg
    n, batch, seq = 4, 2, 8
    kw = dict(rank=RANK, mode=mode, cache_dtype="float32")
    jsl, tsl = JSL.SkipLoRAConfig(**kw), TSL.SkipLoRAConfig(**kw)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (n, seq + 1)).astype(np.int32)
    p = TF.frontend_prefix_len(cfg)
    prefix = rng.normal(size=(n, p, cfg.d_model)).astype(np.float32) if p else None
    adapters = {"A": s.adapters["A"], "B": s.adapters["B"] * 0.1}
    orders = [rng.permutation(n).reshape(n // batch, batch).astype(np.int32) for _ in range(2)]

    jo = j_make_optimizer("adamw", LR)
    jt, js = JSL.split_trainable(jax.tree.map(jnp.asarray, adapters), jsl)
    jstate = jo.init(jt)
    jcache = JSL.init_lm_cache(n, cfg, jsl, p + seq)
    jstep = jax.jit(JSL.make_populate_step(cfg, jsl, jo))
    to = t_make_optimizer("adamw", LR)
    tt, ts = TSL.split_trainable(C.adapters_from_reference(adapters), tsl)
    tstate = to.init(tt)
    tcache = TSL.init_lm_cache(n, cfg, tsl, p + seq)
    tstep = TSL.make_populate_step(cfg, tsl, to)
    for idx in orders[0]:
        jb = {"tokens": jnp.asarray(toks[idx, :-1]), "labels": jnp.asarray(toks[idx, 1:])}
        tb = {"tokens": torch.as_tensor(toks[idx, :-1]), "labels": torch.as_tensor(toks[idx, 1:])}
        if p:
            jb["prefix_embeds"], tb["prefix_embeds"] = jnp.asarray(prefix[idx]), torch.as_tensor(prefix[idx])
        jt, jstate, jcache, jl = jstep(s.jp, jt, js, jstate, jcache, jb, jnp.asarray(idx))
        tt, tstate, tcache, tl = tstep(s.tp, tt, ts, tstate, tcache, tb, torch.as_tensor(idx))
        close(tl, jl, atol=0)
    got = C.cache_to_numpy(tcache)
    np.testing.assert_array_equal(got["labels"][:, :p], -1)
    trees_close({"y": tcache.slots["y_base"]}, {"y": jcache.slots["y_base"]})   # 1e-5 of its largest value
    _, _, jls = JSL.make_cached_epoch(cfg, jsl, jo, donate=False)(s.jp, jt, js, jstate, jcache,
                                                                    jnp.asarray(orders[1]))
    _, _, tls = TSL.make_cached_epoch(cfg, tsl, to)(s.tp, tt, ts, tstate, tcache, torch.as_tensor(orders[1]))
    close(tls, jls, atol=0)


def test_train_step_lowers_loss_and_decode_matches_teacher_forcing(setup):
    """``tests/test_arch_smoke.py``'s bars on the port."""
    s, cfg = setup, setup.cfg
    b, n = 2, 12
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, n + 1)))
    prefix = torch.as_tensor(s.prefix[:b]) if cfg.frontend else None
    batch = {"tokens": toks[:, :n], "labels": toks[:, :n], "prefix_embeds": prefix}
    params = C._map(lambda t: t.clone().requires_grad_(True), s.tp)
    leaves = []
    C._map(leaves.append, params)
    l0 = TL.train_loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(l0, leaves, allow_unused=True, materialize_grads=True)
    it = iter(grads)
    with torch.no_grad():
        stepped = C._map(lambda p: p - 0.5 * next(it), params)
        l1 = TL.train_loss_fn(stepped, cfg, batch)
    assert torch.isfinite(l0) and torch.isfinite(l1)
    assert float(l1) < float(l0.detach())
    if cfg.moe is not None:
        # capacity C = E / K * K * S / E = S: nothing drops. With drops the
        # teacher-forced pass routes the last token after S others and a
        # decode step (S = 1) routes it alone, so they differ, in the
        # reference too (whose own bar passes on zero RMSNorm scales).
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    with torch.no_grad():
        out = TL.lm_forward(s.tp, cfg, toks, mode="train")
        ref = TL.readout(s.tp, cfg, out["h"][:, -1:])
        # float32 caches: bf16 ones move jamba's step past the bar, in the reference too
        caches = TB.init_stack_caches(b, n + 8, cfg, torch.float32)
        _, caches = TL.serve_prefill(s.tp, cfg, toks[:, :n], caches)
        logits, _ = TL.serve_decode(s.tp, cfg, toks[:, n : n + 1], n, caches)
    assert torch.allclose(logits, ref, atol=3e-3, rtol=3e-3), float((logits - ref).abs().max())


def test_convert_round_trips_params_and_states(setup):
    """Params and a prefill's serve caches (KV caches, recurrent states) in
    the reference's tree, shapes and dtypes, and back bit for bit."""
    s, cfg = setup, setup.cfg
    b, n = s.tokens.shape
    p = TF.frontend_prefix_len(cfg)
    want = jax.eval_shape(lambda k: JL.init_lm(k, cfg), jax.random.key(0))
    got = to_reference(s.tp, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(got)] == [(w.shape, w.dtype) for w in jax.tree.leaves(want)]
    back = C.params_from_reference(got, cfg)
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(C._map(lambda t: t, back)),
                                                 jax.tree.leaves(C._map(lambda t: t, s.tp))))
    tc = TL.init_serve_caches(cfg, b, p + n + NEW, device="cpu")
    _, tc = TL.serve_prefill(s.tp, cfg, torch.as_tensor(s.tokens), tc, prefix_embeds=s.tprefix())
    want = jax.eval_shape(lambda: JL.init_serve_caches(cfg, b, p + n + NEW))
    got = to_reference(tc, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(got)] == [w.shape for w in jax.tree.leaves(want)]
    got = jax.tree.map(lambda a, w: np.asarray(a, w.dtype), got, want)   # the reference's dtypes
    assert any(np.abs(np.asarray(a, np.float32)).max() > 0 for a in jax.tree.leaves(got))
    back = C.caches_from_reference(got, cfg)
    assert [{k: (v.dtype, v.shape) for k, v in c.items()} for c in back] == \
        [{k: (v.dtype, v.shape) for k, v in c.items()} for c in tc]
    assert all(torch.equal(x[k], y[k]) for x, y in zip(back, tc) for k in x)
    # the stacked KV layout (the scheduler's) holds attention stacks only, as the paged pool does
    if set(cfg.layer_kinds()) <= set(TB.ATTN_KINDS):
        views = TL.layer_caches(TL.init_stacked_caches(cfg, b, 8, device="cpu"))
        assert [{k: (v.shape, v.dtype) for k, v in c.items()} for c in views] == \
            [{k: (v.shape, v.dtype) for k, v in c.items()} for c in TL.init_serve_caches(cfg, b, 8, device="cpu")]
    else:
        with pytest.raises(NotImplementedError, match="attention layers only"):
            TL.init_stacked_caches(cfg, b, 8, device="cpu")


def test_scheduler_serves_moe_and_refuses_recurrent_stacks():
    """The request scheduler runs an MoE config (its kinds are attention),
    padded admissions and prefix reuse included, with the reference's
    temperature-0 tokens and counters; a recurrent stack is refused, as
    the reference refuses it."""
    s = make_setup("qwen2-moe-a2.7b")
    cfg, jp, tp = s.cfg, s.jp, s.tp
    kw = dict(max_tenants=2, samples_per_tenant=1, seq=8)
    jrt = JRuntime(cfg, JSL.SkipLoRAConfig(rank=RANK, mode="full", cache_dtype="float32"), jp, **kw)
    trt = SessionRuntime(cfg, TSL.SkipLoRAConfig(rank=RANK), tp, device="cpu", **kw)
    rng = np.random.default_rng(6)
    ad = {"A": (rng.normal(size=(cfg.n_layers, cfg.d_model, RANK)) / np.sqrt(cfg.d_model)).astype(np.float32),
          "B": (rng.normal(size=(cfg.n_layers, RANK, cfg.d_model)) * 0.1).astype(np.float32)}
    jrt.pool.register("u0", ad)
    trt.pool.register("u0", ad)
    shared = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n).astype(np.int32)]) for n in (4, 2, 3)]
    who = ["u0", None, "u0"]
    sched_kw = dict(max_batch=2, max_prompt=16, max_new_cap=3, admit_bucket=2, inflight_per_tenant=2, chunk=2,
                    kv_block=4)
    results = []
    for cls, rt in ((JScheduler, jrt), (RequestScheduler, trt)):
        sched = cls(rt, **sched_kw)
        reqs = [sched.submit(t, p, max_new=3) for t, p in zip(who, prompts)]
        sched.drain()
        results.append(([np.asarray(r.result()) for r in reqs], dict(sched.counters)))
    (want, want_c), (got, got_c) = results
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got_c == want_c and got_c["dispatch/admit_reuse"] >= 1
    xcfg = reduced("xlstm-350m")
    xrt = SessionRuntime(xcfg, TSL.SkipLoRAConfig(rank=RANK), TL.init_lm(torch.Generator().manual_seed(0), xcfg),
                         device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="attention"):
        RequestScheduler(xrt)
