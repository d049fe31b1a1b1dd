"""The port's fine-tuning slice against the reference, on the CPU: the train
forward, the chunked readout loss, and the paper's loop -- a populate epoch
then two cached epochs -- in every cache mode, with the fused skip sum on
and off.

Reduced stablelm-1.6b and gemma-7b (float32). Params come from the
reference's ``init_lm`` through ``repro_torch.convert``; adapters, tokens and
epoch orders are numpy from a seed, fed to both packages. The reference runs
``make_populate_epoch(..., donate=False)`` and ``make_cached_epoch(...,
donate=False)``; the port runs its counterparts. With the fused route on,
the reference runs its Pallas kernels in interpret mode and the port its
plain versions.

Bars (float32): per-step losses rtol 1e-5; float cache slots atol/rtol 1e-5;
the int8 payload within one count, at no more than 0.1% of its entries:
the quantiser is bitwise the reference's on the same input
(``test_torch_skip_lora_grouped.py``), but the two forwards' float32
activations differ in the last bits, so a value on a rounding boundary may
land one count apart (1 of 16384 entries in the stablelm case); final
adapters atol 2e-5 and AdamW moments atol 2e-6 at lr 1e-3 (observed
differences are below a third of these: summation order in the products
and in the readout's log-softmax). The port's epoch loops equal its
stepwise loops bitwise, as the reference holds for its own scans."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.launch import finetune as cli  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.optim import make_optimizer as t_make_optimizer  # noqa: E402

RANK, N, BATCH, SEQ, LR = 4, 8, 4, 16, 1e-3
MODES = [("full", False), ("full", True), ("int8", False), ("int8", True), ("freeze_a", False)]


class Setup:
    def __init__(self, arch, mode="full", fused=False, seed=0):
        cfg = self.cfg = reduce_config(get_config(arch))
        kw = dict(rank=RANK, mode=mode, cache_dtype="float32", use_fused_kernel=fused)
        self.jsl, self.tsl = JSL.SkipLoRAConfig(**kw), TSL.SkipLoRAConfig(**kw)
        self.jp = JL.init_lm(jax.random.key(0), cfg)
        self.tp = C.params_from_reference(jax.tree.map(np.asarray, self.jp), cfg)
        rng = np.random.default_rng(seed)
        l, d = cfg.n_layers, cfg.d_model
        self.adapters = {"A": (rng.normal(size=(l, d, RANK)) / np.sqrt(d)).astype(np.float32),
                         "B": (rng.normal(size=(l, RANK, d)) * 0.01).astype(np.float32)}
        toks = rng.integers(0, cfg.vocab_size, (N, SEQ + 1)).astype(np.int32)
        self.tokens, self.labels = toks[:, :-1], toks[:, 1:]
        self.idx = [rng.permutation(N).reshape(N // BATCH, BATCH).astype(np.int32) for _ in range(3)]

    def reference(self):
        jo = j_make_optimizer("adamw", LR)
        t, s = JSL.split_trainable(jax.tree.map(jnp.asarray, self.adapters), self.jsl)
        o = jo.init(t)
        cache = JSL.init_lm_cache(N, self.cfg, self.jsl, SEQ)
        t, o, cache, l0 = JSL.make_populate_epoch(self.cfg, self.jsl, jo, donate=False)(
            self.jp, t, s, o, cache, jnp.asarray(self.tokens), jnp.asarray(self.labels),
            jnp.asarray(self.idx[0]))
        losses = [np.asarray(l0)]
        epoch = JSL.make_cached_epoch(self.cfg, self.jsl, jo, donate=False)
        for e in (1, 2):
            t, o, ls = epoch(self.jp, t, s, o, cache, jnp.asarray(self.idx[e]))
            losses.append(np.asarray(ls))
        return losses, jax.tree.map(np.asarray, cache), t, o

    def port(self):
        to = t_make_optimizer("adamw", LR)
        t, s = TSL.split_trainable(C.adapters_from_reference(self.adapters), self.tsl)
        o = to.init(t)
        cache = TSL.init_lm_cache(N, self.cfg, self.tsl, SEQ)
        t, o, cache, l0 = TSL.make_populate_epoch(self.cfg, self.tsl, to)(
            self.tp, t, s, o, cache, torch.as_tensor(self.tokens), torch.as_tensor(self.labels),
            torch.as_tensor(self.idx[0]))
        losses = [l0.numpy()]
        epoch = TSL.make_cached_epoch(self.cfg, self.tsl, to)
        for e in (1, 2):
            t, o, ls = epoch(self.tp, t, s, o, cache, torch.as_tensor(self.idx[e]))
            losses.append(ls.numpy())
        return losses, cache, t, o


@pytest.mark.parametrize("mode,fused", MODES)
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma-7b"])
def test_populate_then_cached_epochs_match_reference(arch, mode, fused):
    st = Setup(arch, mode, fused)
    j_losses, j_cache, j_t, j_o = st.reference()
    t_losses, t_cache, t_t, t_o = st.port()
    for a, b in zip(j_losses, t_losses):
        assert b.shape == (N // BATCH,)
        np.testing.assert_allclose(b, a, rtol=1e-5)
    got = C.cache_to_numpy(t_cache)
    assert set(got) == set(j_cache.slots) | {"valid"}
    np.testing.assert_array_equal(got["valid"], j_cache.valid)
    for name, want in j_cache.slots.items():
        assert got[name].shape == want.shape
        if name == "acts_q":
            diff = np.abs(got[name].astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size
        elif want.dtype.kind in "iub":
            np.testing.assert_array_equal(got[name], want)   # labels
        else:
            np.testing.assert_allclose(got[name], want, atol=1e-5, rtol=1e-5)
    got_t = C.adapters_to_reference(t_t)
    assert set(got_t) == set(j_t)
    for k in j_t:
        np.testing.assert_allclose(got_t[k], np.asarray(j_t[k]), atol=2e-5)
    jn, tn = C.opt_state_to_numpy(j_o), C.opt_state_to_numpy(t_o)
    assert jn["step"] == tn["step"] == 3 * N // BATCH
    for key in ("mu", "nu"):
        for k in jn[key]:
            np.testing.assert_allclose(tn[key][k], jn[key][k], atol=2e-6)


@pytest.mark.parametrize("mode", ["full", "int8"])
def test_epoch_loops_equal_stepwise_loops_bitwise(mode):
    st = Setup("stablelm-1.6b", mode, fused=True, seed=1)
    cfg, sl = st.cfg, st.tsl
    opt = t_make_optimizer("adamw", 1e-2)
    tokens, labels = torch.as_tensor(st.tokens), torch.as_tensor(st.labels)
    idx0, idx1 = torch.as_tensor(st.idx[0]), torch.as_tensor(st.idx[1])

    def fresh():
        t, s = TSL.split_trainable(C.adapters_from_reference(st.adapters), sl)
        return t, s, opt.init(t), TSL.init_lm_cache(N, cfg, sl, SEQ)

    t1, s, o1, c1 = fresh()
    t1, o1, c1, _ = TSL.make_populate_epoch(cfg, sl, opt)(st.tp, t1, s, o1, c1, tokens, labels, idx0)
    t1, o1, _ = TSL.make_cached_epoch(cfg, sl, opt)(st.tp, t1, s, o1, c1, idx1)

    t2, s, o2, c2 = fresh()
    pop, cached = TSL.make_populate_step(cfg, sl, opt), TSL.make_cached_step(cfg, sl, opt)
    for idx in idx0:
        batch = {"tokens": tokens[idx], "labels": labels[idx]}
        t2, o2, c2, _ = pop(st.tp, t2, s, o2, c2, batch, idx)
    for idx in idx1:
        t2, o2, _ = cached(st.tp, t2, s, o2, c2, idx)
    for k in t1:
        assert torch.equal(t1[k], t2[k])
        assert torch.equal(o1.mu[k], o2.mu[k]) and torch.equal(o1.nu[k], o2.nu[k])
    for k in c1.slots:
        assert torch.equal(c1.slots[k], c2.slots[k])
    assert int(c1.hit_count()) == N


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma2-9b"])
def test_train_forward_and_chunked_loss_match_reference(arch):
    """``lm_forward(mode="train")`` with adapters and collected acts, and the
    chunked loss with a ragged tail chunk (gemma2-9b: final softcap), with
    its gradient for h, against the reference (float32: atol 1e-5)."""
    st = Setup(arch)
    cfg = st.cfg
    tok = st.tokens[:2, :12]
    lab = st.labels[:2, :12].copy()
    lab[0, 3] = -1   # a masked position
    j_ad = JSL.adapters_to_stack(jax.tree.map(jnp.asarray, st.adapters), cfg)
    t_ad = TSL.adapters_to_stack(C.adapters_from_reference(st.adapters))
    jo = JL.lm_forward(st.jp, cfg, jnp.asarray(tok), mode="train", adapters=j_ad, collect_acts=True)
    to = TL.lm_forward(st.tp, cfg, torch.as_tensor(tok), mode="train", adapters=t_ad, collect_acts=True)
    assert to["caches"] is None
    for key in ("h", "y_base", "acts"):
        np.testing.assert_allclose(C.to_numpy(to[key]), np.asarray(jo[key]), atol=1e-5, rtol=1e-5)

    h = np.array(jo["h"])
    j_rows = JL.lm_loss_rows(st.jp, cfg, jnp.asarray(h), jnp.asarray(lab), chunk=5)
    t_rows = TL.lm_loss_rows(st.tp, cfg, torch.as_tensor(h), torch.as_tensor(lab), chunk=5)
    for a, b in zip(j_rows, t_rows):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)
    j_loss, j_gh = jax.value_and_grad(lambda x: JL.lm_loss(st.jp, cfg, x, jnp.asarray(lab), chunk=5))(
        jnp.asarray(h))
    th = torch.as_tensor(h).requires_grad_(True)
    t_loss = TL.lm_loss(st.tp, cfg, th, torch.as_tensor(lab), chunk=5)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(j_gh), atol=1e-6, rtol=1e-4)

    batch_j = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    batch_t = {"tokens": torch.as_tensor(tok), "labels": torch.as_tensor(lab)}
    np.testing.assert_allclose(float(TL.train_loss_fn(st.tp, cfg, batch_t, adapters=t_ad)),
                               float(JL.train_loss_fn(st.jp, cfg, batch_j, adapters=j_ad)), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="frontend"):
        TL.lm_forward(st.tp, cfg, torch.as_tensor(tok), prefix_embeds=torch.zeros(2, 1, cfg.d_model))


@pytest.mark.parametrize("mode", ["full", "int8", "freeze_a"])
def test_cache_layout_matches_reference(mode):
    cfg = reduce_config(get_config("gemma-7b"))
    for cache_dtype in ("float32", "bfloat16"):
        kw = dict(rank=RANK, mode=mode, cache_dtype=cache_dtype)
        jl = JSL.lm_cache_layout(cfg, JSL.SkipLoRAConfig(**kw), SEQ)
        tl = TSL.lm_cache_layout(cfg, TSL.SkipLoRAConfig(**kw), SEQ)
        assert {k: (s, str(d).split(".")[-1]) for k, (s, d) in tl.items()} == \
            {k: (s, jnp.dtype(d).name) for k, (s, d) in jl.items()}
        assert TSL.cache_nbytes_per_sample(cfg, TSL.SkipLoRAConfig(**kw), SEQ) == \
            JSL.cache_nbytes_per_sample(cfg, JSL.SkipLoRAConfig(**kw), SEQ)


@pytest.mark.parametrize("flags", [["--mode", "full"], ["--mode", "int8", "--use-kernel"],
                                   ["--mode", "freeze_a"]])
def test_cli_runs_each_mode_with_the_loss_falling(flags, capsys):
    out = cli.main(["--device", "cpu", "--epochs", "3", "--samples", "16", "--batch", "4",
                    "--seq", "32", "--lr", "1e-2", *flags])
    losses = out["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[2] < losses[1] < losses[0]
    text = capsys.readouterr().out
    assert "epoch 0 [populate]" in text and "epoch 2 [cached  ]" in text
    assert "cached-epoch speedup vs populate epoch" in text


def test_cli_refuses_the_tiered_engine():
    with pytest.raises(NotImplementedError, match="session-runtime slice"):
        cli.main(["--device", "cpu", "--hbm-mb", "0.05"])
