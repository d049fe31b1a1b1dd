"""The port's fleet fine-tuning (``core/fleet_finetune.py``, ``launch/fleet.py``)
against the reference on the CPU, and the reference's own bars held by the
port against itself.

Reduced stablelm-1.6b (float32). Params come from the reference's
``init_lm`` through ``repro_torch.convert``; tokens, labels and the initial
stacked adapters are the reference's (``jax.random`` keys, as its fleet CLI
and tests draw them), handed to the port as numpy. The reference runs its
Pallas kernels in interpret mode (``use_kernel=True``) or its
``blocked_skip_sum`` einsum (``use_kernel=False``); the port runs the plain
versions of K5/K8/K9 or its own ``blocked_skip_sum``.

Bars (float32): per-step per-tenant losses rtol 1e-5 and final stacked
adapters atol 2e-5 against the reference (summation order in the products
and the readout, amplified by AdamW over 6 steps, as in
``test_torch_finetune.py``); in mode ``int8`` the cache payload may round one
count apart where the two forwards' activations straddle a rounding boundary,
so losses rtol 1e-4 and adapters atol 1e-4. The port's own bars, as the
reference holds them (``tests/test_fleet_finetune.py``): fleet n = 1 equals
the single-tenant populate + cached trajectory (losses atol 1e-5, adapters
atol 1e-6 through the grouped plain versions, 5e-4 through the einsum route,
whose contractions run in another order), and a tenant trained in a fleet
equals the tenant trained alone (atol 1e-6)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import fleet_finetune as JFF  # noqa: E402
from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.models.lm import init_lm as j_init_lm  # noqa: E402
from repro.optim.optimizers import adamw as j_adamw  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import fleet_finetune as TFF  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.launch import fleet as cli  # noqa: E402
from repro_torch.optim.optimizers import adamw, sgd  # noqa: E402

CFG = reduce_config(get_config("stablelm-1.6b"))
RANK, N_T, N_PER, BPT, SEQ, EPOCHS, LR = 4, 2, 4, 2, 8, 3, 1e-2


@pytest.fixture(scope="module")
def ref_params():
    jp = j_init_lm(jax.random.key(0), CFG)
    return jp, C.params_from_reference(jax.tree.map(np.asarray, jp), CFG)


def _data(n_t=N_T, n_per=N_PER, seed=1):
    tok = jax.random.randint(jax.random.key(seed), (n_t, n_per, SEQ), 0, CFG.vocab_size)
    lab = jax.random.randint(jax.random.key(seed + 1), (n_t, n_per, SEQ), 0, CFG.vocab_size)
    return tok, lab, C.to_tensor(np.asarray(tok)), C.to_tensor(np.asarray(lab))


def _sl(mode, use_kernel):
    kw = dict(rank=RANK, mode=mode, cache_dtype="float32", use_fused_kernel=use_kernel)
    return JSL.SkipLoRAConfig(**kw), TSL.SkipLoRAConfig(**kw)


def _init(jsl, n_t, seed=3):
    stacked = JFF.init_fleet_adapters(jax.random.key(seed), CFG, jsl, n_t)
    return stacked, C.adapters_from_reference(jax.tree.map(np.asarray, stacked))


@pytest.mark.parametrize("mode,use_kernel", [("full", True), ("full", False), ("int8", True), ("int8", False)])
def test_fleet_finetune_matches_reference(ref_params, mode, use_kernel):
    jp, tp = ref_params
    jsl, tsl = _sl(mode, use_kernel)
    jtok, jlab, ttok, tlab = _data()
    want = JFF.fleet_finetune(jax.random.key(3), CFG, jsl, jp, jtok, jlab, epochs=EPOCHS,
                              batch_per_tenant=BPT, lr=LR, use_kernel=use_kernel)
    _, t_init = _init(jsl, N_T)
    got = TFF.fleet_finetune(None, CFG, tsl, tp, ttok, tlab, epochs=EPOCHS, batch_per_tenant=BPT,
                             lr=LR, use_kernel=use_kernel, adapters=t_init)
    assert got.losses.shape == want.losses.shape == (EPOCHS, N_PER // BPT, N_T)
    tol = (1e-5, 2e-5) if mode == "full" else (1e-4, 1e-4)
    np.testing.assert_allclose(got.losses, want.losses, rtol=tol[0])
    for k in ("A", "B"):
        np.testing.assert_allclose(C.to_numpy(got.adapters[k]), np.asarray(want.adapters[k]), atol=tol[1])
    assert len(got.epoch_times_s) == EPOCHS and got.cache.valid.all()


@pytest.mark.parametrize("use_kernel", [True, False])
def test_one_tenant_fleet_is_the_single_tenant_trajectory(ref_params, use_kernel):
    _, tp = ref_params
    _, tsl = _sl("full", use_kernel)
    _, _, ttok, tlab = _data(n_t=1, n_per=8, seed=11)
    init = TSL.init_adapters(torch.Generator().manual_seed(5), CFG, tsl)
    res = TFF.fleet_finetune(None, CFG, tsl, tp, ttok, tlab, epochs=EPOCHS, batch_per_tenant=4, lr=LR,
                             use_kernel=use_kernel, adapters=TFF.stack_tenant_adapters([init]))
    opt = adamw(LR)
    trainable, static = TSL.split_trainable(init, tsl)
    state = opt.init(trainable)
    cache = TSL.init_lm_cache(8, CFG, tsl, SEQ)
    pop, cached = TSL.make_populate_epoch(CFG, tsl, opt), TSL.make_cached_epoch(CFG, tsl, opt)
    ref = []
    for e in range(EPOCHS):
        idx = torch.as_tensor(TFF.fleet_index_matrix(e, 1, 8, 4))
        if e == 0:
            trainable, state, cache, ls = pop(tp, trainable, static, state, cache, ttok[0], tlab[0], idx)
        else:
            trainable, state, ls = cached(tp, trainable, static, state, cache, idx)
        ref.append(ls.numpy())
    np.testing.assert_allclose(res.losses[:, :, 0], np.stack(ref), atol=1e-5, rtol=1e-6)
    atol = 1e-6 if use_kernel else 5e-4
    for k in ("A", "B"):
        np.testing.assert_allclose(res.adapters[k][0].numpy(), trainable[k].numpy(), atol=atol, rtol=atol)


def test_fleet_tenant_equals_training_alone(ref_params):
    _, tp = ref_params
    _, tsl = _sl("full", True)
    _, _, ttok, tlab = _data(seed=5)
    stacked0 = TFF.init_fleet_adapters(torch.Generator().manual_seed(7), CFG, tsl, N_T)
    row_tenant = TFF.fleet_row_tenant(N_T, BPT)
    opt0 = sgd(0.0)      # populate the cache without moving the adapters
    cache = TSL.init_lm_cache(N_T * N_PER, CFG, tsl, SEQ)
    idx0 = torch.as_tensor(TFF.fleet_index_matrix(0, N_T, N_PER, BPT))
    stacked, _, cache, _ = TFF.make_fleet_populate_epoch(CFG, tsl, opt0, N_T)(
        tp, dict(stacked0), opt0.init(stacked0), cache, ttok.reshape(-1, SEQ), tlab.reshape(-1, SEQ),
        idx0, row_tenant)
    assert torch.equal(stacked["A"], stacked0["A"])
    opt = adamw(LR)
    idx1 = torch.as_tensor(TFF.fleet_index_matrix(1, N_T, N_PER, BPT))
    fleet, _, fleet_losses = TFF.make_fleet_cached_epoch(CFG, tsl, opt, N_T)(
        tp, dict(stacked0), opt.init(stacked0), cache, idx1, row_tenant)
    solo = TFF.make_fleet_cached_epoch(CFG, tsl, opt, 1)
    for t in range(N_T):
        one = {k: v[None] for k, v in TFF.tenant_adapters(stacked0, t).items()}
        out, _, losses = solo(tp, one, opt.init(one), cache, idx1[:, t * BPT:(t + 1) * BPT],
                              torch.zeros((BPT,), dtype=torch.int32))
        np.testing.assert_allclose(fleet_losses[:, t].numpy(), losses[:, 0].numpy(), atol=1e-6, rtol=1e-6)
        for k in ("A", "B"):
            np.testing.assert_allclose(fleet[k][t].numpy(), out[k][0].numpy(), atol=1e-6, rtol=1e-6)


def test_frozen_tenant_does_not_move_and_eval_epoch_brackets_training(ref_params):
    _, tp = ref_params
    _, tsl = _sl("int8", True)
    _, _, ttok, tlab = _data(seed=13)
    freeze = torch.tensor([True, False])
    res = TFF.fleet_finetune(torch.Generator().manual_seed(1), CFG, tsl, tp, ttok, tlab, epochs=2,
                             batch_per_tenant=BPT, lr=LR, freeze_mask=freeze)
    init = TFF.init_fleet_adapters(torch.Generator().manual_seed(1), CFG, tsl, N_T)
    for k in ("A", "B"):
        assert torch.equal(res.adapters[k][0], init[k][0]) and not torch.equal(res.adapters[k][1], init[k][1])
    epoch = TFF.make_fleet_cached_epoch_eval(CFG, tsl, adamw(LR), N_T)
    ev_idx = torch.as_tensor(np.concatenate([t * N_PER + np.arange(N_PER) for t in range(N_T)]))
    ev_rows = TFF.fleet_row_tenant(N_T, N_PER)
    idx = torch.as_tensor(TFF.fleet_index_matrix(2, N_T, N_PER, BPT))
    stacked, _, losses, pre, post = epoch(tp, res.adapters, adamw(LR).init(res.adapters), res.cache,
                                          idx, TFF.fleet_row_tenant(N_T, BPT), ev_idx, ev_rows)
    ev = TFF.make_fleet_eval_loss(CFG, tsl, N_T)
    from repro_torch.core.skip_cache import cache_read

    assert torch.equal(pre, ev(tp, res.adapters, cache_read(res.cache, ev_idx), ev_rows))
    assert torch.equal(post, ev(tp, stacked, cache_read(res.cache, ev_idx), ev_rows))
    assert losses.shape == (N_PER // BPT, N_T) and bool((post < pre).all())


@pytest.mark.parametrize("args", [(0, 3, 10, 4), (2, 2, 8, 4), (1, 4, 5, 2), (3, 1, 7, 7)])
def test_fleet_index_matrix_equals_reference(args):
    got = TFF.fleet_index_matrix(*args, seed=9)
    np.testing.assert_array_equal(got, JFF.fleet_index_matrix(*args, seed=9))
    epoch, n_t, n_per, bpt = args
    for t in range(n_t):     # every row of every partition is visited
        assert set(got[:, t * bpt:(t + 1) * bpt].ravel()) == set(range(t * n_per, (t + 1) * n_per))


def test_freeze_a_is_rejected(ref_params):
    _, tp = ref_params
    _, _, ttok, tlab = _data()
    sl = TSL.SkipLoRAConfig(rank=RANK, mode="freeze_a")
    with pytest.raises(ValueError, match="freeze_a"):
        TFF.fleet_finetune(torch.Generator(), CFG, sl, tp, ttok, tlab, epochs=1, batch_per_tenant=BPT)
    with pytest.raises(SystemExit):
        cli.parse_args(["--mode", "freeze_a"])


def test_cli_losses_are_the_reference_cli_losses(ref_params):
    """The reference's fleet CLI at --devices 1 is bitwise its offline
    ``fleet_finetune`` on these inputs (its --check-parity); the port's
    ``cli.run`` on the same inputs gives those losses (rtol 1e-5)."""
    jp, tp = ref_params
    args = cli.parse_args(["--device", "cpu", "--tenants", "2", "--samples", "4",
                           "--batch-per-tenant", "2", "--seq", str(SEQ), "--epochs", "2", "--use-kernel"])
    cfg, tsl = cli.setup(args)
    jsl = JSL.SkipLoRAConfig(rank=args.rank, mode=args.mode, cache_dtype="float32", use_fused_kernel=True)
    jtok, jlab, ttok, tlab = _data()
    want = JFF.fleet_finetune(jax.random.key(3), cfg, jsl, jp, jtok, jlab, epochs=2, batch_per_tenant=2,
                              optimizer=j_adamw(args.lr), use_kernel=True)
    _, t_init = _init(jsl, 2)
    got = cli.run(args, cfg, tsl, tp, ttok, tlab, adapters=t_init)
    np.testing.assert_allclose(got["losses"], want.losses, rtol=1e-5)


@pytest.mark.parametrize("flags", [[], ["--mode", "int8", "--use-kernel"]])
def test_cli_runs_on_the_cpu_with_the_loss_falling(flags, capsys):
    out = cli.main(["--device", "cpu", "--tenants", "2", "--samples", "4", "--batch-per-tenant", "2",
                    "--seq", "8", "--epochs", "3", "--lr", "5e-2", *flags])
    losses = out["losses"]
    assert losses.shape == (3, 2, 2) and np.isfinite(losses).all()
    assert (losses[2].mean(axis=0) < losses[0].mean(axis=0)).all()    # every tenant's loss falls
    text = capsys.readouterr().out
    assert "epoch 0 [populate] mean loss" in text and "epoch 2 [cached  ] mean loss" in text
    assert "tenants/s/epoch" in text


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--check-parity"]])
def test_cli_refuses_what_needs_the_session_runtime(flags):
    with pytest.raises(SystemExit, match="session runtime"):
        cli.main(["--device", "cpu", *flags])
