"""The port's grouped training pieces against the reference, on the CPU.

The plain versions of K7 (packed 4-bit pool), K8 (int8 activations) and K9
(grouped backward) are held against the reference's oracles and its Pallas
kernels in interpret mode; the trainable grouped sums
(``skip_lora_grouped_train``, ``_int8``, ``_q4``) against the reference's
custom VJPs (``use_kernel=True``, interpret mode) and its oracle autodiff
(``use_kernel=False``): ragged groups, an empty slot, ``freeze_mask``.

Tolerances: float32 activations and pools -> 1e-5 of the largest value
(summation order); bf16 values (K7 in bf16, every int8-activation case,
whose rows are bf16 by definition) -> 2^-7 of the largest output and 2^-6
of the largest gradient: z and gz round to bf16 in both packages and may
land one ulp apart when sums run in another order, and one such element
moves a whole sum over the slot's rows. Exact zeros where the contract says
so (empty and frozen slots, the zero slot of a 4-bit pool)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lm_skiplora as JSL  # noqa: E402
from repro.kernels.skip_lora import ops as JO  # noqa: E402
from repro.kernels.skip_lora import quant as JQ  # noqa: E402
from repro.kernels.skip_lora import ref as JR  # noqa: E402
from repro_torch.convert import to_numpy, to_tensor  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.kernels.skip_lora import ops as TO  # noqa: E402
from repro_torch.kernels.skip_lora import quant as TQ  # noqa: E402
from repro_torch.kernels.skip_lora import ref as TR  # noqa: E402

L, S, D, R = 2, 3, 32, 4
CASES = [  # (n slots, batch rows per slot): ragged, an empty slot
    (1, (4,)),
    (3, (2, 0, 3)),
    (4, (1, 3, 2, 0)),
]


def _case(n, groups, seed=0):
    rng = np.random.default_rng(seed)
    b = sum(groups)
    acts = rng.normal(size=(L, b, S, D)).astype(np.float32)
    a = (rng.normal(size=(n, L, D, R)) / np.sqrt(D)).astype(np.float32)
    bp = (rng.normal(size=(n, L, R, D)) * 0.1).astype(np.float32)
    idx = np.repeat(np.arange(n), groups).astype(np.int32)[rng.permutation(b)]
    cot = rng.normal(size=(b, S, D)).astype(np.float32)
    return acts, a, bp, idx, cot


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30))


def _rows(acts, idx):
    return acts.reshape(L, -1, D), np.repeat(idx, S)


def _torch_grads(fn, cot, *leaves):
    ts = [to_tensor(v).requires_grad_(True) for v in leaves]
    out = fn(*ts)
    (out.float() * to_tensor(cot)).sum().backward()
    return out.detach(), [to_numpy(t.grad) for t in ts]


def _jax_grads(fn, cot, *leaves):
    out, vjp = jax.vjp(fn, *[jnp.asarray(v) for v in leaves])
    return out, [np.asarray(gr) for gr in vjp(jnp.asarray(cot, out.dtype))]


# ---------------------------------------------------------------------------
# Plain versions of K7, K8, K9 against the reference's oracles and kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,groups,kind,dtype", [
    (1, (4,), "int4", "float32"),
    (3, (2, 0, 3), "nf4", "float32"),
    (4, (1, 3, 2, 0), "int4", "bfloat16"),
    (4, (1, 3, 2, 0), "nf4", "bfloat16"),
])
def test_q4_plain_version_matches_reference(n, groups, kind, dtype):
    acts, a, bp, idx, _ = _case(n, groups)
    a[0], bp[0] = 0.0, 0.0                               # slot 0 all zeros
    qa, sa = JQ.quantize_q4(jnp.asarray(a), kind)
    qb, sb = JQ.quantize_q4(jnp.asarray(bp), kind)
    code = JQ.codebook(kind)
    x, ridx = _rows(acts, idx)
    xj = jnp.asarray(x, {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype])
    want_k = JO._grouped_rows_q4(xj, qa, sa, qb, sb, code, jnp.asarray(ridx), tm=8)
    want_o = JR.skip_lora_grouped_q4_ref(xj, qa, sa, qb, sb, code, jnp.asarray(ridx))
    t = [to_tensor(np.asarray(v)) for v in (qa, sa, qb, sb, code)]
    got = TR.skip_lora_grouped_q4_ref(to_tensor(np.asarray(xj)), *t, to_tensor(ridx))
    got_w = TO.skip_lora_grouped_q4(to_tensor(np.asarray(xj))[:, :, None], *t, to_tensor(ridx))[:, 0]
    assert torch.equal(got, got_w) and got.dtype == to_tensor(np.asarray(xj)).dtype
    rel = 1e-5 if dtype == "float32" else 2.0**-7
    for want in (want_k, want_o):
        _close(to_numpy(got), want, rel)
    assert not to_numpy(got)[ridx == 0].any()            # the zero slot: exact zeros


@pytest.mark.parametrize("n,groups", CASES)
def test_actint8_plain_version_matches_reference(n, groups):
    acts, a, bp, idx, _ = _case(n, groups, seed=1)
    x, ridx = _rows(acts, idx)
    q, s = JSL.quantize_int8(jnp.asarray(x))
    want = JR.skip_lora_grouped_actint8_ref(q, s, jnp.asarray(a), jnp.asarray(bp), jnp.asarray(ridx))
    want_k = JO.skip_lora_grouped_train_int8(
        q.reshape(L, -1, S, D), s.reshape(L, -1, S), jnp.asarray(a), jnp.asarray(bp),
        jnp.asarray(idx), tm=8).reshape(-1, D)
    got = TR.skip_lora_grouped_actint8_ref(to_tensor(np.asarray(q)), to_tensor(np.asarray(s)),
                                           to_tensor(a), to_tensor(bp), to_tensor(ridx))
    assert got.dtype == torch.bfloat16
    for w in (want, want_k):
        _close(to_numpy(got), w, 2.0**-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,groups", CASES)
def test_grouped_backward_plain_version_matches_reference(n, groups, dtype):
    acts, a, bp, idx, cot = _case(n, groups, seed=2)
    x, ridx = _rows(acts, idx)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(cot.reshape(-1, D), jdt)
    want = JR.skip_lora_grouped_bwd_ref(xj, jnp.asarray(a), jnp.asarray(bp), gj, jnp.asarray(ridx))
    got = TR.skip_lora_grouped_bwd_ref(to_tensor(np.asarray(xj)), to_tensor(a), to_tensor(bp),
                                       to_tensor(np.asarray(gj)), to_tensor(ridx))
    rel = 1e-5 if dtype == "float32" else 2.0**-6
    empty = [s for s, c in enumerate(groups) if c == 0]
    for g_t, g_j in zip(got, want):
        assert g_t.dtype == torch.float32
        _close(to_numpy(g_t), g_j, rel)
        assert not to_numpy(g_t)[empty].any()


# ---------------------------------------------------------------------------
# Trainable grouped sums: gradients against the reference's VJPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,groups,freeze", [(1, (4,), False), (3, (2, 0, 3), True), (4, (1, 3, 2, 0), False)])
def test_trainable_float_grads_match_reference(n, groups, freeze):
    acts, a, bp, idx, cot = _case(n, groups, seed=3)
    mask = np.zeros(n, bool)
    mask[0] = freeze
    fm_t = to_tensor(mask) if freeze else None
    fm_j = jnp.asarray(mask) if freeze else None
    out_t, (ga_t, gb_t) = _torch_grads(
        lambda pa, pb: TO.skip_lora_grouped_train(to_tensor(acts), pa, pb, to_tensor(idx), freeze_mask=fm_t),
        cot, a, bp)
    for use_kernel in (True, False):
        out_j, (ga_j, gb_j) = _jax_grads(
            lambda pa, pb, uk=use_kernel: JO.skip_lora_grouped_train(
                jnp.asarray(acts), pa, pb, jnp.asarray(idx), use_kernel=uk, freeze_mask=fm_j, tm=8),
            cot, a, bp)
        _close(to_numpy(out_t), out_j, 1e-5)
        _close(ga_t, ga_j, 1e-5)
        _close(gb_t, gb_j, 1e-5)
    zero = [s for s, c in enumerate(groups) if c == 0] + ([0] if freeze else [])
    assert not ga_t[zero].any() and not gb_t[zero].any()
    if not freeze and groups[0]:
        assert ga_t[0].any() and gb_t[0].any()


@pytest.mark.parametrize("n,groups,freeze", [(1, (4,), False), (3, (2, 0, 3), False), (4, (1, 3, 2, 0), True)])
def test_trainable_int8_grads_match_reference(n, groups, freeze):
    acts, a, bp, idx, cot = _case(n, groups, seed=4)
    q, s = JSL.quantize_int8(jnp.asarray(acts))
    mask = np.zeros(n, bool)
    mask[-1] = freeze
    fm_t = to_tensor(mask) if freeze else None
    fm_j = jnp.asarray(mask) if freeze else None
    qt, st = to_tensor(np.asarray(q)), to_tensor(np.asarray(s))
    out_t, (ga_t, gb_t) = _torch_grads(
        lambda pa, pb: TO.skip_lora_grouped_train_int8(qt, st, pa, pb, to_tensor(idx), freeze_mask=fm_t),
        cot, a, bp)
    assert out_t.dtype == torch.bfloat16
    for use_kernel in (True, False):
        out_j, (ga_j, gb_j) = _jax_grads(
            lambda pa, pb, uk=use_kernel: JO.skip_lora_grouped_train_int8(
                q, s, pa, pb, jnp.asarray(idx), use_kernel=uk, freeze_mask=fm_j, tm=8),
            cot, a, bp)
        _close(to_numpy(out_t), out_j, 2.0**-7)
        _close(ga_t, ga_j, 2.0**-6)
        _close(gb_t, gb_j, 2.0**-6)
    zero = [s for s, c in enumerate(groups) if c == 0] + ([n - 1] if freeze else [])
    assert not ga_t[zero].any() and not gb_t[zero].any()


@pytest.mark.parametrize("n,groups,kind", [(3, (2, 0, 3), "int4"), (4, (1, 3, 2, 0), "nf4")])
def test_trainable_q4_scale_grads_match_reference(n, groups, kind):
    acts, a, bp, idx, cot = _case(n, groups, seed=5)
    qa, sa = JQ.quantize_q4(jnp.asarray(a), kind)
    qb, sb = JQ.quantize_q4(jnp.asarray(bp), kind)
    code = JQ.codebook(kind)
    mask = np.zeros(n, bool)
    mask[0] = True
    qa_t, qb_t, code_t = (to_tensor(np.asarray(v)) for v in (qa, qb, code))
    out_t, (gsa_t, gsb_t) = _torch_grads(
        lambda ps, pt: TO.skip_lora_grouped_train_q4(to_tensor(acts), qa_t, ps, qb_t, pt, code_t,
                                                     to_tensor(idx), freeze_mask=to_tensor(mask)),
        cot, np.asarray(sa), np.asarray(sb))
    for use_kernel in (True, False):
        out_j, (gsa_j, gsb_j) = _jax_grads(
            lambda ps, pt, uk=use_kernel: JO.skip_lora_grouped_train_q4(
                jnp.asarray(acts), qa, ps, qb, pt, code, jnp.asarray(idx), use_kernel=uk,
                freeze_mask=jnp.asarray(mask), tm=8),
            cot, sa, sb)
        _close(to_numpy(out_t), out_j, 1e-5)
        _close(gsa_t, gsa_j, 1e-5)
        _close(gsb_t, gsb_j, 1e-5)
    zero = [s for s, c in enumerate(groups) if c == 0] + [0]
    assert not gsa_t[zero].any() and not gsb_t[zero].any()


def test_cached_activations_get_no_gradient():
    acts, a, bp, idx, _ = _case(3, (2, 0, 3))
    x = to_tensor(acts).requires_grad_(True)
    pa = to_tensor(a).requires_grad_(True)
    TO.skip_lora_grouped_train(x, pa, to_tensor(bp), to_tensor(idx)).sum().backward()
    assert x.grad is None and pa.grad is not None


def test_freeze_keeps_the_forward_and_live_mask_needs_no_bincount():
    acts, a, bp, idx, _ = _case(4, (1, 3, 2, 0))
    fm = to_tensor(np.array([True, False, True, False]))
    base = TO.skip_lora_grouped_train(to_tensor(acts), to_tensor(a), to_tensor(bp), to_tensor(idx))
    frozen = TO.skip_lora_grouped_train(to_tensor(acts), to_tensor(a), to_tensor(bp), to_tensor(idx),
                                        freeze_mask=fm)
    assert torch.equal(base, frozen)
    live = TO._live_slot_mask(to_tensor(np.repeat(idx, S)), 4)
    np.testing.assert_array_equal(live.numpy(), np.asarray(JO._live_slot_mask(jnp.asarray(idx), 4)))


def test_port_quantiser_feeds_the_plain_versions_like_the_reference():
    """End to end through the port's own quantiser: its int8 rows and 4-bit
    pools give the reference's outputs (float32, 1e-5)."""
    acts, a, bp, idx, _ = _case(3, (2, 1, 3), seed=6)
    x, ridx = _rows(acts, idx)
    for kind in ("int4", "nf4"):
        qa, sa = TQ.quantize_q4(to_tensor(a), kind)
        qb, sb = TQ.quantize_q4(to_tensor(bp), kind)
        got = TR.skip_lora_grouped_q4_ref(to_tensor(x), qa, sa, qb, sb, TQ.codebook(kind), to_tensor(ridx))
        jqa, jsa = JQ.quantize_q4(jnp.asarray(a), kind)
        jqb, jsb = JQ.quantize_q4(jnp.asarray(bp), kind)
        want = JR.skip_lora_grouped_q4_ref(jnp.asarray(x), jqa, jsa, jqb, jsb, JQ.codebook(kind),
                                           jnp.asarray(ridx))
        _close(to_numpy(got), want, 1e-5)
    q, s = TSL.quantize_int8(to_tensor(x))
    jq, js = JSL.quantize_int8(jnp.asarray(x))
    got = TR.skip_lora_grouped_actint8_ref(q, s, to_tensor(a), to_tensor(bp), to_tensor(ridx))
    want = JR.skip_lora_grouped_actint8_ref(jq, js, jnp.asarray(a), jnp.asarray(bp), jnp.asarray(ridx))
    _close(to_numpy(got), want, 2.0**-7)
