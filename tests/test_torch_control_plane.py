"""The port's control plane (``core/control_plane.py``: shadow eval policy,
regression gate, rollback ledger) against the reference's, and the gated
``SessionRuntime.adapt`` on the port, on the CPU.

Policy: each case runs one sequence of ``decide`` / ``record`` /
``record_rollback`` / ``load_state`` calls on the reference's
``ControlPlane`` and on the port's, and every return value, ``metrics()``
and the JSON round trip of ``state()`` must be equal (the module is a copy
of framework-free code: exact).

Gated runtime (reduced stablelm-1.6b float32, rank 4, 2 tenants x 8 samples
x seq 8, held-out every 4th row; the reference's ``TestGatedRuntime``
cases): reject freezes the training state and the served slot, quarantine
advances one and not the other, the streaming path evaluates too, a tenant
below ``holdout_every`` rows passes ungated, the auto-rollback streak
resets the optimizer and restores the archived version, the control-off
session keeps no history, and a manual rollback counts. Every gate
decision the port's session records equals the reference's
``ControlPlane.decide`` on the same pre/post losses."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import control_plane as JCP  # noqa: E402
from repro.models.lm import init_lm as j_init_lm  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import control_plane as TCP  # noqa: E402
from repro_torch.core import lm_skiplora as TSL  # noqa: E402
from repro_torch.core.runtime import SessionRuntime  # noqa: E402


def config_validation(m):
    out = []
    for kw in (dict(holdout_every=1), dict(mode="warn"), dict(history_depth=0), dict(auto_rollback_after=0)):
        with pytest.raises(ValueError) as e:
            m.ControlConfig(**kw)
        out.append(str(e.value))
    return out


def decide_semantics(m):
    cp = m.ControlPlane(m.ControlConfig(threshold=0.1, mode="quarantine"))
    return [cp.decide("t", None, 3.0), cp.decide("t", 3.0, None), cp.decide("t", 3.0, 3.05),
            cp.decide("t", 3.0, 3.2), m.ControlPlane(m.ControlConfig()).decide("t", 3.0, 3.2)]


def ledger_and_quarantine_lifecycle(m):
    cp = m.ControlPlane(m.ControlConfig(mode="quarantine"))
    cp.record(7, "quarantine", pre=1.0, post=2.0, step=4)
    out = [cp.is_quarantined(7), cp.quarantined, cp.last(7)]
    cp.record(7, "accept", pre=2.0, post=1.5, step=8)
    out += [cp.is_quarantined(7), cp.accepted, cp.metrics()]
    cp.record(7, "quarantine", pre=1.5, post=9.0, step=12)
    cp.record_rollback(7)
    out += [cp.is_quarantined(7), cp.rollbacks, cp.last(7)]
    with pytest.raises(ValueError, match="decision"):
        cp.record(7, "maybe")
    return out + [cp.metrics()]


def auto_rollback_streak_policy(m):
    cp = m.ControlPlane(m.ControlConfig(auto_rollback_after=2))
    out = []
    for step, dec in enumerate(["reject", "reject"]):
        cp.record("t", dec, pre=1.0, post=2.0, step=step)
        out.append(cp.should_auto_rollback("t"))
    cp.record_rollback("t", auto=True)
    out += [(cp.rollbacks, cp.auto_rollbacks), cp.should_auto_rollback("t")]
    for step, dec in ((3, "reject"), (4, "accept"), (5, "reject")):
        cp.record("t", dec, pre=1.0, post=0.5 if dec == "accept" else 2.0, step=step)
    out.append(cp.should_auto_rollback("t"))
    cp.record_rollback("t")
    out.append((cp.rollbacks, cp.auto_rollbacks))
    off = m.ControlPlane(m.ControlConfig())
    off.record("t", "reject", pre=1.0, post=2.0, step=1)
    off.record("t", "reject", pre=1.0, post=2.0, step=2)
    return out + [off.should_auto_rollback("t"), cp.metrics()]


def state_round_trip_through_json(m):
    cp = m.ControlPlane(m.ControlConfig(mode="quarantine", auto_rollback_after=3))
    cp.record(3, "reject", pre=1.0, post=2.0, step=2)
    cp.record(4, "quarantine", pre=1.0, post=2.0, step=2)
    cp.record(4, "quarantine", pre=1.0, post=2.5, step=3)
    wire = json.loads(json.dumps(cp.state()))
    back = m.ControlPlane(cp.config)
    back.load_state(wire)
    out = [wire, back.last(3), back.is_quarantined(4), back.should_auto_rollback(4)]
    back.record(4, "quarantine", pre=1.0, post=2.0, step=4)
    out.append(back.should_auto_rollback(4))     # the int key's streak survived JSON
    old = m.ControlPlane(cp.config)
    old.load_state({**wire, "counters": wire["counters"][:4]})   # a manifest from before auto-rollback
    return out + [back.metrics(), old.auto_rollbacks, back.quarantined_tenants()]


POLICY = [config_validation, decide_semantics, ledger_and_quarantine_lifecycle, auto_rollback_streak_policy,
          state_round_trip_through_json]


@pytest.mark.parametrize("case", POLICY, ids=[c.__name__ for c in POLICY])
def test_policy_matches_reference(case):
    assert case(TCP) == case(JCP)


# ---------------------------------------------------------------------------
# The gated runtime
# ---------------------------------------------------------------------------

CFG = reduce_config(get_config("stablelm-1.6b"))
ALWAYS = TCP.ControlConfig(holdout_every=4, threshold=float("-inf"))   # every re-registration gates
NEVER = TCP.ControlConfig(holdout_every=4, threshold=float("inf"))


@pytest.fixture(scope="module")
def tp():
    return C.params_from_reference(jax.tree.map(np.asarray, j_init_lm(jax.random.key(0), CFG)), CFG)


def _data(n_t=2, n_per=8, seq=8, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.integers(0, CFG.vocab_size, (n_t, n_per, seq)).astype(np.int32))
                 for _ in range(2))


def _adapted(tp, control, *, n_per=8, **kw):
    rt = SessionRuntime(CFG, TSL.SkipLoRAConfig(rank=4, cache_dtype="float32"), tp, max_tenants=2,
                        samples_per_tenant=n_per, seq=8, lr=5e-2, control=control, device="cpu", **kw)
    tok, lab = _data(n_per=n_per)
    for t in range(2):
        rt.ingest(f"u{t}", tok[t], lab[t])
    rt.adapt(epochs=1, batch_per_tenant=4, generator=torch.Generator().manual_seed(3))
    return rt


def _payload(rt, tenant):
    return {n: v.clone() for n, v in rt.pool.slot_payload(tenant).items()}


def _same_payload(a, b):
    return all(torch.equal(a[n], b[n]) for n in a)


def _ledger(rt):
    return dict(rt.control_metrics()["tenants"])


def _decisions_match_reference(rt):
    """Each recorded decision is the reference policy's on the same losses."""
    ref = JCP.ControlPlane(JCP.ControlConfig(**dataclasses.asdict(rt.control.config)))
    for t, rec in _ledger(rt).items():
        if rec["pre"] is not None and rec["post"] is not None:
            assert ref.decide(t, rec["pre"], rec["post"]) == rec["decision"], (t, rec)


def test_reject_freezes_training_and_serving_state(tp):
    rt = _adapted(tp, ALWAYS)
    assert {r["decision"] for r in _ledger(rt).values()} == {"accept"}   # first write-back: nothing to protect
    step1, v1 = rt.tenant("u0").step, _payload(rt, "u0")
    rt.adapt(epochs=1, batch_per_tenant=4)
    rec = _ledger(rt)["u0"]
    assert rec["decision"] == "reject" and rec["pre"] is not None and rec["post"] is not None
    assert rt.tenant("u0").step == step1 and _same_payload(_payload(rt, "u0"), v1)
    assert rt.counters["control/reject"] == 2 and rt.pool.stats.gate_rejected == 2
    _decisions_match_reference(rt)


def test_quarantine_advances_state_but_serves_old(tp):
    rt = _adapted(tp, dataclasses.replace(ALWAYS, mode="quarantine"))
    step1, v1 = rt.tenant("u0").step, _payload(rt, "u0")
    rt.adapt(epochs=1, batch_per_tenant=4)
    assert rt.control.is_quarantined("u0") and rt.tenant("u0").step > step1
    assert _same_payload(_payload(rt, "u0"), v1)
    assert rt.control_metrics()["quarantined_tenants"] == ["u0", "u1"]
    q = rt.scheduler.quality_metrics()
    assert q["quarantine"] == 2 and q["accept"] == 2 and q["gate"]["quarantined"] == 2
    assert q["quarantined_tenants"] == ["u0", "u1"]
    _decisions_match_reference(rt)


@pytest.mark.parametrize("cache_capacity", [None, 8], ids=["scan", "stream"])
def test_both_adapt_paths_evaluate_the_same(tp, cache_capacity):
    """Shadow eval on the resident path (folded into the epoch call) and on
    the streaming one (separate calls over engine reads) records the same
    pre/post losses and decisions, and an accepted write-back archives."""
    kw = {} if cache_capacity is None else dict(cache_capacity=cache_capacity)
    rt = _adapted(tp, NEVER, **kw)
    out = rt.adapt(epochs=2, batch_per_tenant=4)
    assert out["path"] == ("scan" if cache_capacity is None else "stream")
    rec = _ledger(rt)["u0"]
    assert rec["pre"] is not None and rec["post"] is not None and rec["decision"] == "accept"
    assert rt.pool.history_len("u0") == 1
    if cache_capacity is not None:
        resident = _adapted(tp, NEVER)
        resident.adapt(epochs=2, batch_per_tenant=4)
        assert _ledger(resident) == _ledger(rt)
        assert _same_payload(_payload(resident, "u0"), _payload(rt, "u0"))


def test_too_few_rows_passes_ungated(tp):
    rt = SessionRuntime(CFG, TSL.SkipLoRAConfig(rank=4, cache_dtype="float32"), tp, max_tenants=2,
                        samples_per_tenant=4, seq=8, lr=5e-2, control=NEVER, device="cpu")
    tok, lab = _data(n_t=1, n_per=3)
    rt.ingest("u0", tok[0], lab[0])
    rt.adapt(epochs=1, batch_per_tenant=2)
    rt.adapt(epochs=1, batch_per_tenant=2)
    rec = _ledger(rt)["u0"]
    assert rec["decision"] == "accept" and rec["pre"] is None and rec["post"] is None


def test_auto_rollback_fires_after_streak_and_resets_optimizer(tp):
    rt = _adapted(tp, dataclasses.replace(ALWAYS, auto_rollback_after=2))   # adapt 1 accepts
    v1 = _payload(rt, "u0")
    rt.adapt(epochs=1, batch_per_tenant=4)                                    # reject, streak 1
    assert rt.control.auto_rollbacks == 0 and bool(rt.tenant("u0").opt_mu["A"].any())
    rt.adapt(epochs=1, batch_per_tenant=4)                                    # reject, streak 2: fires
    assert rt.control.auto_rollbacks == 2 and rt.counters["control/auto_rollbacks"] == 2
    assert rt.counters["control/rollbacks"] == 2
    st = rt.tenant("u0")
    assert st.step == 0 and not any(bool(v.any()) for v in st.opt_mu.values())
    assert _same_payload(_payload(rt, "u0"), v1)
    rt.adapt(epochs=1, batch_per_tenant=4)                                    # streak 1 again: no firing
    assert rt.control.auto_rollbacks == 2
    _decisions_match_reference(rt)


def test_auto_rollback_restores_archived_version(tp):
    rt = _adapted(tp, dataclasses.replace(NEVER, auto_rollback_after=2))     # v1 accepted
    v1 = _payload(rt, "u0")
    rt.adapt(epochs=1, batch_per_tenant=4)                                    # v2 accepted, v1 archived
    assert rt.pool.history_len("u0") == 1
    rt.control.config = dataclasses.replace(rt.control.config, threshold=float("-inf"))
    rt.adapt(epochs=1, batch_per_tenant=4)
    rt.adapt(epochs=1, batch_per_tenant=4)                                    # streak 2: rolls back to v1
    assert rt.control.auto_rollbacks == 2 and rt.pool.history_len("u0") == 0
    assert _same_payload(_payload(rt, "u0"), v1)


def test_control_off_and_manual_rollback(tp):
    off = _adapted(tp, None)
    assert off.control is None and off.control_metrics() is None and off.pool.history_depth == 0
    with pytest.raises(KeyError):
        off.pool.rollback("u0")
    assert off.scheduler.quality_metrics() == {}
    rt = _adapted(tp, NEVER)
    v1, info1 = _payload(rt, "u0"), rt.pool.version_info("u0")
    rt.adapt(epochs=1, batch_per_tenant=4)       # v2 accepted, v1 archived
    version = rt.pool.version
    assert rt.rollback("u0") == {"step": info1["step"], "eval_loss": info1["eval_loss"]}
    assert rt.pool.version == version + 1 and _same_payload(_payload(rt, "u0"), v1)
    assert rt.counters["control/rollbacks"] == 1 and rt.control_metrics()["rollbacks"] == 1
    assert "u0" not in _ledger(rt)
