"""A run of each cell with the timed path broken underneath comes out not
correct, and so does the control: the reference in float8 put in the
program's place. The harness's look for a card is skipped (``run_cell``
on the CPU, cells cut to a small size); the rest of a run is driven
whole, against the cell's own limits."""

from __future__ import annotations

import pytest

from portbench import harness as H
from portbench.run import run_cell
from portbench.tests.tiny import tiny_cell

SEED = 2**31 + 99
TRAIN = ["stablelm-adapt", "jobs"]
SERVE = ["qwen2moe-sched", "prefix"]


def _run(workload):
    return run_cell(tiny_cell(workload), SEED, 0.5, False, "cpu", 0.0)


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_step_that_returns_its_state_unchanged(workload, monkeypatch):
    from repro_torch.core import fleet_finetune as FF

    real = FF._adapter_step

    def unchanged(optimizer, stacked, opt_state, loss_fn):
        _, opt, per = real(optimizer, stacked, opt_state, loss_fn)
        return stacked, opt, per

    monkeypatch.setattr(FF, "_adapter_step", unchanged)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out(workload, monkeypatch):
    from repro_torch.core import fleet_finetune as FF

    real = FF.per_tenant_loss

    def half(params, cfg, h, labels, n_tenants):
        lab = labels.clone().reshape(n_tenants, -1, labels.shape[-1])
        lab[:, lab.shape[1] // 2:] = -1                      # the mean over the first half of each tenant's rows
        return real(params, cfg, h, lab.reshape(labels.shape), n_tenants)

    monkeypatch.setattr(FF, "per_tenant_loss", half)
    assert not _run(workload)["correct"]


def test_window_call_from_a_stale_carry(monkeypatch):
    """A call of the window that trains from the first call's carry (its
    adapters and moments) and not from the state the calls before it
    left: only the window's last call, which the reference follows from
    that state, can show it."""
    from repro_torch.core.runtime import SessionRuntime

    real = SessionRuntime._adapt_epochs
    first: dict = {}

    def stale(self, group, *args, **kwargs):
        states = [self.tenant(t) for t in group]
        now = [(st.adapters, st.opt_mu, st.opt_nu) for st in states]
        carry = first.setdefault(tuple(group), [tuple({k: v.clone() for k, v in tree.items()} for tree in s)
                                                for s in now])
        for st, (a, mu, nu) in zip(states, carry):
            st.adapters, st.opt_mu, st.opt_nu = a, mu, nu
        try:
            return real(self, group, *args, **kwargs)
        finally:
            for st, (a, mu, nu) in zip(states, now):
                st.adapters, st.opt_mu, st.opt_nu = a, mu, nu

    monkeypatch.setattr(SessionRuntime, "_adapt_epochs", stale)
    assert not _run("stablelm-adapt")["correct"]


@pytest.mark.parametrize("workload", SERVE)
def test_token_altered_where_it_is_produced(workload, monkeypatch):
    from repro_torch.core import scheduler as S
    from repro_torch.models import lm

    real = lm.sample_token

    def altered(logits, temperature, generator=None):
        return (real(logits, temperature, generator) + 1) % logits.shape[-1]

    monkeypatch.setattr(lm, "sample_token", altered)
    monkeypatch.setattr(S, "sample_token", altered)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_control_comes_out_apart(workload):
    """The control: the reference in float8 e4m3 in the program's place,
    read against the float32 reference as the program is. At this size
    one of the cell's numbers reads at least three times the sound run's,
    the separation its limit is set in on the card (``limits/``: the
    control's readings there at the cell's own size)."""
    cell = tiny_cell(workload)
    driver = H.driver_class(cell.traffic)(cell.config, cell.traffic, SEED, "cpu", H.Spans())
    driver.setup()
    driver.window(0.5, None)
    driver.release()
    got = driver.check(control=True)
    sound, ctl = got["readings"], got["control"]
    assert any(ctl[k] > 0 and ctl[k] >= 3 * sound[k] for k in cell.limits), (sound, ctl)
    for k, v in cell.limits.items():
        assert v["lower"] is None or v["lower"] < v["limit"] < v["upper"], (k, v)
