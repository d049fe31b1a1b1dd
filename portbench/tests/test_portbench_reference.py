"""The plain references against the program on the CPU, at reduced sizes in
float32, where the two must agree to rounding."""

from __future__ import annotations


import numpy as np
import pytest
import torch

from portbench import harness as H
from portbench import weights as W
from portbench.reference import decoder as RD
from portbench.reference import skip2lora as RS
from portbench.run import run_cell
from portbench.tests.tiny import tiny_cell, tiny_config

#: float32 on both sides, products in different orders: a few ulps of the
#: hidden state's scale after two layers
TOL = 2e-5


def _adapters(cfg: dict, seed: int, rank: int = 4):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((cfg["n_layers"], cfg["d_model"], rank), generator=g) / cfg["d_model"] ** 0.5
    b = torch.randn((cfg["n_layers"], rank, cfg["d_model"]), generator=g) * 0.05
    return a, b


@pytest.mark.parametrize("name,capacity_factor", [("stablelm-1.6b", None), ("qwen2-moe-a2.7b", 1.25),
                                                  ("qwen2-moe-a2.7b", 0.5)])
def test_decoder_matches_the_program(name, capacity_factor):
    from repro_torch.models.lm import lm_forward, readout

    cfg = tiny_config(name, "float32")
    if capacity_factor is not None:
        cfg["moe"]["capacity_factor"] = capacity_factor
    weights = W.make(cfg, 7, "cpu")
    port = W.port_config(cfg)
    tokens = torch.randint(0, cfg["vocab_size"], (3, 24), generator=torch.Generator().manual_seed(1))
    a, b = _adapters(cfg, 2)
    stack = [{"A": a[i], "B": b[i]} for i in range(cfg["n_layers"])]
    want = lm_forward(weights, port, tokens, mode="train", adapters=stack)
    got = RD.forward(weights, cfg, [tokens], adapters=[(a, b)])
    assert torch.allclose(got["h"][0], want["h"], atol=TOL, rtol=TOL)
    assert torch.allclose(RD.logits(weights, cfg, got["h"][0]), readout(weights, port, want["h"]),
                          atol=TOL, rtol=TOL)


def test_moe_capacity_drops_match_the_program():
    """With a small capacity factor many assignments drop; the reference
    drops the same ones."""
    from repro_torch.models.moe import moe_ffn

    cfg = tiny_config("qwen2-moe-a2.7b", "float32")
    cfg["moe"]["capacity_factor"] = 0.5
    weights = W.make(cfg, 3, "cpu")
    p = weights["stack"][0]["moe"]
    z = torch.randn((2, 32, cfg["d_model"]), generator=torch.Generator().manual_seed(4))
    want, _ = moe_ffn(p, z, W.port_config(cfg).moe)
    got = torch.stack([RD.moe_ffn(cfg, p, row, [(0, 32, 32)], "fp32") for row in z])
    assert torch.allclose(got, want, atol=TOL, rtol=TOL)
    full = torch.stack([RD.moe_ffn(cfg, p, row, [(0, 32, 10_000)], "fp32") for row in z])
    assert not torch.allclose(full, want, atol=1e-3)          # the drops matter here


def test_moe_groups_of_one_drop_nothing():
    cfg = tiny_config("qwen2-moe-a2.7b", "float32")
    assert RD.capacity(cfg["moe"], 1) == cfg["moe"]["top_k"]


def test_fp8_rounding_is_coarse_but_bounded():
    x = torch.randn(64, 128, generator=torch.Generator().manual_seed(0))
    q = RD.fp8_round(x, -1)
    rel = ((q - x).abs() / x.abs().amax(dim=-1, keepdim=True)).max()
    assert 1e-3 < float(rel) <= 2.0 ** -4


def test_plan_matches_the_programs_planner():
    from repro_torch.core import batch_plan

    for seed, part, epoch, n, bpt in [(5, 0, 0, 64, 2), (1 << 29, 3, 1, 64, 8), (11, 2, 0, 10, 4)]:
        want = batch_plan.fleet_index_matrix(epoch, 1, n, bpt, seed=seed, partitions=[0], streams=[part])
        assert np.array_equal(RS.plan(seed, part, epoch, n, bpt), want)


@pytest.mark.parametrize("workload", ["stablelm-adapt", "jobs"])
def test_training_reference_follows_the_program(workload):
    """Float32 on both sides: the losses, moments and changes of the first
    call agree to rounding, far inside the cell's limits."""
    res = run_cell(tiny_cell(workload, "float32"), 987654321012, 0.5, False, "cpu", 0.0)
    assert res["correct"]
    for name, c in res["checks"].items():
        assert c["value"] < 1e-4, (name, c)


def test_the_window_s_last_call_is_followed():
    """The reference follows set-up's first call from the first draw and
    the window's last from the state the calls before it left; in float32
    both agree with the program to rounding."""
    cell = tiny_cell("stablelm-adapt", "float32")
    driver = H.driver_class(cell.traffic)(cell.config, cell.traffic, 2**31 + 3, "cpu", H.Spans())
    driver.setup()
    out = driver.window(0.5, None)
    driver.release()
    assert out["attempted"] >= 2 and set(driver.calls) == {"first", "last"}
    assert all(st["step"] > 0 and st["epoch"] > 0 for st in driver.calls["last"]["start"].values())
    got = driver.check()["readings"]
    for call in ("first", "last"):
        assert max(got[call].values()) < 1e-4, (call, got[call])


@pytest.mark.parametrize("workload", ["prefix", "qwen2moe-sched"])
def test_serving_reference_agrees_with_the_served_tokens(workload):
    """A float32 model; the scheduler's KV cache stays bf16 whatever the
    model's type: a served token can lose a near tie by ~1e-4 (dense) and,
    where that flips a routing choice, by ~0.06 (one token of ~80, MoE).
    Both gaps are held far under the cells' limits."""
    tol = 1e-2
    res = run_cell(tiny_cell(workload, "float32"), 2**31 + 12345, 0.5, False, "cpu", 0.0)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    for name, c in res["checks"].items():
        assert c["value"] < tol, (name, c)
