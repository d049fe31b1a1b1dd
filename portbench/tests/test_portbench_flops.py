"""The frozen counts against values worked by hand at the cells' shapes."""

from __future__ import annotations

from portbench import flops as FL
from portbench import harness as H


def _cfg(name):
    return H.read_json(H.HERE / "configs" / f"{name}.json")


def test_readout_at_the_adapt_step():
    # M = 16 tenants x 2 rows x 128 tokens = 4096; two products of 2 M D V
    # (launch/flops.py counts three, as the reference's rematerialisation does)
    assert FL.readout_train_flops(_cfg("stablelm-1.6b"), 4096) == 2 * (2 * 4096 * 2048 * 100352)


def test_cached_step():
    cfg = _cfg("stablelm-1.6b")
    skip = 4 * 4096 * 24 * 2048 * 8                      # x A and (x A) B, every layer
    assert FL.cached_step_flops(cfg, 4096, 8) == 2 * (2 * 4096 * 2048 * 100352) + skip * 5 // 2


def test_layer_weights_per_token():
    s = _cfg("stablelm-1.6b")
    assert FL.layer_params_per_token(s) == 4 * 2048 * 2048 + 3 * 2048 * 5632
    q = _cfg("qwen2-moe-a2.7b")
    assert FL.layer_params_per_token(q) == 4 * 2048 * 2048 + 2048 * 60 + 4 * 3 * 2048 * 1408 + 3 * 2048 * 5632


def test_forward_counts_causal_pairs():
    s = _cfg("stablelm-1.6b")
    per_token = 2 * FL.layer_params_per_token(s)
    pairs = 128 * 129 // 2
    assert FL.forward_flops(s, 1, 128) == 24 * (128 * per_token + 4 * 32 * 64 * pairs)


def test_decode_token():
    q = _cfg("qwen2-moe-a2.7b")
    want = 24 * (2 * FL.layer_params_per_token(q) + 4 * 16 * 128 * 300) + 2 * 2048 * 151936 + 4 * 24 * 2048 * 8
    assert FL.decode_flops(q, 300, 8, True) == want


def test_moe_bytes_and_skipsum_bytes():
    q = _cfg("qwen2-moe-a2.7b")
    assert FL.moe_bytes(q, 32, 60) == 2048 * 60 * 4 + (60 * 3 * 2048 * 1408 + 3 * 2048 * 5632) * 2 + 2 * 32 * 2048 * 2
    s = _cfg("stablelm-1.6b")
    acts = 24 * 4096 * 2048 * 2
    assert FL.skipsum_train_bytes(s, 4096, 16, 8) == acts + 2 * 4096 * 2048 * 2 + 4 * 16 * 24 * 2048 * 8 * 4


def test_roofline_share_takes_the_larger_bound():
    assert FL.roofline_share(0, int(3.35e12), 2.0, FL.PEAK_BF16) == 50.0
    assert abs(FL.roofline_share(int(67e12), 0, 1.0, FL.PEAK_FP32) - 100.0) < 1e-9
