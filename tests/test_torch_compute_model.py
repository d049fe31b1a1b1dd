"""The port's cost model (``repro_torch.core.compute_model``) against the
reference's, exactly: the same FLOPs for every method, dims, phase and
cache hit rate, the same trainable-parameter counts and layer types."""

import pytest

pytest.importorskip("torch")

from repro.core import compute_model as ref  # noqa: E402
from repro_torch.core import compute_model as cm  # noqa: E402
from repro_torch.core.methods import METHODS  # noqa: E402

DIMS = {"fan": (256, 96, 96, 3), "har": (561, 96, 96, 6), "test": (32, 24, 24, 3)}
HITS = (0.0, 0.5, ref.expected_hit_rate(300), 1.0)


@pytest.mark.parametrize("dims", list(DIMS))
@pytest.mark.parametrize("method", METHODS)
def test_method_cost_equals_the_reference(method, dims):
    for batch in (1, 20):
        for rank in (1, 4):
            for bn in (True, False):
                for hit in HITS:
                    got = cm.method_cost(method, batch, DIMS[dims], rank, bn=bn, cache_hit_rate=hit)
                    want = ref.method_cost(method, batch, DIMS[dims], rank, bn=bn, cache_hit_rate=hit)
                    assert (got.forward, got.backward, got.update) == (want.forward, want.backward, want.update)
                    assert got.total == want.total
    assert cm.trainable_param_count(method, DIMS[dims], 4) == ref.trainable_param_count(method, DIMS[dims], 4)


@pytest.mark.parametrize("method", METHODS)
def test_layer_types_equal_the_reference(method):
    for n in (2, 3, 5):
        fcs, loras = cm.method_layer_types(method, n)
        rfcs, rloras = ref.method_layer_types(method, n)
        assert [t.value for t in fcs] == [t.value for t in rfcs]
        assert [t.value for t in loras] == [t.value for t in rloras]


def test_closed_forms_and_hit_rates_equal_the_reference():
    for t in cm.FCType:
        assert cm.fc_cost(t, 20, 256, 96) == cm.LayerCost(*_fields(ref.fc_cost(ref.FCType(t.value), 20, 256, 96)))
    for t in cm.LoRAType:
        got = cm.lora_cost(t, 20, 256, 96, 4)
        assert _fields(got) == _fields(ref.lora_cost(ref.LoRAType(t.value), 20, 256, 96, 4))
    for trainable in (True, False):
        for gx in (True, False):
            assert _fields(cm.bn_cost(20, 96, trainable, gx)) == _fields(ref.bn_cost(20, 96, trainable, gx))
            assert _fields(cm.act_cost(20, 96, gx)) == _fields(ref.act_cost(20, 96, gx))
    for e in (0, 1, 40, 300, 600):
        assert cm.expected_hit_rate(e) == ref.expected_hit_rate(e)
    with pytest.raises(ValueError):
        cm.method_cost("nope", 20, DIMS["fan"], 4)


def _fields(c):
    return (c.forward, c.backward, c.update)


def test_skip2_costs_less_than_lora_all_as_predicted():
    """The reduction the paper's setup predicts (batch 20, rank 4, Fan at 300
    epochs, HAR at 600): Skip2-LoRA's FLOPs over LoRA-All's."""
    for dims, epochs, want in (("fan", 300, 0.924), ("har", 600, 0.922)):
        skip2 = cm.method_cost("skip2_lora", 20, DIMS[dims], 4, cache_hit_rate=cm.expected_hit_rate(epochs))
        lora_all = cm.method_cost("lora_all", 20, DIMS[dims], 4)
        assert round(1 - skip2.total / lora_all.total, 3) == want
