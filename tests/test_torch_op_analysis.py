"""``repro_torch.launch.op_analysis`` (the twin of the reference's
``hlo_analysis``) on the CPU and the meta device: a loop of N matrix
products counts N x 2MNK (the reference's loop multiplier, for free);
``tp.reduce`` over two CPU members counts the reference's all-reduce
traffic (2x the summed tensor's bytes) and the vocabulary gather an
all-gather of the gathered tensor's; ops are attributed to the member whose
loop issues them; peak live bytes follow a known sequence of allocations
and frees; a sampled recurrent loop counts what the whole loop counts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("n", [1, 7])
def test_a_loop_of_matmuls_counts_every_iteration(n, device):
    m, k, p = 8, 16, 4
    a, b = torch.ones((m, k), device=device), torch.ones((k, p), device=device)
    with OA.OpCounter() as c:
        for _ in range(n):
            y = a @ b
        z = torch.einsum("bik,bkj->bij", a[None].expand(3, m, k), b[None].expand(3, k, p))
    assert c.home.dot_flops == n * 2 * m * k * p + 3 * 2 * m * k * p
    assert c.home.bytes_accessed >= n * 4 * (m * k + k * p + m * p)
    assert y.shape == (m, p) and z.shape == (3, m, p)


def test_collectives_follow_the_reference_conventions():
    assert OA.collective_bytes("all-reduce", 100) == 200.0
    assert OA.collective_bytes("all-gather", 100) == 100.0
    with pytest.raises(ValueError):
        OA.collective_bytes("broadcast", 1)
    parts = [torch.ones((4, 8)), 2 * torch.ones((4, 8))]
    with OA.OpCounter() as c:
        out = TP.reduce(parts, torch.device("cpu"))
        g = TP.gather(parts, torch.device("cpu"))
        c.add_collective("reduce-scatter", 64)
    assert torch.equal(out, 3 * torch.ones((4, 8))) and g.shape == (4, 16)
    stats = c.collectives()
    assert stats.per_op_bytes == {"all-reduce": 2 * 4 * 8 * 4, "all-gather": 4 * 16 * 4, "reduce-scatter": 64}
    assert stats.count == 3 and stats.total_bytes == 256 + 256 + 64
    assert stats.as_dict()["count"] == 3
    # nothing is told outside a counter
    TP.reduce(parts, torch.device("cpu"))
    assert c.collectives().count == 3


def test_members_are_attributed_and_a_group_ffn_splits_its_flops():
    cfg = reduce_config(get_config("stablelm-1.6b"))
    params = TL.init_lm(torch.Generator().manual_seed(0), cfg)
    gp = TP.group_params(params, ["cpu", "cpu"])
    z = torch.randn((2, 5, cfg.d_model))
    with OA.OpCounter() as c:
        with TP.as_member(1):
            torch.ones((3, 3)) @ torch.ones((3, 3))
    assert c.members[1].dot_flops == 54 and c.home.dot_flops == 0
    assert TP.current_member() == 0
    with OA.OpCounter() as c:
        TP.ffn(gp["stack"][0]["ffn"], z, act=cfg.ffn_activation, gated=cfg.ffn_gated)
    n_mats = 3 if cfg.ffn_gated else 2
    one = 2 * 10 * cfg.d_model * (cfg.d_ff // 2) * n_mats
    assert c.members[0].dot_flops == c.members[1].dot_flops == one
    assert c.collectives().per_op_bytes == {"all-reduce": 2 * 10 * cfg.d_model * 4}
    # the backward of a member's products is that member's: dX and dW each
    zg = z.clone().requires_grad_(True)
    with OA.OpCounter() as c:
        y = TP.ffn(gp["stack"][0]["ffn"], zg, act=cfg.ffn_activation, gated=cfg.ffn_gated)
        torch.autograd.grad(y.sum(), zg)
    assert c.members[1].dot_flops == c.members[0].dot_flops == 2 * one   # forward + dX (weights frozen)


def test_peak_live_bytes_of_a_known_sequence():
    with OA.OpCounter() as c:
        a = torch.empty(1000, device="meta")          # 4000 live
        b = torch.empty(2000, device="meta")          # 12000
        v = a[10:]                                    # a view: no new storage
        del a                                         # the view keeps a's storage
        cc = torch.empty(500, device="meta")          # 14000: the peak
        del v                                         # 10000
        d = b + 1                                     # 18000: the new peak
        del b, cc, d
    assert c.home.peak_bytes == 18000 and c.home.live_bytes == 0
    assert c.peak_all == 18000


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_a_sampled_time_loop_counts_the_whole_loop(kind):
    cfg = reduce_config(get_config("xlstm-350m" if kind != "mamba" else "jamba-1.5-large-398b"))
    layer = next(p for p in TL.param_shapes(cfg)["stack"] if kind in p)[kind]
    seq = {"mamba": S.mamba_seq, "mlstm": S.mlstm_seq, "slstm": S.slstm_seq}[kind]
    x = torch.empty((2, 33, cfg.d_model), device="meta")
    counts = []
    for sample in (False, True):
        (y, _), c = OA.count(lambda: seq(layer, x, cfg), sample_loops=sample)
        assert y.shape == x.shape
        counts.append((c.home.dot_flops, c.home.flops, c.home.bytes_accessed, c.ops, c.home.peak_bytes))
    exact, sampled = counts
    # the two cut runs issue 2 + 3 of the 33 steps (and twice what lies
    # outside the loop)
    assert sampled[:3] == exact[:3] and sampled[3] < exact[3] / 3
    assert sampled[4] == exact[4]
    assert S._LOOP_SAMPLE.get() is None
