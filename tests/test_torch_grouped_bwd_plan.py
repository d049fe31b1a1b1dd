"""What K9's tensor-core route takes from its wrapper, checked on the CPU.

The bf16 route of ``grouped_skip_sum_bwd`` keeps z and gz in a bf16
scratch whose width is R padded to a power-of-two number of 8-wide mma
n-tiles (``kernel.bwd_scratch_rank``), and its second pass walks each slot's
run of grouped positions, found from the non-decreasing ``tile_slot`` of
``ops._plan``, 16 positions at a time. These tests hold the width helper to
its definition, and a plain model of that walk (fp32 sums, z and gz rounded
to bf16 where the reference rounds them) to the plain version
``skip_lora_grouped_bwd_ref``, for every row tile the kernels take."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.skip_lora import kernel as K  # noqa: E402
from repro_torch.kernels.skip_lora import ops  # noqa: E402
from repro_torch.kernels.skip_lora import ref as R  # noqa: E402

GROUPS = [(2, 0, 19, 1, 33), (1,), (0, 0, 40), (64, 0, 3), (40, 0, 77, 0, 5, 130)]


@pytest.mark.parametrize("r", [1, 4, 7, 8, 9, 16, 17, 24, 32, 33, 48, 64])
def test_scratch_width_is_rank_padded_to_whole_mma_tiles(r):
    width = K.bwd_scratch_rank(r, torch.bfloat16)
    tiles = width // 8
    assert width % 8 == 0 and width >= r and tiles & (tiles - 1) == 0
    assert width < 2 * max(r, 8)                     # the least such width
    assert K.bwd_scratch_rank(r, torch.float32) == r  # the fp32 route keeps R


def _slot_runs(tile_slot: torch.Tensor, n: int, tm: int):
    """Each slot's grouped positions [t_lo * tm, t_hi * tm), by the lower
    bound in the non-decreasing tile -> slot map, as the kernel's pass 2
    finds them."""
    ts = tile_slot.long()
    lo = torch.searchsorted(ts, torch.arange(n), right=False)
    hi = torch.searchsorted(ts, torch.arange(n), right=True)
    return [(int(a) * tm, int(b) * tm) for a, b in zip(lo, hi)]


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("tm", [1, 7, 16, 32])
def test_slot_runs_hold_each_slots_rows_and_nothing_else(groups, tm):
    n, m = len(groups), sum(groups)
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.permutation(np.repeat(np.arange(n), groups)), dtype=torch.int32)
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    assert bool((tile_slot[1:] >= tile_slot[:-1]).all())
    seen = []
    for s, (p_lo, p_hi) in enumerate(_slot_runs(tile_slot, n, tm)):
        rows = row_src[p_lo:p_hi]
        rows = rows[rows >= 0]
        assert sorted(rows.tolist()) == torch.nonzero(idx == s)[:, 0].tolist()
        seen += rows.tolist()
    assert sorted(seen) == list(range(m))


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("tm", [1, 7, 16, 32])
def test_walk_of_the_slot_runs_gives_the_plain_gradients(groups, tm):
    n, m, lnum, d, r = len(groups), sum(groups), 2, 24, 8
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((lnum, m, d)), dtype=torch.float32).to(torch.bfloat16)
    g = torch.as_tensor(rng.standard_normal((m, d)), dtype=torch.float32).to(torch.bfloat16)
    a = torch.as_tensor(rng.standard_normal((n, lnum, d, r)) / d**0.5, dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((n, lnum, r, d)) * 0.1, dtype=torch.float32)
    idx = torch.as_tensor(rng.permutation(np.repeat(np.arange(n), groups)), dtype=torch.int32)
    row_src, tile_slot = ops._plan(idx, n, m, tm)
    m_pad = row_src.shape[0]
    ga = torch.zeros((n, lnum, d, r))
    gb = torch.zeros((n, lnum, r, d))
    for s, (p_lo, p_hi) in enumerate(_slot_runs(tile_slot, n, tm)):
        for p0 in range(p_lo, p_hi, 16):
            pos = torch.arange(p0, min(p0 + 16, p_hi))
            live = pos < m_pad
            rows = row_src[pos[live]]
            rows = rows[rows >= 0].long()
            if not rows.numel():
                continue
            ab = a[s].to(torch.bfloat16).float()
            bb = b[s].to(torch.bfloat16).float()
            xs, gs = x[:, rows].float(), g[rows].float()
            z = torch.einsum("lmd,ldr->lmr", xs, ab).to(torch.bfloat16).float()
            gz = torch.einsum("md,lrd->lmr", gs, bb).to(torch.bfloat16).float()
            ga[s] += torch.einsum("lmd,lmr->ldr", xs, gz)
            gb[s] += torch.einsum("lmr,md->lrd", z, gs)
    wa, wb = R.skip_lora_grouped_bwd_ref(x, a, b, g, idx)
    for got, want in ((ga, wa), (gb, wb)):
        tol = 1e-5 * max(want.abs().max().item(), 1.0)
        assert (got - want).abs().max().item() <= tol
