"""The port's launch tooling (``repro_torch.launch.{shapes,flops,roofline}``)
against the reference's, on the CPU.

Shapes and the analytic model FLOPs are copies: equal to the reference's
exactly, for every registered arch, every registry shape and every step.
The roofline takes the H100's constants; its record analysis and markdown
equal the reference's with the reference's module constants set to the
port's for the comparison (``monkeypatch``; the reference file is not
touched).
"""

import json

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import list_archs as j_list_archs  # noqa: E402
from repro.launch import flops as JF  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import list_archs as t_list_archs  # noqa: E402
from repro_torch.launch import flops as TF  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch import shapes as TS  # noqa: E402

ARCHS = j_list_archs()
STEPS = ("train", "finetune_populate", "finetune_cached", "prefill", "decode")


def test_archs_and_shape_table_equal():
    assert t_list_archs() == ARCHS
    assert list(TS.SHAPES) == list(JS.SHAPES)
    for name, cell in JS.SHAPES.items():
        got = TS.SHAPES[name]
        assert (got.name, got.kind, got.seq, got.batch) == (cell.name, cell.kind, cell.seq, cell.batch)
    assert TS.all_cells() == JS.all_cells()
    assert TS.live_cells() == JS.live_cells()
    assert len(TS.all_cells()) == 40 and len(TS.live_cells()) == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_supported_equal(arch):
    for shape in JS.SHAPES:
        assert TS.cell_supported(arch, shape) == JS.cell_supported(arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal(arch):
    jc, tc = j_get_config(arch), t_get_config(arch)
    for shape in list(JS.SHAPES) + [(8, 128), (4, 160)]:
        for step in STEPS:
            assert TF.model_flops(tc, shape, step) == JF.model_flops(jc, shape, step), (shape, step)
    with pytest.raises(ValueError):
        TF.model_flops(tc, (1, 8), "sample")


@pytest.mark.parametrize("arch", ARCHS)
def test_reuse_saved_and_readout_flops_equal(arch):
    jc, tc = j_get_config(arch), t_get_config(arch)
    for tokens in (0, 1, 448, 4096):
        assert TF.reuse_saved_flops(tc, tokens) == JF.reuse_saved_flops(jc, tokens)
        assert TF.readout_flops(tc, float(tokens)) == JF.readout_flops(jc, float(tokens))


def test_constants_are_the_h100_data_sheet():
    assert TR.PEAK_FLOPS == 989e12
    assert TR.PEAK_FLOPS_FP32 == 67e12
    assert TR.HBM_BW == 3.35e12
    assert TR.NVLINK_BW == 450e9
    assert not hasattr(TR, "ICI_BW")
    assert TR.mfu(989e12, 1.0) == 1.0 and TR.mfu(67e12, 0.5, peak=TR.PEAK_FLOPS_FP32) == 2.0
    assert TR.mfu(1.0, 0.0) == 0.0


RECORDS = [
    {"arch": "stablelm-1.6b", "shape": "train_4k", "step": "train", "mesh": "1", "chips": 1,
     "dot_flops": 6.1e16, "bytes_accessed": 2.0e12, "collective_bytes": 0.0},
    {"arch": "gemma2-9b", "shape": "decode_32k", "step": "decode", "mesh": "4", "chips": 4,
     "dot_flops": 1.2e12, "bytes_accessed": 9.0e11, "collective_bytes": 3.0e9},
    {"arch": "qwen2-moe-a2.7b", "shape": "prefill_32k", "step": "prefill", "mesh": "4", "chips": 4,
     "dot_flops": 2.0e15, "bytes_accessed": 1.0e12, "collective_bytes": 6.0e11},
    {"arch": "xlstm-350m", "shape": "long_500k", "step": "decode", "mesh": "1", "chips": 1,
     "error": "lowering failed: synthetic"},
]


@pytest.fixture
def reference_at_h100(monkeypatch):
    monkeypatch.setattr(JR, "PEAK_FLOPS", TR.PEAK_FLOPS)
    monkeypatch.setattr(JR, "HBM_BW", TR.HBM_BW)
    monkeypatch.setattr(JR, "ICI_BW", TR.NVLINK_BW)
    return JR


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_analyze_record_equal(reference_at_h100, i):
    got, want = TR.analyze_record(RECORDS[i]), reference_at_h100.analyze_record(RECORDS[i])
    assert got == want
    if "error" not in got:
        assert got["dominant"] in TR.MOVE_HINTS and got["step_time_s"] > 0


def test_markdown_and_cli_equal(reference_at_h100, tmp_path, capsys):
    rows_t = [TR.analyze_record(r) for r in RECORDS]
    rows_j = [reference_at_h100.analyze_record(r) for r in RECORDS]
    assert TR.to_markdown(rows_t) == reference_at_h100.to_markdown(rows_j)
    assert TR.MOVE_HINTS == reference_at_h100.MOVE_HINTS
    path, out = tmp_path / "records.json", tmp_path / "rows.json"
    path.write_text(json.dumps(RECORDS))
    TR.main(["--in", str(path), "--md", "--out", str(out), "--mesh", "4"])
    printed = capsys.readouterr().out
    assert printed.strip() == TR.to_markdown([r for r in rows_t if r.get("mesh") == "4"]).strip()
    assert json.loads(out.read_text()) == [r for r in rows_t if r.get("mesh") == "4"]
    with pytest.raises(SystemExit):
        TR.main([])   # --in has no default: the reference's default holds TPU records
