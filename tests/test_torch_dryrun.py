"""``repro_torch.launch.dryrun`` on the CPU.

  - A production cell (xlstm-350m x long_500k on both meta meshes, through
    the CLI's worker processes): the records have the reference's fields,
    which ``launch.roofline.analyze_record`` reads, and equal the
    in-process run's; ``--out`` feeds ``roofline --in``; ``--all`` skips
    what ``cell_supported`` skips.
  - A recurrent training cell's time loops, counted from two runs cut to 2
    and 3 steps, give the whole loops' counts and peak.
  - Meta counts equal a real CPU run's for the same reduced cells (every
    step kind on one device; train, prefill and decode on a group of two
    CPU members): dot FLOPs, all
    FLOPs, bytes accessed, collective bytes and op counts; on one device the
    argument bytes from the spec trees equal the tensors the run holds.
  - The counted dot FLOPs of a reduced stablelm-1.6b cell against the
    reference's ``hlo_analysis.analyze_dot_flops`` of the same cell's
    compiled HLO on one CPU device, every step kind within 1 %: the
    training kinds' backward replays each period of layers as the
    reference's ``jax.checkpoint`` does (``models.remat``), ``train`` each
    layer's forward products but the FFN's down projection, whose result
    the backward does not read, ``finetune_populate`` the skip-LoRA taps'
    ``x @ A``.

One intra-op thread."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_config as j_reduce_config  # noqa: E402
from repro.launch import hlo_analysis as H  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.shapes import ShapeCell  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402

FIELDS = ("arch", "shape", "step", "mesh", "strategy", "chips", "unrolled", "flops", "dot_flops",
          "bytes_accessed", "collective_bytes", "collective_count", "collectives_per_op",
          "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes", "memory_analysis",
          "build_s", "run_s", "per_member")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_record_feeds_the_roofline(tmp_path, capsys):
    """Two cells in two spawned workers (``--jobs 2``): the records come in
    cell order, the 16x16 one equal to the in-process ``run_cell``'s."""
    out = tmp_path / "records.json"
    recs = D.main(["--arch", "xlstm-350m", "--shape", "long_500k", "--mesh", "both", "--unroll", "--jobs", "2",
                   "--out", str(out)])
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"] and not any("error" in r for r in recs)
    rec = recs[0]
    for f in FIELDS:
        assert f in rec, f
    assert rec["chips"] == 256 and recs[1]["chips"] == 512 and rec["step"] == "decode" and rec["unrolled"]
    assert rec["group"] == 16 and len(rec["per_member"]) == 16 and "note" not in rec
    assert rec["seq_shards"] == 1       # xlstm has no K/V cache to split over 'data'
    assert rec["dot_flops"] > 0 and rec["collective_bytes"] > 0 and rec["argument_size_in_bytes"] > 0
    # xlstm's 4 heads do not divide 16: the mLSTM recurrence runs on the home
    # member, the busiest
    assert rec["dot_flops"] == max(m["dot_flops"] for m in rec["per_member"])
    here = D.run_cell("xlstm-350m", "long_500k", "decode")
    for f in ("dot_flops", "flops", "bytes_accessed", "collective_bytes", "argument_size_in_bytes",
              "temp_size_in_bytes", "ops"):
        assert here[f] == rec[f], f
    assert json.loads(out.read_text()) == json.loads(json.dumps(recs))
    analysed = roofline.analyze_record(rec)
    assert analysed["dominant"] in ("compute", "memory", "collective") and analysed["step_time_s"] > 0
    roofline.main(["--in", str(out), "--md"])
    text = capsys.readouterr().out
    assert "xlstm-350m" in text and "long_500k" in text and "2x16x16" in text
    assert D.default_step_for("train_4k") == "train" and D.default_step_for("long_500k") == "decode"


def test_all_skips_what_cell_supported_skips(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(D, "run_cell", lambda a, s, st, **kw: seen.append((a, s, st, kw["multi_pod"])) or
                        {"arch": a, "shape": s, "step": st, "mesh": "x", "dot_flops": 0.0, "collective_bytes": 0.0,
                         "ops": 0, "build_s": 0, "run_s": 0, "memory_analysis": ""})
    recs = D.main(["--all", "--mesh", "both", "--jobs", "1"])
    assert len(recs) == 64 and len(seen) == 64
    assert {s[3] for s in seen} == {False, True}
    assert ("xlstm-350m", "long_500k", "decode", False) in seen and "SKIP gemma-7b x long_500k" in capsys.readouterr().out


def _small(arch):
    if arch == "xlstm-350m":
        return reduce_config(get_config(arch), n_periods=1)
    return dataclasses.replace(reduce_config(get_config(arch)), vocab_size=128)


CELLS = {"train": ShapeCell("t", "train", 16, 2), "prefill": ShapeCell("p", "prefill", 16, 2),
         "decode": ShapeCell("d", "decode", 16, 2)}


def _cell_for(kind):
    return CELLS[{"finetune_populate": "train", "finetune_cached": "train", "decode_adapted": "decode"}.get(kind, kind)]


@pytest.mark.parametrize("arch,n", [("stablelm-1.6b", 1), ("stablelm-1.6b", 2), ("xlstm-350m", 2)])
def test_meta_counts_equal_a_real_cpu_run(arch, n):
    cfg = _small(arch)
    mesh = SH.make_mesh((1, n), ("data", "model"), devices=["meta"] * n)
    for kind in ST.STEP_KINDS if n == 1 else ("train", "prefill", "decode"):
        cell = _cell_for(kind)
        recs = [D.count_cell(D.prepare_cell(cfg, cell, kind, mesh=mesh, group=[dev] * n))
                for dev in ("meta", "cpu")]
        for f in ("dot_flops", "flops", "bytes_accessed", "collective_bytes", "collective_count", "ops",
                  "argument_size_in_bytes", "output_size_in_bytes"):
            assert recs[0][f] == recs[1][f], (kind, f)
        assert [m["dot_flops"] for m in recs[0]["per_member"]] == [m["dot_flops"] for m in recs[1]["per_member"]]
        if n == 1 and arch == "stablelm-1.6b":
            assert recs[1]["argument_bytes_all_members"] == recs[1]["argument_size_in_bytes"], kind
        if n == 2:
            assert recs[1]["collective_bytes"] > 0


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_sampled_time_loops_count_the_whole_loop(arch):
    """A training cell's time loops counted from the two cut runs
    (``count_cell``'s default) against the whole 8-step loops, forward and
    backward: the same counts, and the same peak here (the peak is
    extrapolated; see ``op_analysis``). Two layers: each recurrent kind of
    the config once, and jamba's attention and MoE."""
    pattern = {"xlstm-350m": ("mlstm", "slstm"), "jamba-1.5-large-398b": ("mamba", "attn")}[arch]
    cfg = dataclasses.replace(reduce_config(get_config(arch), n_periods=1), pattern=pattern, n_layers=2)
    mesh = SH.make_mesh((1, 1), ("data", "model"), devices=["meta"])
    for kind in ("train", "finetune_populate"):
        cell = D.prepare_cell(cfg, ShapeCell("t", "train", 8, 2), kind, mesh=mesh)
        whole, sampled = (D.count_cell(cell, sample_loops=s) for s in (False, True))
        for f in ("dot_flops", "flops", "bytes_accessed", "collective_bytes", "collective_count",
                  "output_size_in_bytes", "temp_size_in_bytes", "peak_bytes_all_members"):
            assert sampled[f] == whole[f], (kind, f)


@pytest.fixture(scope="module")
def hlo_dots():
    """The reference's dot FLOPs of each reduced stablelm cell, from its
    compiled HLO on one CPU device (its get_config / SHAPES patched here)."""
    jcfg = dataclasses.replace(j_reduce_config(j_get_config("stablelm-1.6b")), vocab_size=128)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JST, "get_config", lambda arch: jcfg)
        for kind in ST.STEP_KINDS:
            cell = _cell_for(kind)
            mp.setattr(JST, "SHAPES", {cell.name: JST.ShapeCell(cell.name, cell.kind, cell.seq, cell.batch)})
            fn, args, ins, outs = JST.build_cell("stablelm-1.6b", cell.name, jmesh, kind)
            with jmesh:
                jitted = jax.jit(fn, in_shardings=ins, out_shardings=outs) if outs else jax.jit(fn, in_shardings=ins)
                out[kind] = H.analyze_dot_flops(jitted.lower(*args).compile().as_text())
    return out


@pytest.mark.parametrize("kind", ST.STEP_KINDS)
def test_dot_flops_against_the_reference_hlo(kind, hlo_dots):
    cfg = _small("stablelm-1.6b")
    cell = _cell_for(kind)
    mesh = SH.make_mesh((1, 1), ("data", "model"), devices=["meta"])
    got = D.count_cell(D.prepare_cell(cfg, cell, kind, mesh=mesh))["dot_flops"]
    want = hlo_dots[kind]
    assert abs(got - want) <= 0.01 * want
