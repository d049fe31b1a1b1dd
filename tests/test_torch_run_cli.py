"""The port's session CLI (``repro_torch.launch.run``) on the CPU, tiny.

  - It runs the reference's event stream (``serve/base``, then each round
    the ingests, ``adapt/r{n}`` and ``serve/mixed/r{n}``) and reports the
    reference's metric names.
  - The crash drill (``--checkpoint-dir D --inject-failure 3``, a
    ``SessionSupervisor`` with a checkpoint at every event boundary) restarts
    exactly once, resumes at event 3, runs every completed event once and the
    failed one twice, and ends with the adapters, optimizer moments, pool and
    slot table of the same CLI run without a checkpoint directory, bitwise;
    so through the scheduler, with the control plane and an int4 pool, over
    a tiered engine.
  - The model-axis flags exit naming slice 7b, and the data-axis flags that
    do not fit together exit with a message (the data axis itself runs in
    ``tests/test_torch_session_shard.py``); ``--unroll 2`` (decode steps per
    CUDA-graph replay on the card) runs the same stream."""

import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import run  # noqa: E402

TINY = ["--device", "cpu", "--tenants", "2", "--rounds", "2", "--samples-per-round", "2", "--seq", "8",
        "--prompt-len", "6", "--gen", "4", "--rank", "4", "--batch-per-tenant", "2"]
LABELS = ["serve/base", "ingest/tenant-0/r0", "ingest/tenant-1/r0", "adapt/r0", "serve/mixed/r0",
          "ingest/tenant-0/r1", "ingest/tenant-1/r1", "adapt/r1", "serve/mixed/r1"]


def test_runs_the_reference_event_stream(tmp_path, capsys):
    out = tmp_path / "m.json"
    metrics = run.main([*TINY, "--json", str(out)])
    printed = [line.split()[0] for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert [p for p in printed if p in LABELS] == LABELS
    saved = json.loads(out.read_text())
    assert "runtime" not in saved and saved["session/devices"] == 1.0 and saved["session/shards"] == 1.0
    for k in ("time/serve_s", "time/ingest_s", "time/adapt_s", "session/tenants_per_s", "session/wall_s",
              "session/model_parallel", "session/pipeline_stages", "session/backbone_bytes_total",
              "session/backbone_bytes_per_device_peak", "runtime/ingest/rows", "runtime/adapt/epochs",
              "cache_engine/hbm_hit_rate", "adapter_pool/registrations"):
        assert k in saved, k
    assert saved["runtime/ingest/rows"] == 8 and saved["runtime/adapt/epochs"] == 2
    assert saved["runtime/serve/single/base"] == 1 and saved["runtime/serve/grouped/float"] == 2
    assert saved["session/backbone_bytes_total"] == saved["session/backbone_bytes_per_device_peak"] > 0
    rt = metrics["runtime"]
    assert sorted(rt.pool.pinned()) == ["tenant-0", "tenant-1"] and rt.tenant("tenant-0").n_ingested == 4


@pytest.mark.parametrize("extra", [
    [],
    ["--scheduler", "--control", "--pool-compress", "int4", "--hbm-mb", "0.01"],
], ids=["plain", "scheduler-control-int4-tiered"])
def test_crash_drill_restarts_once_and_matches_the_unsupervised_run(tmp_path, capsys, extra):
    plain = run.main([*TINY, *extra])["runtime"]
    sup = run.main([*TINY, *extra, "--checkpoint-dir", str(tmp_path / "ck"), "--inject-failure", "3"])
    assert "1 restarts, resumed at event 3" in capsys.readouterr().out
    info = sup["supervisor"]
    assert info["restarts"] == 1 and info["resumed_at"] == 3
    assert info["executions"] == [1, 1, 1, 2, 1, 1, 1, 1, 1]
    rt = sup["runtime"]
    for t in ("tenant-0", "tenant-1"):
        for name in ("adapters", "opt_mu", "opt_nu"):
            for k in ("A", "B"):
                assert torch.equal(getattr(rt.tenant(t), name)[k], getattr(plain.tenant(t), name)[k]), (t, name, k)
    assert rt.pool.slot_table() == plain.pool.slot_table()
    assert all(torch.equal(v, plain.pool.pools()[k]) for k, v in rt.pool.pools().items())
    if extra:
        assert rt.control_metrics() == plain.control_metrics()
        assert rt.engine.capacity < rt.engine.num_samples and rt.pool.compress == "int4"


@pytest.mark.parametrize("flags,slice_", [
    (["--devices", "3"], "must divide over 3 shards"),
    (["--mesh", "1x2", "--use-kernel"], "do not run over a model axis"),
    (["--pipeline-stages", "2"], "must equal M"),
    (["--mesh", "1x2", "--pipeline-stages", "2"], "add --scheduler"),
    (["--mesh", "2x2", "--pipeline-stages", "3", "--scheduler"], "must equal M"),
    (["--mesh", "1x2", "--checkpoint-dir", "ck"], "not supported with --mesh M > 1"),
    (["--mesh", "2xa"], "--mesh wants DxM"),
    (["--shards", "3"], "must divide over 3 shards"),
    (["--check-parity"], "1-device twin"),
    (["--elastic-devices", "1"], "requires --checkpoint-dir and --inject-failure"),
    (["--inject-failure", "3"], "requires --checkpoint-dir"),
])
def test_unported_flags_exit_naming_their_slice(flags, slice_):
    with pytest.raises(SystemExit, match=slice_):
        run.main([*TINY, *flags])


def test_unroll_runs_the_same_stream(capsys):
    """``--unroll 2`` serves through ``decode_scan(unroll=2)``: the same
    event stream, and the same session state at its end, as ``--unroll 1``."""
    one = run.main(TINY)["runtime"]
    two = run.main([*TINY, "--unroll", "2"])["runtime"]
    printed = [line.split()[0] for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert [p for p in printed if p in LABELS] == LABELS * 2
    assert two.counters == one.counters and two.pool.slot_table() == one.pool.slot_table()
    assert all(torch.equal(v, one.pool.pools()[k]) for k, v in two.pool.pools().items())
    with pytest.raises(SystemExit, match="unroll"):
        run.main([*TINY, "--unroll", "0"])
