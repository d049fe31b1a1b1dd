"""The command's refusals: no card, or a checkout without the program."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from portbench import harness as H

ARGS = ["--workload", "stablelm-adapt", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is of a machine without one")


def test_exits_nonzero_without_a_card(no_card):
    out = subprocess.run([sys.executable, "-m", "portbench.run", *ARGS], cwd=H.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 3 and out.stdout == ""


def test_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(H.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(H.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", *ARGS], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_unknown_workload_is_refused():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "nope", "--seed", "1",
                          "--seconds", "1"], cwd=H.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_every_cell_finds_its_files():
    bench = H.read_json(H.ROOT / "BENCHMARK.json")
    for wl in bench["workloads"]:
        cell = H.load_cell(wl["name"])
        assert H.driver_class(cell.traffic)
        assert cell.per_layer and {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(H.metric_reader(m["name"]))
    for c in bench["configs"]:
        assert H.read_json(H.ROOT / c["file"])["name"] == c["name"]
