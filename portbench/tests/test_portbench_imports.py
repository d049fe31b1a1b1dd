"""No module the benchmark loads is JAX or the JAX package: each top-level
name compared whole, so that ``repro_torch`` passes and ``repro`` fails."""

from __future__ import annotations

import subprocess
import sys

from portbench import harness as H

SCRIPT = r"""
import importlib, pkgutil, sys
sys.path.insert(0, "src")
import portbench
from portbench import harness as H
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if not m.name.startswith("portbench.tests"):
        importlib.import_module(m.name)
for p in sorted((H.HERE / "metrics").glob("*.py")):
    H.metric_reader(p.stem)
import repro_torch.core.runtime, repro_torch.core.scheduler, repro_torch.models.moe
import repro_torch.kernels.skip_lora.ops
print("forbidden:" + ",".join(H.forbidden_modules()))
"""


def test_no_jax_and_no_reference_package_is_loaded():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=H.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden:"


def test_names_are_compared_whole():
    assert "repro" in H.FORBIDDEN and "repro_torch" not in H.FORBIDDEN
    mods = set(sys.modules)
    sys.modules["repro_torch_probe_only"] = sys.modules[__name__]
    try:
        assert "repro_torch_probe_only" not in H.forbidden_modules()
    finally:
        del sys.modules["repro_torch_probe_only"]
    assert set(sys.modules) == mods
