"""The PyTorch port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch`` or ``chip_smoke.py``, checked at run time and in the
source."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^(jax|jaxlib|repro)(\.|$)")


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(mods) > 25, mods\n"
        "for m in ('repro_torch.launch.finetune', 'repro_torch.kernels.flash_attn.ops',\n"
        "          'repro_torch.core.skip_cache', 'repro_torch.optim.optimizers',\n"
        "          'repro_torch.data.pipeline', 'repro_torch.kernels.build',\n"
        "          'repro_torch.kernels.skip_lora.quant', 'repro_torch.core.batch_plan',\n"
        "          'repro_torch.core.fleet_finetune', 'repro_torch.launch.fleet'):\n"
        "    assert m in mods, m\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # module paths handed to importlib
            if re.fullmatch(r"[\w.]+", node.value):
                names.append(node.value)
    bad = [n for n in names if FORBIDDEN.match(n)]
    assert not bad, f"{path}: {bad}"
