"""Build and bind the port's hand-written CUDA kernels.

Every kernel is a CUDA C++ source under some package's ``csrc/`` with a
plain C interface. ``nvcc`` compiles each source for ``sm_90a`` into its own
shared library, which ``ctypes`` loads. A ``KernelLib`` describes one
package's kernels (name -> source, C argument types) and owns their launch
counts.

Libraries are built from the sources in the checkout at first use, into
``build/repro_torch/`` at the repository root, and named by a hash of their
source, every header in the same ``csrc/`` and in the shared
``kernels/csrc/`` (on the include path), and the compiler flags, so an
edited source is rebuilt. ``build_all`` starts one ``nvcc`` per source, all
together. Nothing is built or loaded at import time: the modules import on a
machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: headers shared by every package's kernels (``numerics.cuh``)
SHARED_CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(SHARED_CSRC),
]

P = ctypes.c_void_p
I = ctypes.c_int  # noqa: E741
F = ctypes.c_float


class KernelLib:
    """The kernels of one ``csrc/`` directory.

    ``sources`` maps kernel name (also the C symbol) to its ``.cu`` file;
    ``argtypes`` maps it to the C argument types, each pointer and the
    stream as ``P``. ``launches`` counts each wrapper's launches since the
    last ``reset_launches()``."""

    def __init__(self, csrc: Path, sources: dict[str, str], argtypes: dict[str, list]):
        self.csrc = csrc
        self.sources = dict(sources)
        self.argtypes = dict(argtypes)
        self.launches = {name: 0 for name in sources}
        self._fns: dict[str, ctypes._CFuncPtr] = {}

    def reset_launches(self) -> None:
        for name in self.launches:
            self.launches[name] = 0

    def lib_path(self, name: str) -> Path:
        # The flags without the include path, which names the checkout's location.
        h = hashlib.sha256(" ".join(NVCC_FLAGS[:-2]).encode())
        h.update((self.csrc / self.sources[name]).read_bytes())
        for header in sorted(self.csrc.glob("*.cuh")) + sorted(SHARED_CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"

    def build(self, names=None) -> dict[str, str]:
        return build_all([(self, names)])

    def fn(self, name: str):
        """The kernel's C entry point, built and loaded at first use."""
        fn = self._fns.get(name)
        if fn is None:
            self.build([name])
            fn = getattr(ctypes.CDLL(str(self.lib_path(name))), name)
            fn.argtypes = self.argtypes[name]
            fn.restype = ctypes.c_int
            self._fns[name] = fn
        return fn

    def launch(self, name: str, x: torch.Tensor, *args) -> None:
        """Call kernel ``name`` on ``x``'s device and current stream, raise
        on a nonzero CUDA error code, and count the launch."""
        check(x.is_cuda, f"{name}: tensors must be on a CUDA device, not {x.device}")
        fn = self.fn(name)
        with torch.cuda.device(x.device):
            stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
            rc = fn(*args, stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")
        self.launches[name] += 1


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def build_all(libs) -> dict[str, str]:
    """Compile the named kernels of each ``(lib, names or None for all)``
    pair that are not built yet, one ``nvcc`` process per source, all
    started together. Returns each built kernel's compiler output
    (``-Xptxas -v``: registers, shared memory, spills); raises RuntimeError
    if any compile fails."""
    todo = [
        (lib, name)
        for lib, names in libs
        for name in (names or lib.sources)
        if not lib.lib_path(name).exists()
    ]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for lib, name in todo:
        out = lib.lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(lib.csrc / lib.sources[name])]
        procs[name] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (tmp, out, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        detail = "\n".join(f"--- {n}\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


# ---------------------------------------------------------------------------
# Argument checks shared by the launch wrappers
# ---------------------------------------------------------------------------


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensor(t: torch.Tensor, name: str, device, shape, dtypes) -> None:
    """``t`` must be contiguous on ``device`` with ``shape`` and a dtype in
    ``dtypes``."""
    check(t.device == device and t.is_contiguous(), f"{name} must be contiguous on {device}")
    check(tuple(t.shape) == tuple(shape), f"{name} {tuple(t.shape)} != {tuple(shape)}")
    check(t.dtype in dtypes, f"{name} dtype {t.dtype} not in {dtypes}")
