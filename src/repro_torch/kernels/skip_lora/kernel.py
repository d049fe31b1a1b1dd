"""Hopper CUDA kernels for the grouped Skip-LoRA forward, and their build.

Two kernels, each a CUDA C++ source under ``csrc/`` with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into a shared library and
bound with ``ctypes``:

  - ``grouped_skip_sum_fwd`` (float pool) replaces
    ``repro/kernels/skip_lora/kernel.py::skip_lora_grouped_fwd``;
  - ``grouped_skip_sum_fwd_int8`` (int8 pool) replaces
    ``repro/kernels/skip_lora/kernel.py::skip_lora_grouped_fwd_int8``.

The libraries are built from the sources in the checkout at first use,
into ``build/repro_torch/`` at the repository root (one ``nvcc`` per source,
started together), and named by a hash of their sources and flags, so an
edited source is rebuilt. Nothing is built or loaded at import time: the
module imports on a machine with no CUDA toolkit.

Each launch function checks devices, types, shapes and contiguity, launches
on the current stream, raises on a nonzero CUDA error code, and counts its
launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
#: kernel name -> its source file under csrc/ (each includes the shared header)
SOURCES = {
    "grouped_skip_sum_fwd": "grouped_skip_sum_fwd.cu",
    "grouped_skip_sum_fwd_int8": "grouped_skip_sum_fwd_int8.cu",
}
_HEADERS = ("grouped_skip_sum.cuh",)

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {name: 0 for name in SOURCES}
#: most rows in one tile and highest rank the kernels take (grouped_skip_sum.cuh)
TM_MAX = 32
R_MAX = 64

_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "grouped_skip_sum_fwd": [_P] * 7 + [_I] * 8 + [_P],
    "grouped_skip_sum_fwd_int8": [_P] * 9 + [_I] * 7 + [_P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together. Returns each built
    kernel's compiler output (``-Xptxas -v``: registers, shared memory,
    spills); raises RuntimeError if any compile fails."""
    todo = [n for n in (names or SOURCES) if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        detail = "\n".join(f"--- {n}\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_plan(x, row_src, tile_slot, tm):
    lnum, m, d = x.shape
    _check(x.is_cuda and x.is_contiguous(), "x must be a contiguous CUDA tensor")
    _check(x.dtype in (torch.float32, torch.bfloat16), f"x dtype {x.dtype} not fp32/bf16")
    _check(1 <= tm <= TM_MAX, f"row tile {tm} outside 1..{TM_MAX}")
    n_tiles = tile_slot.shape[0]
    for t, name in ((row_src, "row_src"), (tile_slot, "tile_slot")):
        _check(t.dtype == torch.int32 and t.is_contiguous() and t.device == x.device,
               f"{name} must be contiguous int32 on {x.device}")
    _check(row_src.shape == (n_tiles * tm,), f"row_src {tuple(row_src.shape)} != ({n_tiles * tm},)")
    _check(n_tiles >= 1 and m >= 1, "empty batch")
    return lnum, m, d, n_tiles


def _check_pool(x, t, shape, dtypes, name):
    _check(t.device == x.device and t.is_contiguous(), f"{name} must be contiguous on {x.device}")
    _check(tuple(t.shape) == shape, f"{name} {tuple(t.shape)} != {shape}")
    _check(t.dtype in dtypes, f"{name} dtype {t.dtype} not in {dtypes}")


def _stream(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")


def grouped_skip_sum_fwd(
    x: torch.Tensor,          # (L, M, D) fp32 / bf16, original row order
    a_pool: torch.Tensor,     # (N, L, D, R) fp32 / bf16
    b_pool: torch.Tensor,     # (N, L, R, D), same dtype as a_pool
    row_src: torch.Tensor,    # (n_tiles * tm,) int32 original row or -1
    tile_slot: torch.Tensor,  # (n_tiles,) int32
    tm: int,
) -> torch.Tensor:
    """Float-pool grouped skip-sum on the card -> (M, D) in x.dtype."""
    lnum, m, d, n_tiles = _check_plan(x, row_src, tile_slot, tm)
    n, _, _, r = a_pool.shape
    _check(1 <= r <= R_MAX, f"rank {r} outside 1..{R_MAX}")
    fdt = (torch.float32, torch.bfloat16)
    _check_pool(x, a_pool, (n, lnum, d, r), fdt, "a_pool")
    _check_pool(x, b_pool, (n, lnum, r, d), (a_pool.dtype,), "b_pool")
    z = torch.empty((lnum, n_tiles * tm, r), dtype=torch.float32, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    fn = _lib("grouped_skip_sum_fwd").grouped_skip_sum_fwd
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), a_pool.data_ptr(), b_pool.data_ptr(), row_src.data_ptr(),
            tile_slot.data_ptr(), z.data_ptr(), out.data_ptr(),
            lnum, m, d, r, tm, n_tiles,
            int(x.dtype == torch.bfloat16), int(a_pool.dtype == torch.bfloat16), _stream(x),
        )
    _raise_on(rc, "grouped_skip_sum_fwd")
    LAUNCHES["grouped_skip_sum_fwd"] += 1
    return out


def grouped_skip_sum_fwd_int8(
    x: torch.Tensor,          # (L, M, D) fp32 / bf16, original row order
    qa: torch.Tensor,         # (N, L, D, R) int8
    sa: torch.Tensor,         # (N, L, D) fp32
    qb: torch.Tensor,         # (N, L, R, D) int8
    sb: torch.Tensor,         # (N, L, R) fp32
    row_src: torch.Tensor,
    tile_slot: torch.Tensor,
    tm: int,
) -> torch.Tensor:
    """int8-pool grouped skip-sum on the card -> (M, D) in x.dtype."""
    lnum, m, d, n_tiles = _check_plan(x, row_src, tile_slot, tm)
    n, _, _, r = qa.shape
    _check(1 <= r <= R_MAX, f"rank {r} outside 1..{R_MAX}")
    i8, f32 = (torch.int8,), (torch.float32,)
    _check_pool(x, qa, (n, lnum, d, r), i8, "qa")
    _check_pool(x, sa, (n, lnum, d), f32, "sa")
    _check_pool(x, qb, (n, lnum, r, d), i8, "qb")
    _check_pool(x, sb, (n, lnum, r), f32, "sb")
    z = torch.empty((lnum, n_tiles * tm, r), dtype=torch.float32, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    fn = _lib("grouped_skip_sum_fwd_int8").grouped_skip_sum_fwd_int8
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), qa.data_ptr(), sa.data_ptr(), qb.data_ptr(), sb.data_ptr(),
            row_src.data_ptr(), tile_slot.data_ptr(), z.data_ptr(), out.data_ptr(),
            lnum, m, d, r, tm, n_tiles, int(x.dtype == torch.bfloat16), _stream(x),
        )
    _raise_on(rc, "grouped_skip_sum_fwd_int8")
    LAUNCHES["grouped_skip_sum_fwd_int8"] += 1
    return out
