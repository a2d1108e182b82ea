"""The MLS field kernel (csrc/mls_field.cu) and the one function the block
step calls for the field: `eval_field`.

`eval_field` takes the kernel path for tensors on a CUDA device and the
plain PyTorch version (ops/mls.py::eval_field) for tensors on the CPU; a
CUDA tensor either launches the kernel or raises — nothing falls back.

The kernel is compiled on first use with nvcc for sm_90a into
`mlsgpu_tpu_torch/_build/libmls_field.so` (rebuilt when the source is newer)
and called through its plain C entry point with ctypes, on PyTorch's current
stream, without synchronising.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Sequence, Tuple

import torch

from mlsgpu_tpu_torch.ops import mls

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "mls_field.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libmls_field.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: Kernel launches made by `eval_field` (a plain counter; reset it to 0
#: before a run to count that run's launches).
launches = 0

_lock = threading.Lock()
_lib = None
#: What the last build printed (nvcc's -Xptxas -v register/spill report)
#: and how long it took; empty when the library was already up to date.
build_log = ""
build_seconds = 0.0


class KernelBuildError(RuntimeError):
    """nvcc is missing or failed."""


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put it on PATH)")


def build(force: bool = False) -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns its path. Raises KernelBuildError on failure."""
    global build_log, build_seconds
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.monotonic() - t0
    build_log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def load():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.mls_field_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
            _lib = lib
        return _lib


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(entry_data: torch.Tensor, seg_starts: torch.Tensor,
           seg_lens: torch.Tensor, cell_origin: Sequence[int],
           tiles_per_axis: int, fit_shape: str,
           boundary_factor: float) -> torch.Tensor:
    """Run the kernel on CUDA tensors; returns the (B, B, B) field."""
    global launches
    dev = entry_data.device
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
    if fit_shape not in ("sphere", "plane"):
        raise ValueError(f"unknown fit_shape {fit_shape!r}")
    tpa = int(tiles_per_axis)
    num_tiles = tpa ** 3
    levels = seg_starts.shape[1] if seg_starts.dim() == 2 else -1
    _check("entry_data", entry_data, torch.float32, (entry_data.shape[0], 8))
    _check("seg_starts", seg_starts, torch.int32, (num_tiles, levels))
    _check("seg_lens", seg_lens, torch.int32, (num_tiles, levels))
    for name, t in (("seg_starts", seg_starts), ("seg_lens", seg_lens)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, entry_data on {dev}")
    if entry_data.data_ptr() % 16:
        raise ValueError("entry_data must be 16-byte aligned")
    b = tpa * mls.TILE
    field = torch.full((b, b, b), float("nan"), dtype=torch.float32,
                       device=dev)
    ox, oy, oz = mls.host_ints(cell_origin)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mls_field_launch(
            entry_data.data_ptr(), seg_starts.data_ptr(), seg_lens.data_ptr(),
            num_tiles, levels, tpa, ox, oy, oz, int(fit_shape == "plane"),
            float(boundary_factor), field.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mls_field_launch failed: cudaError_t {err}")
    launches += 1
    return field


def eval_field(entry_data: torch.Tensor, seg_starts: torch.Tensor,
               seg_lens: torch.Tensor, cell_origin: Sequence[int],
               tiles_per_axis: int, fit_shape: str = "sphere",
               boundary_factor: float = 0.0
               ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """The MLS field of one block: the kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (field, max_total, n_occ) with the
    meaning of mlsgpu_tpu's eval_field_pallas: no candidate cap, so
    max_total is 0; n_occ counts tiles with candidates."""
    dev = entry_data.device
    n_occ = (seg_lens.sum(dim=1) > 0).sum()
    if dev.type == "cuda":
        field = launch(entry_data, seg_starts, seg_lens, cell_origin,
                       tiles_per_axis, fit_shape, boundary_factor)
    elif dev.type == "cpu":
        field = mls.eval_field(entry_data, seg_starts, seg_lens, cell_origin,
                               tiles_per_axis, fit_shape, boundary_factor)
    else:
        raise ValueError(f"no MLS field path for device {dev}")
    return field, 0, n_occ
