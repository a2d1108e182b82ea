"""The MLS field kernel (csrc/mls_field.cu) and the one function the block
step calls for the field: `eval_field`.

`eval_field` takes the kernel path for tensors on a CUDA device and the
plain PyTorch version (ops/mls.py::eval_field) for tensors on the CPU; a
CUDA tensor either launches the kernel or raises — nothing falls back.

The kernel library holds the port's hand-written kernels: the field kernel
(csrc/mls_field.cu) and the seam passes' face and skeleton kernels
(csrc/seam_moments.cu, called from ops/seam_cuda.py). One nvcc call
compiles both sources for sm_90a on first use into
`mlsgpu_tpu_torch/_build/libmls_field.so` (rebuilt when a source is newer);
the kernels are called through their plain C entry points with ctypes, on
PyTorch's current stream, without synchronising.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Sequence, Tuple

import torch

from mlsgpu_tpu_torch.ops import mls
from mlsgpu_tpu_torch.utils import native_build

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(_PKG, "csrc", name)
           for name in ("mls_field.cu", "seam_moments.cu")]
LIBRARY_NAME = "libmls_field.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: Kernel launches made by `eval_field`, counted by `count_launch` under a
#: lock, plus those of the streamer's worker processes (`add_launches`).
#: Set it to 0 before a run to count that run's launches.
launches = 0

_count_lock = threading.Lock()
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


def library_path() -> str:
    return os.path.join(native_build.build_dir(), LIBRARY_NAME)


def build_command(compiler: Sequence[str], out: str) -> list:
    """The one compiler call that builds the library into `out` from every
    source: `compiler`, the flags, `-o out`, the sources."""
    return [*compiler, *NVCC_FLAGS, "-o", out, *SOURCES]


def build(force: bool = False,
          compiler: Optional[Sequence[str]] = None) -> str:
    """Compile the kernel library if it is missing or older than a source;
    returns its path. The build is locked against other processes and
    lands through a temporary file (utils/native_build.py). `compiler`
    replaces the nvcc command (build_command). Raises KernelBuildError on
    failure."""
    target = library_path()

    def compile_into(tmp: str) -> None:
        global build_log, build_seconds
        cmd = build_command(compiler or [find_nvcc()], tmp)
        t0 = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.monotonic() - t0
        build_log = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{build_log}")

    native_build.build_locked(target, SOURCES, compile_into, force=force)
    return target


def load():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.mls_field_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
            fn = lib.mls_tile_order_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                           + [ctypes.c_void_p] * 4)
            lib.mls_tile_order_scratch.restype = ctypes.c_int
            lib.mls_tile_order_scratch.argtypes = []
            for fn in (lib.seam_face_launch, lib.seam_skeleton_launch):
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * 4
                               + [ctypes.c_int, ctypes.c_void_p]
                               + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
            for fn in (lib.seam_max_buffer, lib.seam_max_terms,
                       lib.seam_max_terms_factor):
                fn.restype = ctypes.c_int
                fn.argtypes = []
            _lib = lib
        return _lib


def count_launch() -> None:
    """Add one to `launches`; called where the field kernel was launched
    and nowhere else."""
    global launches
    with _count_lock:
        launches += 1


def add_launches(n: int) -> None:
    """Add the launches a worker process counted for one block
    (pipeline/workers.py) to this process's `launches`."""
    global launches
    with _count_lock:
        launches += int(n)


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
    return _launch(entry_data, seg_starts, seg_lens, cell_origin,
                   tiles_per_axis, fit_shape, boundary_factor)[0]


def _launch(entry_data, seg_starts, seg_lens, cell_origin, tiles_per_axis,
            fit_shape, boundary_factor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel launch; returns (field, number of occupied tiles as a
    device scalar). The tile order (occupied tiles first, longest first,
    from the order kernels) and the count stay on the device: no host
    sync."""
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
    lib = load()
    order, n_occ = tile_order(seg_lens)
    b = tpa * mls.TILE
    field = torch.empty((b, b, b), dtype=torch.float32, device=dev)
    ox, oy, oz = mls.host_ints(cell_origin)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mls_field_launch(
            entry_data.data_ptr(), seg_starts.data_ptr(), seg_lens.data_ptr(),
            order.data_ptr(), n_occ.data_ptr(), num_tiles, levels, tpa,
            ox, oy, oz, int(fit_shape == "plane"), float(boundary_factor),
            field.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mls_field_launch failed: cudaError_t {err}")
    count_launch()
    return field, n_occ


def tile_order(seg_lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The order the kernel walks the tiles in, from its own order kernels:
    (tile ids (T,) int32, number of occupied tiles) on the device."""
    dev = seg_lens.device
    if dev.type != "cuda":
        raise ValueError(f"tile order kernels need CUDA tensors, got {dev}")
    _check("seg_lens", seg_lens, torch.int32, tuple(seg_lens.shape))
    lib = load()
    order = torch.empty(seg_lens.shape[0], dtype=torch.int32, device=dev)
    n_occ = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.mls_tile_order_scratch(), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        err = lib.mls_tile_order_launch(
            seg_lens.data_ptr(), seg_lens.shape[0], seg_lens.shape[1],
            scratch.data_ptr(), order.data_ptr(), n_occ.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mls_tile_order_launch failed: cudaError_t {err}")
    return order, n_occ


def tile_order_plain(seg_lens: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the tile order: occupied tiles first, by class
    7 - min(total // 32, 7) (longest first), ascending tile id inside a
    class; the empty tiles last."""
    totals = seg_lens.to(torch.int64).sum(dim=1)
    cls = torch.where(totals == 0, torch.full_like(totals, 8),
                      7 - torch.clamp(totals // 32, max=7))
    return (torch.argsort(cls, stable=True).to(torch.int32),
            (totals > 0).sum().to(torch.int32))


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
    if dev.type == "cuda":
        field, n_occ = _launch(entry_data, seg_starts, seg_lens, cell_origin,
                               tiles_per_axis, fit_shape, boundary_factor)
    elif dev.type == "cpu":
        n_occ = (seg_lens.sum(dim=1) > 0).sum()
        field = mls.eval_field(entry_data, seg_starts, seg_lens, cell_origin,
                               tiles_per_axis, fit_shape, boundary_factor)
    else:
        raise ValueError(f"no MLS field path for device {dev}")
    return field, 0, n_occ
