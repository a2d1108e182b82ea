"""The seam passes' kernels (csrc/seam_moments.cu) and the two functions the
block step calls for them: `canonical_face_field` and
`skeleton_point_field`, with ops/mls.py's signatures.

Tensors on a CUDA device take the kernel path: each pass is one kernel
launch per block, which derives its rows or points, sums the moments,
fits and writes the field in place, with no host synchronisation (the
skeleton pass may first convert its points to int64 on the card). Tensors
on the CPU take the plain version (ops/mls.py). A CUDA tensor launches the
kernel or raises; nothing falls back. `face_moments` and
`skeleton_moments` run the kernels' moments mode, which writes the moments
and hits in place of the field, for holding the kernels to
mls.face_moments / skeleton_moments. The kernels live in the library
ops/mls_cuda.py builds.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from mlsgpu_tpu_torch.ops import launches, mls, mls_cuda

def max_buffer() -> int:
    """The kernels' largest (and default) candidate buffer of a window."""
    return int(mls_cuda.load().seam_max_buffer())


def kernel_attributes(device: torch.device) -> Dict[str, int]:
    """What the seam kernels make the driver reserve on a card, read from
    the built library (built and loaded here if it is not yet) and the
    card, once a card: the larger of their local memory bytes a thread
    (`local_bytes`, cudaFuncGetAttributes), the card's `multiprocessors`
    and `threads_per_multiprocessor`, and each kernel's registers a
    thread."""
    return dict(zip(("local_bytes", "multiprocessors",
                     "threads_per_multiprocessor", "face_registers",
                     "skeleton_registers"),
                    _attributes(int(device.index or 0))))


@functools.lru_cache(maxsize=None)
def _attributes(index: int) -> Tuple[int, ...]:
    out = (ctypes.c_int * 5)()
    err = mls_cuda.load().seam_kernel_attributes(index, out)
    if err != 0:
        raise RuntimeError(f"seam_kernel_attributes failed: cudaError_t {err}")
    return tuple(out)


def _check_inputs(entry_data, entry_vals, seg_starts, seg_lens) -> None:
    dev = entry_data.device
    levels = seg_starts.shape[1] if seg_starts.dim() == 2 else -1
    mls_cuda._check("entry_data", entry_data, torch.float32,
                    (entry_data.shape[0], 8))
    mls_cuda._check("entry_vals", entry_vals, torch.int64,
                    (entry_data.shape[0],))
    mls_cuda._check("seg_starts", seg_starts, torch.int32,
                    (seg_starts.shape[0], levels))
    mls_cuda._check("seg_lens", seg_lens, torch.int32, tuple(seg_starts.shape))
    for name, t in (("entry_vals", entry_vals), ("seg_starts", seg_starts),
                    ("seg_lens", seg_lens)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, entry_data on {dev}")
    if entry_data.data_ptr() % 16:
        raise ValueError("entry_data must be 16-byte aligned")
    if entry_data.shape[0] >= 1 << 31:
        # ranks, entry indices and identities are 32-bit in the kernels
        raise ValueError(f"{entry_data.shape[0]} entries: at most 2^31 - 1")


def _cap(lib, buffer: Optional[int]) -> int:
    most = int(lib.seam_max_buffer())
    cap = most if buffer is None else int(buffer)
    if not 4 <= cap <= most or cap & (cap - 1):
        raise ValueError(f"buffer {cap}: not a power of two in [4, {most}]")
    return cap


def _fit_args(fit_shape: str, boundary_factor: float) -> Tuple[int, float]:
    if fit_shape not in ("sphere", "plane"):
        raise ValueError(f"unknown fit_shape {fit_shape!r}")
    return int(fit_shape == "plane"), float(boundary_factor)


def _launch(kind: str, entry_data, entry_vals, seg_starts, seg_lens,
            cell_origin, tiles_per_axis, shape_args: Sequence[int],
            fit: Tuple[int, float], buffer: Optional[int],
            field: Optional[torch.Tensor], moments: Optional[torch.Tensor],
            hits: Optional[torch.Tensor]) -> None:
    """One launch of the face or skeleton kernel: into `field` (field
    mode) or, with `field` None, into `moments` and `hits` (moments mode).
    `shape_args`: the face kernel's region cells, or the skeleton kernel's
    (points pointer, number of points). `buffer` shrinks the candidate
    window (a power of two >= 4), which only adds windows."""
    dev = entry_data.device
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
    _check_inputs(entry_data, entry_vals, seg_starts, seg_lens)
    lib = mls_cuda.load()
    cap = _cap(lib, buffer)
    tpa = int(tiles_per_axis)
    if seg_starts.shape[0] != tpa ** 3:
        raise ValueError(f"seg_starts: {seg_starts.shape[0]} tiles, "
                         f"expected {tpa ** 3}")
    ox, oy, oz = mls.host_ints(cell_origin)
    outs = (field, None, None) if field is not None else (None, moments, hits)
    for t in outs:
        if t is not None and t.device != dev:
            raise ValueError(f"output on {t.device}, entry_data on {dev}")
    ptrs = [0 if t is None else t.data_ptr() for t in outs]
    with torch.cuda.device(dev):
        fn = lib.seam_face_launch if kind == "face" else lib.seam_skeleton_launch
        err = fn(entry_data.data_ptr(), entry_vals.data_ptr(),
                 seg_starts.data_ptr(), seg_lens.data_ptr(),
                 seg_starts.shape[1], tpa, ox, oy, oz, *shape_args, *fit,
                 cap, *ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seam_{kind}_launch failed: cudaError_t {err}")
    launches.count(f"seam_{kind}")


def _check_field(field: torch.Tensor, dev, tpa: int) -> None:
    b = 8 * int(tpa)
    mls_cuda._check("field", field, torch.float32, (b, b, b))
    if field.device != dev:
        raise ValueError(f"field on {field.device}, entry_data on {dev}")


def _region(region_cells: Sequence[int], tpa: int) -> list:
    rc = mls.host_ints(region_cells)
    if not all(0 <= r < 8 * int(tpa) for r in rc):
        raise ValueError(f"region cells {rc} outside a block of "
                         f"{8 * int(tpa)} corners")
    return rc


def _points(points: torch.Tensor, dev) -> torch.Tensor:
    """The points as the skeleton kernel reads them: (P, 3) int64,
    contiguous, on `dev` (a copy only where they are not)."""
    pts = points.to(device=dev, dtype=torch.int64).contiguous()
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"points: expected (P, 3), got {tuple(pts.shape)}")
    if pts.shape[0] >= 1 << 31:
        raise ValueError(f"{pts.shape[0]} points: at most 2^31 - 1")
    return pts


def face_moments(entry_data, entry_vals, seg_starts, seg_lens,
                 cell_origin: Sequence[int], region_cells: Sequence[int],
                 tiles_per_axis: int, buffer: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The face kernel's moments mode on CUDA tensors, in one launch:
    mls.face_moments of the rows mls.face_rows gives, (R, 64, 9) f32 and
    (R, 64) int32."""
    dev = entry_data.device
    tpa = int(tiles_per_axis)
    n = 6 * (tpa + 1) ** 2
    moments = torch.empty((n, 64, 9), dtype=torch.float32, device=dev)
    hits = torch.empty((n, 64), dtype=torch.int32, device=dev)
    _launch("face", entry_data, entry_vals, seg_starts, seg_lens,
            cell_origin, tpa, _region(region_cells, tpa), (0, 0.0), buffer,
            None, moments, hits)
    return moments, hits


def skeleton_moments(entry_data, entry_vals, seg_starts, seg_lens,
                     cell_origin: Sequence[int], points: torch.Tensor,
                     tiles_per_axis: int, buffer: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The skeleton kernel's moments mode on CUDA tensors, in one launch:
    mls.skeleton_moments of the points (mls.skeleton_points), (P, 1, 9)
    f32 and (P, 1) int32."""
    dev = entry_data.device
    pts = _points(points, dev)
    n = pts.shape[0]
    moments = torch.empty((n, 1, 9), dtype=torch.float32, device=dev)
    hits = torch.empty((n, 1), dtype=torch.int32, device=dev)
    _launch("skeleton", entry_data, entry_vals, seg_starts, seg_lens,
            cell_origin, tiles_per_axis, (pts.data_ptr(), n), (0, 0.0),
            buffer, None, moments, hits)
    return moments, hits


def _path(t: torch.Tensor) -> bool:
    """True for the kernel path (a CUDA tensor), False for the plain one
    (a CPU tensor); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no seam pass path for device {t.device}")


def canonical_face_field(field: torch.Tensor, entry_data: torch.Tensor,
                         entry_vals: torch.Tensor, seg_starts: torch.Tensor,
                         seg_lens: torch.Tensor, cell_origin: Sequence[int],
                         region_cells: Sequence[int], tiles_per_axis: int,
                         fit_shape: str, boundary_factor: float,
                         row_chunk: int = 32, *,
                         buffer: Optional[int] = None) -> torch.Tensor:
    """mls.canonical_face_field: the face kernel for CUDA tensors (one
    launch; `row_chunk` unused, `buffer` see _launch), the plain version
    for CPU tensors. Returns `field`, rewritten in place."""
    if not _path(entry_data):
        return mls.canonical_face_field(
            field, entry_data, entry_vals, seg_starts, seg_lens, cell_origin,
            region_cells, tiles_per_axis, fit_shape, boundary_factor,
            row_chunk)
    _check_field(field, entry_data.device, tiles_per_axis)
    _launch("face", entry_data, entry_vals, seg_starts, seg_lens,
            cell_origin, tiles_per_axis,
            _region(region_cells, tiles_per_axis),
            _fit_args(fit_shape, boundary_factor), buffer, field, None, None)
    return field


def skeleton_point_field(field: torch.Tensor, entry_data: torch.Tensor,
                         entry_vals: torch.Tensor, seg_starts: torch.Tensor,
                         seg_lens: torch.Tensor, cell_origin: Sequence[int],
                         points: torch.Tensor, tiles_per_axis: int,
                         fit_shape: str, boundary_factor: float,
                         point_chunk: int = 64, *,
                         buffer: Optional[int] = None) -> torch.Tensor:
    """mls.skeleton_point_field: the skeleton kernel for CUDA tensors (one
    launch; `point_chunk` unused), the plain version for CPU tensors.
    Returns `field`, rewritten in place at the points."""
    if not _path(entry_data):
        return mls.skeleton_point_field(
            field, entry_data, entry_vals, seg_starts, seg_lens, cell_origin,
            points, tiles_per_axis, fit_shape, boundary_factor, point_chunk)
    if points is None or points.shape[0] == 0:
        return field
    dev = entry_data.device
    _check_field(field, dev, tiles_per_axis)
    pts = _points(points, dev)
    _launch("skeleton", entry_data, entry_vals, seg_starts, seg_lens,
            cell_origin, tiles_per_axis, (pts.data_ptr(), pts.shape[0]),
            _fit_args(fit_shape, boundary_factor), buffer, field, None, None)
    return field
