"""The seam passes' kernels (csrc/seam_moments.cu) and the two functions the
block step calls for them: `canonical_face_field` and
`skeleton_point_field`, with ops/mls.py's signatures.

Tensors on a CUDA device take the kernel path: the pass's preparation
(mls.face_rows / mls.skeleton_points), one kernel launch for the moments
and hit counts of every row or point, then the plain fit and write
(mls.fit_faces / mls.fit_points), with no host synchronisation. Tensors on
the CPU take the plain version (ops/mls.py). A CUDA tensor launches the
kernel or raises; nothing falls back. The kernels live in the library
ops/mls_cuda.py builds.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mlsgpu_tpu_torch.ops import mls, mls_cuda

#: Kernel launches made by the wrappers (face, skeleton), counted under a
#: lock, plus those of the streamer's worker processes (`add_launches`).
#: Set them to 0 before a run to count that run's launches.
face_launches = 0
skeleton_launches = 0

_count_lock = threading.Lock()


def count_launch(kind: str) -> None:
    """Add one to `face_launches` or `skeleton_launches` (`kind` "face" or
    "skeleton"); called where that kernel was launched and nowhere else."""
    global face_launches, skeleton_launches
    with _count_lock:
        if kind == "face":
            face_launches += 1
        else:
            skeleton_launches += 1


def add_launches(face: int, skeleton: int) -> None:
    """Add the launches a worker process counted for one block
    (pipeline/workers.py) to this process's counts."""
    global face_launches, skeleton_launches
    with _count_lock:
        face_launches += int(face)
        skeleton_launches += int(skeleton)


def launch_counts() -> Tuple[int, int, int]:
    """This process's launches of the field, face and skeleton kernels."""
    return mls_cuda.launches, face_launches, skeleton_launches


def add_launch_counts(counts: Sequence[int]) -> None:
    """Add a worker's launch_counts() difference for one block."""
    mls_cuda.add_launches(counts[0])
    add_launches(counts[1], counts[2])


def max_buffer() -> int:
    """The kernels' largest (and default) candidate buffer a round."""
    return int(mls_cuda.load().seam_max_buffer())


def max_terms(buffer: int) -> int:
    """The most nonzero-weight terms a corner may have in a launch with
    this buffer: the terms it holds at once, min(buffer, the kernels'
    list), times the number of residue classes the kernels combine."""
    lib = mls_cuda.load()
    return (min(int(buffer), int(lib.seam_max_terms()))
            * int(lib.seam_max_terms_factor()))


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


#: Columns of the skeleton kernel's points: x, y, z global, and the tile
#: holding the point (-1 for a point outside the block).
POINT_COLS = 4


def _launch(kind: str, entry_data, entry_vals, seg_starts, seg_lens,
            items: torch.Tensor, buffer: Optional[int]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the face (`items` the (R, ROW_COLS) rows) or skeleton
    (the (P, POINT_COLS) points) kernel; returns (moments (N, corners, 9),
    hits (N, corners) int32), 64 corners a row, one a point. `buffer`
    shrinks the candidate buffer of a round and the terms a corner holds
    at once (a power of two >= 4), which only adds rounds and streams."""
    dev = entry_data.device
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
    _check_inputs(entry_data, entry_vals, seg_starts, seg_lens)
    face = kind == "face"
    n = items.shape[0]
    mls_cuda._check("items", items, torch.int32,
                    (n, mls.ROW_COLS if face else POINT_COLS))
    if items.device != dev:
        raise ValueError(f"items on {items.device}, entry_data on {dev}")
    lib = mls_cuda.load()
    most = int(lib.seam_max_buffer())
    cap = most if buffer is None else int(buffer)
    if not 4 <= cap <= most or cap & (cap - 1):
        raise ValueError(f"buffer {cap}: not a power of two in [4, {most}]")
    if entry_data.shape[0] > max_terms(cap):
        # a corner's terms are distinct entries of the block
        raise ValueError(f"{entry_data.shape[0]} entries: a corner could "
                         f"have more terms than the kernels combine "
                         f"({max_terms(cap)} with buffer {cap})")
    corners = 64 if face else 1
    moments = torch.empty((n, corners, 9), dtype=torch.float32, device=dev)
    hits = torch.empty((n, corners), dtype=torch.int32, device=dev)
    fn = lib.seam_face_launch if face else lib.seam_skeleton_launch
    with torch.cuda.device(dev):
        err = fn(entry_data.data_ptr(), entry_vals.data_ptr(),
                 seg_starts.data_ptr(), seg_lens.data_ptr(),
                 seg_starts.shape[1], items.data_ptr(), n, cap,
                 moments.data_ptr(), hits.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seam_{kind}_launch failed: cudaError_t {err}")
    count_launch(kind)
    return moments, hits


def face_moments(entry_data, entry_vals, seg_starts, seg_lens,
                 rows: torch.Tensor, buffer: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The face kernel on CUDA tensors: mls.face_moments of the rows
    (mls.face_rows, int32 on the card) in one launch."""
    return _launch("face", entry_data, entry_vals, seg_starts, seg_lens,
                   rows, buffer)


def skeleton_moments(entry_data, entry_vals, seg_starts, seg_lens,
                     pts: torch.Tensor, tid: torch.Tensor,
                     inside: torch.Tensor, buffer: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The skeleton kernel on CUDA tensors: mls.skeleton_moments of the
    points (mls.skeleton_points) in one launch."""
    items = torch.cat([pts, torch.where(inside, tid, -1)[:, None]],
                      dim=1).to(torch.int32)
    return _launch("skeleton", entry_data, entry_vals, seg_starts, seg_lens,
                   items, buffer)


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
    rows = mls.rows_on(mls.face_rows(cell_origin, region_cells,
                                     tiles_per_axis).astype(np.int32),
                       entry_data.device)
    m, hits = face_moments(entry_data, entry_vals, seg_starts, seg_lens,
                           rows, buffer)
    return mls.fit_faces(field, m, hits, rows, cell_origin, region_cells,
                         tiles_per_axis, fit_shape, boundary_factor)


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
    pts, lp, tid, inside = mls.skeleton_points(
        points.to(field.device), cell_origin, tiles_per_axis, field.shape[0])
    m, hits = skeleton_moments(entry_data, entry_vals, seg_starts, seg_lens,
                               pts, tid, inside, buffer)
    return mls.fit_points(field, m, hits, pts, lp, inside, fit_shape,
                          boundary_factor)
