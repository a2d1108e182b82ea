"""Blob precomputation: one streaming pass over the input computing the
bounding box and 'blobs' — runs of consecutive splats sharing the same
microblock range.

Re-creation of FastBlobSet::computeBlobs (src/splat_set.h:653-903,
src/splat_set_impl.h:669-726): blobs compress the spatial index ~10-100x for
scanner data (consecutive points are spatially coherent), letting bucketing
work on blob ranges instead of individual splats, and letting the loader
re-read only the ranges a bucket needs. Microblock coordinates are absolute
(relative to the world origin, the reference's fast-path precondition,
src/splat_set.h:888-893) so they remain valid for any grid extents derived
later.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from mlsgpu_tpu_torch.core.grid import Grid
from mlsgpu_tpu_torch.io.splat_set import SplatSource
from mlsgpu_tpu_torch.utils import logging as log
from mlsgpu_tpu_torch.utils.statistics import get_registry


@dataclass
class BlobArray:
    """Struct-of-arrays blob store. Ranges are [start, start+count) global
    splat ids; lo/hi are inclusive microblock coords (absolute, may be
    negative). Arrays may be views into a disk-backed record memmap (see
    BlobAccumulator), in which case the OS page cache bounds resident
    memory — the reference keeps blobs in temp files for the same reason
    (src/splat_set.h:824-849)."""
    start: np.ndarray   # (B,) int64
    count: np.ndarray   # (B,) int32 (a run is bounded by one file/chunk)
    lo: np.ndarray      # (B, 3) int32
    hi: np.ndarray      # (B, 3) int32

    def __len__(self) -> int:
        return len(self.start)

    @property
    def num_splats(self) -> int:
        return int(self.start[-1] + self.count[-1]) if len(self.start) else 0


# 36 bytes/blob on disk or in RAM (the reference's encodings are 4/40 bytes,
# src/splat_set.h:669-708; we trade a little space for mmap-able fixed-width
# records and vectorized numpy access).
BLOB_RECORD = np.dtype([("start", "<i8"), ("count", "<i4"),
                        ("lo", "<i4", (3,)), ("hi", "<i4", (3,))])


class BlobAccumulator:
    """Append-only blob record sink: stays in RAM below `mem_budget` bytes,
    spills every record to an unlinked temp file past it and finishes as a
    memmap-backed BlobArray (disk-resident blob store; the FastBlobSet temp
    -file analogue, src/splat_set.h:824-849). With the file unlinked at
    creation the kernel reclaims it when the memmap is garbage collected."""

    def __init__(self, mem_budget: Optional[int] = None):
        self._parts = []          # list of BLOB_RECORD arrays (RAM mode)
        self._bytes = 0
        self._count = 0
        self._budget = mem_budget
        self._file = None

    def append(self, start, count, lo, hi) -> None:
        n = len(start)
        if n == 0:
            return
        rec = np.empty(n, BLOB_RECORD)
        rec["start"] = start
        rec["count"] = count
        rec["lo"] = lo
        rec["hi"] = hi
        self._count += n
        self._bytes += rec.nbytes
        if self._file is None and self._budget is not None \
                and self._bytes > self._budget:
            self._spill()
        if self._file is not None:
            self._file.write(rec.tobytes())
        else:
            self._parts.append(rec)

    def _spill(self) -> None:
        import os

        from mlsgpu_tpu_torch.utils.misc import create_tmp_file
        path = create_tmp_file(prefix="mlsgpu_tpu.blobs.")
        self._file = open(path, "w+b")
        os.unlink(path)  # auto-reclaim once closed/unreferenced
        get_registry().counter("blobs.spilled").add(1)
        log.info(f"blob store exceeded {self._budget} bytes; "
                 f"spilling records to disk")
        for rec in self._parts:
            self._file.write(rec.tobytes())
        self._parts.clear()

    def finish(self) -> BlobArray:
        if self._file is not None:
            self._file.flush()
            rec = np.memmap(self._file, dtype=BLOB_RECORD, mode="r",
                            shape=(self._count,))
        elif self._parts:
            rec = (self._parts[0] if len(self._parts) == 1
                   else np.concatenate(self._parts))
        else:
            rec = np.empty(0, BLOB_RECORD)
        get_registry().peak("mem.blobs").add(
            0 if self._file is not None else self._bytes)
        return BlobArray(start=rec["start"], count=rec["count"],
                         lo=rec["lo"], hi=rec["hi"])


@dataclass
class BlobInfo:
    blobs: BlobArray
    grid: Grid                    # extents cover all influenced corners
    micro_lo: np.ndarray          # (3,) int64: microblock coord of grid cell 0
    micro_dims: np.ndarray        # (3,) int64: microblock grid size
    num_splats: int
    num_nonfinite: int


def _splat_cell_bounds(chunk: np.ndarray, inv_spacing: np.float32
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-splat [lo, hi] inclusive absolute cell range of pos +- r, using the
    same float32 expression as SplatArray.to_grid_frame so the range is
    consistent with what the device block step will see."""
    pos = chunk[:, 0:3]
    r = chunk[:, 3][:, None]
    finite = np.isfinite(chunk).all(axis=1) & (chunk[:, 3] > 0)
    with np.errstate(invalid="ignore"):
        lo = np.floor(np.nan_to_num((pos - r) * inv_spacing)).astype(np.int64)
        hi = np.floor(np.nan_to_num((pos + r) * inv_spacing)).astype(np.int64)
    return lo, hi, finite


def compute_blobs(source: SplatSource, spacing: float, micro_cells: int,
                  progress=None, mem_budget: Optional[int] = None) -> BlobInfo:
    """Single streaming pass: bbox + blob runs (the reference's pass 0,
    src/mlsgpu_core.cpp:587-615). Past `mem_budget` bytes the blob records
    spill to a disk-backed store (src/splat_set.h:824-849 analogue)."""
    inv_spacing = np.float32(1.0) / np.float32(spacing)
    stats = get_registry()

    acc = BlobAccumulator(mem_budget)
    cur_lo = cur_hi = None  # current run's microblock range
    cur_start = 0
    cur_count = 0
    cell_min = np.full(3, np.iinfo(np.int64).max)
    cell_max = np.full(3, np.iinfo(np.int64).min)
    num_nonfinite = 0
    total = 0

    def close_run():
        nonlocal cur_lo
        if cur_lo is not None:
            acc.append(np.array([cur_start], dtype=np.int64),
                       np.array([cur_count], dtype=np.int64),
                       cur_lo[None, :], cur_hi[None, :])
            cur_lo = None

    # Native one-pass RLE (bounds + runs + bbox at memory speed); the numpy
    # path below is the fallback and the test oracle for it.
    from mlsgpu_tpu_torch import _native as nat
    use_native = nat.available()
    nat_carry = np.zeros(9, np.int64)
    nat_bbox = np.concatenate([np.full(3, np.iinfo(np.int64).max),
                               np.full(3, np.iinfo(np.int64).min)])
    nat_nonfinite = np.zeros(1, np.int64)

    with stats.timer("blobs.time"):
        for first_id, chunk in source.iter_chunks():
            if not len(chunk):
                continue
            total += len(chunk)
            if use_native:
                st, ct, lo, hi = nat.blob_rle(
                    chunk, int(first_id), float(inv_spacing),
                    int(micro_cells), nat_carry, nat_bbox, nat_nonfinite)
                acc.append(st, ct, lo, hi)
                if progress is not None:
                    progress += len(chunk)
                continue
            lo_c, hi_c, finite = _splat_cell_bounds(chunk, inv_spacing)
            num_nonfinite += int(len(chunk) - finite.sum())
            mlo = np.floor_divide(lo_c, micro_cells)
            mhi = np.floor_divide(hi_c, micro_cells)

            fin_idx = np.nonzero(finite)[0]
            if len(fin_idx):
                cell_min = np.minimum(cell_min, lo_c[fin_idx].min(axis=0))
                cell_max = np.maximum(cell_max, hi_c[fin_idx].max(axis=0))

            # Run-length encode: a run continues while the microblock range
            # is unchanged and splats are finite. Non-finite splats break
            # runs and belong to no blob (they are skipped at load time too).
            rng6 = np.concatenate([mlo, mhi], axis=1)
            same = np.zeros(len(chunk), dtype=bool)
            if len(chunk) > 1:
                same[1:] = ((rng6[1:] == rng6[:-1]).all(axis=1)
                            & finite[1:] & finite[:-1])
            if cur_lo is not None and finite[0] \
                    and np.array_equal(rng6[0], np.concatenate([cur_lo, cur_hi])):
                same[0] = True

            run_starts = np.nonzero(~same)[0]
            lead = int(run_starts[0]) if len(run_starts) else len(chunk)
            if cur_lo is not None:
                cur_count += lead  # carried run extends into this chunk
            if len(run_starts):
                close_run()
                rs = run_starts
                ends = np.concatenate([rs[1:], [len(chunk)]])
                # Vectorized emit of every complete run; the final run stays
                # open (it may continue into the next chunk). Incoherent
                # inputs can have one run per splat — a Python per-run loop
                # here was the blob pass's bottleneck.
                emit = finite[rs[:-1]]
                if emit.any():
                    idx = np.nonzero(emit)[0]
                    acc.append(first_id + rs[idx], ends[idx] - rs[idx],
                               mlo[rs[idx]], mhi[rs[idx]])
                last = int(rs[-1])
                if finite[last]:
                    cur_start = first_id + last
                    cur_count = len(chunk) - last
                    cur_lo, cur_hi = mlo[last], mhi[last]
            if progress is not None:
                progress += len(chunk)
    if use_native:
        if nat_carry[0]:
            acc.append(nat_carry[1:2].copy(), nat_carry[2:3].copy(),
                       nat_carry[3:6].copy()[None, :],
                       nat_carry[6:9].copy()[None, :])
        cell_min = nat_bbox[0:3]
        cell_max = nat_bbox[3:6]
        num_nonfinite = int(nat_nonfinite[0])
    else:
        close_run()

    blobs = acc.finish()
    if not len(blobs):
        raise ValueError("no finite splats in input")

    # Grid extents: corners influenced span [cell_min, cell_max + 1]
    # inclusive -> cells [cell_min, cell_max + 1).
    extents = tuple((int(cell_min[a]), int(cell_max[a]) + 1) for a in range(3))
    grid = Grid.make((0.0, 0.0, 0.0), spacing, extents)

    micro_lo = blobs.lo.min(axis=0)
    micro_hi = blobs.hi.max(axis=0)
    micro_dims = micro_hi - micro_lo + 1

    stats.counter("blobs.numBlobs").add(len(blobs))
    stats.counter("blobs.numSplats").add(total)
    log.info(f"blobs: {len(blobs)} blobs over {total} splats "
             f"({total / max(len(blobs), 1):.1f} splats/blob), "
             f"grid cells {grid.shape_cells}")
    return BlobInfo(blobs=blobs, grid=grid, micro_lo=micro_lo,
                    micro_dims=micro_dims, num_splats=total,
                    num_nonfinite=num_nonfinite)
