"""Bucketing with the sparse path (port of mlsgpu_tpu/pipeline/bucket.py:
`sparse_micro_counts`, `bucket_regions_sparse`, `make_buckets`).

The dense path and every other helper are the JAX package's own, imported:
they are numpy. Its sparse path imports `mlsgpu_tpu.ops.morton`, which
imports jax, so the three functions that reach it live here on the port's
numpy Morton code. `MAX_MICRO_GRID` is read from the JAX package's module at
call time, so a run (or a test) that changes it there changes it for both.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from mlsgpu_tpu.core.chunk import ChunkId
from mlsgpu_tpu.pipeline import bucket as host
from mlsgpu_tpu.pipeline.blobs import BlobArray, BlobInfo
from mlsgpu_tpu.pipeline.bucket import (Bucket, _span_offsets, _SPAN_VEC,
                                        assign_blobs, bucket_regions,
                                        microblock_counts, skeleton_points)
from mlsgpu_tpu.utils import logging as log
from mlsgpu_tpu.utils.errors import DensityError
from mlsgpu_tpu.utils.statistics import get_registry

from mlsgpu_tpu_torch.ops import morton


def sparse_micro_counts(blobs: BlobArray, micro_lo: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted (Morton codes, counts) of the occupied microblocks: the sparse
    stand-in for the dense count grid when the extent exceeds MAX_MICRO_GRID
    per axis. Codes are uint64 Morton, 21 bits per axis."""
    lo = (blobs.lo - micro_lo).astype(np.uint64)
    hi = (blobs.hi - micro_lo).astype(np.uint64)
    span = blobs.hi - blobs.lo
    single = (span == 0).all(axis=1)

    codes = [morton.encode_np(lo[single, 0], lo[single, 1], lo[single, 2])]
    weights = [blobs.count[single]]
    # Spanning blobs, vectorized per span offset (see microblock_counts).
    multi = np.nonzero(~single)[0]
    small = multi[(span[multi] < _SPAN_VEC).all(axis=1)]
    if len(small):
        mlo = lo[small]
        msp = span[small].astype(np.int64)
        mw = blobs.count[small]
        for off in _span_offsets(msp.max(axis=0)):
            sel = (msp >= off).all(axis=1)
            pos = mlo[sel] + off.astype(np.uint64)
            codes.append(morton.encode_np(pos[:, 0], pos[:, 1], pos[:, 2]))
            weights.append(mw[sel])
    for i in multi[(span[multi] >= _SPAN_VEC).any(axis=1)]:
        a, b = lo[i], hi[i]
        gx, gy, gz = np.meshgrid(np.arange(a[0], b[0] + 1, dtype=np.uint64),
                                 np.arange(a[1], b[1] + 1, dtype=np.uint64),
                                 np.arange(a[2], b[2] + 1, dtype=np.uint64),
                                 indexing="ij")
        codes.append(morton.encode_np(gx.ravel(), gy.ravel(), gz.ravel()))
        weights.append(np.full(gx.size, blobs.count[i], dtype=np.int64))
    ucodes, inv = np.unique(np.concatenate(codes), return_inverse=True)
    counts = np.bincount(inv, weights=np.concatenate(weights).astype(
        np.float64), minlength=len(ucodes)).astype(np.int64)
    return ucodes, counts


def bucket_regions_sparse(codes: np.ndarray, counts: np.ndarray,
                          micro_cells: int, dims: np.ndarray,
                          max_cells: int, max_splats: int
                          ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The sparse analogue of bucket_regions: the same power-of-two aligned
    tiling, with box sums from Morton-range queries over the sorted codes
    (an aligned power-of-two cube is one contiguous Morton range), and
    splat-budget splits into the 8 octree children (Morton-contiguous too).
    Raises DensityError when one microblock exceeds max_splats."""
    step = max(max_cells // micro_cells, 1)
    step = 1 << int(np.floor(np.log2(step)))
    prefix = np.concatenate([[0], np.cumsum(counts)])
    out: List[Tuple[np.ndarray, np.ndarray]] = []

    def emit(code_lo: int, size: int) -> None:
        a = np.searchsorted(codes, code_lo, side="left")
        b = np.searchsorted(codes, code_lo + size ** 3, side="left")
        n = int(prefix[b] - prefix[a])
        if n == 0:
            return
        if n <= max_splats:
            x, y, z = morton.decode_np(np.array([code_lo], dtype=np.uint64))
            lo = np.array([int(x[0]), int(y[0]), int(z[0])], dtype=np.int64)
            sz = np.minimum(lo + size, dims) - lo
            if (sz > 0).all():
                out.append((lo, sz))
            return
        if size == 1:
            raise DensityError(
                f"microblock (code {code_lo}) has {n} splats > budget "
                f"{max_splats}", n)
        child = (size // 2) ** 3
        for c in range(8):
            emit(code_lo + c * child, size // 2)

    tile_vol = step ** 3
    for t in np.unique(codes // tile_vol):    # occupied tiles only
        emit(int(t) * tile_vol, step)
    return out


def make_buckets(info: BlobInfo, block_cells: int, micro_cells: int,
                 max_splats: int, chunk_cells: Optional[int] = None,
                 max_split: Optional[int] = None) -> List[Bucket]:
    """Counts -> regions -> blob assignment -> Buckets, dense or sparse by
    the microblock extent (mlsgpu_tpu/pipeline/bucket.py::make_buckets on
    the port's Morton code)."""
    stats = get_registry()
    with stats.timer("bucket.time"):
        grid_cells = np.asarray(info.grid.shape_cells, dtype=np.int64)
        if (info.micro_dims > host.MAX_MICRO_GRID).any():
            codes, counts = sparse_micro_counts(info.blobs, info.micro_lo)
            regions = bucket_regions_sparse(
                codes, counts, micro_cells, info.micro_dims, block_cells,
                max_splats)
        else:
            counts = microblock_counts(info.blobs, info.micro_lo,
                                       info.micro_dims)
            regions = bucket_regions(counts, micro_cells, grid_cells,
                                     block_cells, max_splats)
        if max_split is not None and len(regions) > max_split:
            raise DensityError(
                f"bucketing produced {len(regions)} regions > max_split "
                f"{max_split}; raise --max-split or --leaf-cells",
                len(regions))
        step = max(block_cells // micro_cells, 1)
        step = 1 << int(np.floor(np.log2(step)))  # bucket_regions' tiling
        blob_lists = assign_blobs(info.blobs, info.micro_lo, regions,
                                  step=step)

    # Grid-local cell coordinates: microblock (0, 0, 0) sits at absolute
    # cell micro_lo * micro_cells; the grid's cell 0 is its extent's lo.
    ext_lo = np.array([e[0] for e in info.grid.extents], dtype=np.int64)
    micro_origin = info.micro_lo * micro_cells - ext_lo

    buckets: List[Bucket] = []
    chunk_ids: dict = {}
    for (rlo, size), bids in zip(regions, blob_lists):
        if not len(bids):
            continue
        cell_lo = micro_origin + rlo * micro_cells
        cell_hi = np.minimum(cell_lo + size * micro_cells, grid_cells)
        cell_lo_cl = np.maximum(cell_lo, 0)
        if (cell_hi <= cell_lo_cl).any():
            continue
        coords = ((0, 0, 0) if chunk_cells is None
                  else tuple(int(c) for c in cell_lo_cl // chunk_cells))
        cid = chunk_ids.get(coords)
        if cid is None:
            cid = chunk_ids[coords] = ChunkId(gen=len(chunk_ids),
                                              coords=coords)
        buckets.append(Bucket(chunk_id=cid, cell_lo=cell_lo_cl,
                              cell_hi=cell_hi, blob_ids=bids,
                              num_splats=int(info.blobs.count[bids].sum())))

    with stats.timer("bucket.skeletonTime"):
        skeleton_points(buckets)
    stats.counter("bucket.count").add(len(buckets))
    log.info(f"bucketing: {len(buckets)} buckets (max splats/bucket: "
             f"{max((b.num_splats for b in buckets), default=0)})")
    return buckets
