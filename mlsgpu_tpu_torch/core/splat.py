"""Splat data model.

The reference stores splats as an AoS POD (src/splat.h:40-61: position[3],
radius, normal[3], quality). On TPU we keep a single dense (N, 8) float32
array — one DMA-friendly layout, directly consumable as the K x 8 operand of
the MLS moment matmuls (see DESIGN.md). Column order:

    0:x 1:y 2:z 3:radius 4:nx 5:ny 6:nz 7:quality

After `to_grid` / binning, column 3 holds 1/radius^2 (the form the MLS weight
needs, mirroring kernels/octree.cl:192-194's in-place transform).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

NUM_FIELDS = 8
X, Y, Z, RADIUS, NX, NY, NZ, QUALITY = range(8)


class SplatArray:
    """A thin wrapper over an (N, 8) float32 array of splats."""

    __slots__ = ("data",)

    def __init__(self, data: np.ndarray):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim != 2 or data.shape[1] != NUM_FIELDS:
            raise ValueError(f"splat array must be (N, {NUM_FIELDS})")
        self.data = data

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def positions(self) -> np.ndarray:
        return self.data[:, X:Z + 1]

    @property
    def radii(self) -> np.ndarray:
        return self.data[:, RADIUS]

    @property
    def normals(self) -> np.ndarray:
        return self.data[:, NX:NZ + 1]

    @property
    def quality(self) -> np.ndarray:
        return self.data[:, QUALITY]

    def is_finite(self) -> np.ndarray:
        """Per-splat validity (reference Splat::isFinite: finite fields and
        radius > 0)."""
        return np.isfinite(self.data).all(axis=1) & (self.data[:, RADIUS] > 0)

    @staticmethod
    def make(positions, radii, normals, quality: Optional[np.ndarray] = None) -> "SplatArray":
        positions = np.asarray(positions, dtype=np.float32)
        n = positions.shape[0]
        data = np.empty((n, NUM_FIELDS), dtype=np.float32)
        data[:, X:Z + 1] = positions
        data[:, RADIUS] = radii
        data[:, NX:NZ + 1] = normals
        if quality is None:
            # Reference default: quality = 1/r^2 of the smoothed radius
            # (src/fast_ply.cpp:348).
            r = np.asarray(radii, dtype=np.float32)
            data[:, QUALITY] = 1.0 / (r * r)
        else:
            data[:, QUALITY] = quality
        return SplatArray(data)

    def to_grid_frame(self, grid) -> np.ndarray:
        """Return an (N, 8) array in grid coordinates with radius replaced by
        1/r^2 — the layout the device kernels consume. Positions use the
        invariant world->vertex transform; radii are scaled by 1/spacing."""
        out = self.data.copy()
        out[:, X:Z + 1] = grid.world_to_vertex(self.data[:, X:Z + 1])
        r = self.data[:, RADIUS] / np.float32(grid.spacing)
        out[:, RADIUS] = 1.0 / (r * r)
        return out


def block_inputs(splats: np.ndarray, grid):
    """World-frame splats -> a block step's inputs: (grid-frame (N, 8) f32
    with col 3 = radius in cells, valid (N,) bool). Splats stay in the
    global grid frame: block-dependent f32 rounding would break
    cross-block determinism. The streamer's loader runs this for a worker
    thread, a worker process for itself (pipeline/workers.py): the same
    numpy code on the same bytes, so the same bits."""
    arr = SplatArray(splats)
    grid_form = arr.to_grid_frame(grid)
    # to_grid_frame put 1/r^2 in col 3; binning wants the radius.
    grid_form[:, 3] = splats[:, 3] / np.float32(grid.spacing)
    return grid_form, arr.is_finite()


def decode_raw_splats(raw: np.ndarray, smooth: float, max_radius: float) -> np.ndarray:
    """Decode (N, 7) raw PLY fields [x y z nx ny nz radius] into the (N, 8)
    splat layout, applying the radius clamp + smoothing scale and computing
    quality = 1/r^2 (reference FastPly::Reader::decode, src/fast_ply.cpp:334-350)."""
    n = raw.shape[0]
    out = np.empty((n, NUM_FIELDS), dtype=np.float32)
    out[:, X:Z + 1] = raw[:, 0:3]
    out[:, NX:NZ + 1] = raw[:, 3:6]
    r = np.minimum(raw[:, 6], np.float32(max_radius)) * np.float32(smooth)
    out[:, RADIUS] = r
    out[:, QUALITY] = 1.0 / (r * r)
    return out
