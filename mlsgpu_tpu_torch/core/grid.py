"""Regular sampling grid (reference src/grid.{h,cpp}).

A grid is a reference (world) point, a spacing, and half-open per-axis extents
expressed in cell units relative to the reference point. Vertex (i,j,k) lies at
reference + spacing * (extent_lo + (i,j,k)).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class Grid:
    reference: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    spacing: float = 1.0
    # extents[axis] = (lo, hi): vertices lo..hi inclusive-exclusive in cells
    extents: Tuple[Tuple[int, int], ...] = (((0, 1),) * 3)

    @staticmethod
    def make(reference, spacing, extents) -> "Grid":
        extents = tuple((int(lo), int(hi)) for lo, hi in extents)
        for lo, hi in extents:
            if lo > hi:
                raise ValueError("grid extent must be non-empty")
        return Grid(tuple(float(r) for r in reference), float(spacing), extents)

    def num_vertices(self, axis: int) -> int:
        lo, hi = self.extents[axis]
        return hi - lo + 1

    def num_cells_axis(self, axis: int) -> int:
        lo, hi = self.extents[axis]
        return hi - lo

    @property
    def shape_cells(self) -> Tuple[int, int, int]:
        return tuple(self.num_cells_axis(a) for a in range(3))

    def num_cells(self) -> int:
        n = 1
        for a in range(3):
            n *= self.num_cells_axis(a)
        return n

    def get_vertex(self, i: int, j: int, k: int) -> np.ndarray:
        ijk = np.array([i, j, k], dtype=np.float64)
        lo = np.array([e[0] for e in self.extents], dtype=np.float64)
        return (np.asarray(self.reference, dtype=np.float64)
                + self.spacing * (ijk + lo)).astype(np.float32)

    def world_to_vertex(self, world: np.ndarray) -> np.ndarray:
        """Continuous grid coordinates of world points, relative to extent lo.

        Computed the invariant way (reference Grid::worldToVertex,
        src/grid.cpp:99-106): scale about the reference point first, subtract
        the integer extent bias after, so results shift by exactly X when the
        extent shifts by X.
        """
        world = np.asarray(world, dtype=np.float32)
        inv = np.float32(1.0) / np.float32(self.spacing)
        ref = np.asarray(self.reference, dtype=np.float32)
        lo = np.array([e[0] for e in self.extents], dtype=np.float32)
        return (world - ref) * inv - lo

    def world_to_cell(self, world: np.ndarray) -> np.ndarray:
        """Integer cell containing world points (invariant rounding,
        reference Grid::worldToCell src/grid.cpp:108-130): round down in the
        unbiased frame, subtract the extent bias as integers."""
        world = np.asarray(world, dtype=np.float32)
        inv = np.float32(1.0) / np.float32(self.spacing)
        ref = np.asarray(self.reference, dtype=np.float32)
        raw = (world - ref) * inv
        if not np.all(np.isfinite(raw)):
            raise ValueError("non-finite world coordinate")
        lo = np.array([e[0] for e in self.extents], dtype=np.int64)
        return np.floor(raw).astype(np.int64) - lo

    def sub_grid(self, x0: int, x1: int, y0: int, y1: int, z0: int, z1: int) -> "Grid":
        """Same reference/spacing, new extents relative to this grid
        (reference Grid::subGrid)."""
        if not (x0 <= x1 and y0 <= y1 and z0 <= z1):
            raise ValueError("invalid subgrid range")
        e = self.extents
        return replace(self, extents=(
            (e[0][0] + x0, e[0][0] + x1),
            (e[1][0] + y0, e[1][0] + y1),
            (e[2][0] + z0, e[2][0] + z1),
        ))
