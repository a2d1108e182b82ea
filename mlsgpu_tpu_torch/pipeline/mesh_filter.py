"""Mesh filters (port of mlsgpu_tpu/pipeline/mesh_filter.py; the
reference's MeshFilterChain, src/mesh_filter.h:57-170, with its ScaleBias
kernel, kernels/scale_bias.cl:33-45).

Host filters (`ScaleBiasFilter`, `MeshFilterChain`) transform each block's
decoded numpy mesh in global grid coordinates, through
`reconstruct(filters=...)`. A device filter (`DeviceScaleBias`,
`DeviceFilterChain`) transforms each block's welded vertices on the device,
before the readback, in block-local grid coordinates; the block step then
reads back raw arrays, since filtered vertices leave the cell-edge lattice
the quantized layouts encode.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

MeshFilter = Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


class ScaleBiasFilter:
    """vertices * scale + bias on the host (the reference's ScaleBiasFilter,
    src/mesh_filter.h:66-130). Grid objects provide the world transform."""

    def __init__(self, scale: float = 1.0, bias=(0.0, 0.0, 0.0)):
        self.scale = np.float32(scale)
        self.bias = np.asarray(bias, dtype=np.float32)

    @classmethod
    def from_grid(cls, grid) -> "ScaleBiasFilter":
        ext_lo = np.array([e[0] for e in grid.extents], np.float32)
        bias = np.asarray(grid.reference, np.float32) \
            + ext_lo * np.float32(grid.spacing)
        return cls(scale=grid.spacing, bias=bias)

    def __call__(self, vertices: np.ndarray, triangles: np.ndarray):
        return vertices * self.scale + self.bias, triangles


class MeshFilterChain:
    """Ordered composition of host filters (src/mesh_filter.h:132-170)."""

    def __init__(self, filters: Sequence[MeshFilter] = ()):
        self.filters: List[MeshFilter] = list(filters)

    def add_filter(self, f: MeshFilter) -> None:
        self.filters.append(f)

    def __call__(self, vertices: np.ndarray, triangles: np.ndarray):
        for f in self.filters:
            vertices, triangles = f(vertices, triangles)
        return vertices, triangles


class DeviceScaleBias:
    """vertices * scale + bias in global grid coordinates, on the device."""

    def __init__(self, scale: float = 1.0, bias=(0.0, 0.0, 0.0)):
        self.scale = float(scale)
        self.bias = tuple(float(b) for b in bias)

    def __call__(self, vertices: torch.Tensor,
                 cell_origin: Sequence[int]) -> torch.Tensor:
        # The vertices are block-local and the host later adds the unscaled
        # block origin, so apply the map in global coordinates and take the
        # origin off again: the result lands on scale * (v + origin) + bias
        # whichever block computed the vertex (scale != 1 would otherwise
        # make shared vertices of adjacent blocks disagree).
        dev = vertices.device
        org = torch.as_tensor([float(v) for v in cell_origin],
                              dtype=torch.float32, device=dev)
        b = torch.as_tensor(self.bias, dtype=torch.float32, device=dev)
        return (vertices + org) * self.scale + b - org


class DeviceFilterChain:
    """Ordered composition of device vertex filters."""

    def __init__(self, filters: Sequence = ()):
        self.filters = tuple(filters)

    def __call__(self, vertices: torch.Tensor,
                 cell_origin: Sequence[int]) -> torch.Tensor:
        for f in self.filters:
            vertices = f(vertices, cell_origin)
        return vertices
