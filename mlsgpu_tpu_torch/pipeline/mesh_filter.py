"""Device mesh filters on torch tensors (port of the device half of
mlsgpu_tpu/pipeline/mesh_filter.py; the reference's MeshFilterChain,
src/mesh_filter.h:57-170, with its ScaleBias kernel,
kernels/scale_bias.cl:33-45).

A device filter transforms each block's welded vertices on the device,
before the readback, in block-local grid coordinates; the block step then
reads back raw arrays, since filtered vertices leave the cell-edge lattice
the quantized layouts encode. The host filters (`ScaleBiasFilter`,
`MeshFilterChain`, run on each block's host arrays through
`reconstruct(filters=...)`) are the JAX package's own: they are numpy.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mlsgpu_tpu.pipeline.mesh_filter import (MeshFilterChain,  # noqa: F401
                                             ScaleBiasFilter)


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
