"""Marching-tetrahedra classification and codes emission over a dense
corner field (port of mlsgpu_tpu/ops/marching.py: `_classify_dense` and
`generate(emit="codes")`).

Every cell of the (B-1)^3 volume gets a case code from its 8 corner signs;
cells that are finite, inside the bucket region and cut by the surface are
compacted in tile-major order (8^3-cell tiles in (tz, ty, tx) order, raster
order inside a tile) — the order the JAX package's two-level compaction
produces, which the rerun-identical-output contract rests on. Per emitted
vertex, one 16-bit interpolant t = iso0 / (iso0 - iso1) travels to the host,
which rebuilds and welds the block mesh natively (_native.rebuild_block).

Outputs are sized from the true counts (one host sync), so there are no
cell or vertex caps to overflow.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from mlsgpu_tpu.ops import tables

TILE = 8  # cells per axis of a compaction tile

# (8, 3) corner offsets; corner id bit a = offset along axis a.
CORNER_OFFS = np.array([[(v >> a) & 1 for a in range(3)] for v in range(8)],
                       dtype=np.int64)


class BlockCodes(NamedTuple):
    """Codes-mode marching output, live entries only."""
    cell_ids: torch.Tensor    # (num_cells,) int64 flat cell id cz*nc^2 + cy*nc + cx
    cell_codes: torch.Tensor  # (num_cells,) int64 8-bit case codes
    t16: torch.Tensor         # (num_vertices,) int64 16-bit interpolants,
    #                           emission order = v_start[cell] + j
    num_cells: int
    num_vertices: int         # unwelded emission count
    num_indices: int


def classify_dense(field: torch.Tensor, region_cells: Sequence[int]):
    """Case codes and tile-major compaction of the occupied cells.

    Returns (codes (M,), cells (M, 3) int64 (x, y, z), isos (M, 8)) for the
    M occupied cells."""
    b = field.shape[0]
    nc = b - 1
    code = torch.zeros((nc, nc, nc), dtype=torch.int64, device=field.device)
    finite = torch.ones((nc, nc, nc), dtype=torch.bool, device=field.device)
    for v, (dx, dy, dz) in enumerate(CORNER_OFFS):
        cv = field[dz:dz + nc, dy:dy + nc, dx:dx + nc]
        code |= (cv >= 0.0).to(torch.int64) << v
        finite &= torch.isfinite(cv)
    rx, ry, rz = (int(v) for v in region_cells)
    in_region = torch.zeros_like(finite)
    in_region[:rz, :ry, :rx] = True
    occupied = finite & in_region & (code != 0) & (code != 255)

    g = -(-nc // TILE)
    pad = g * TILE - nc
    occp = torch.nn.functional.pad(occupied, (0, pad, 0, pad, 0, pad))
    otiles = (occp.reshape(g, TILE, g, TILE, g, TILE)
              .permute(0, 2, 4, 1, 3, 5).reshape(-1))
    flat = torch.nonzero(otiles).squeeze(1)       # tile-major, raster within
    tile, loc = flat // TILE ** 3, flat % TILE ** 3
    cx = (tile % g) * TILE + loc % TILE
    cy = ((tile // g) % g) * TILE + (loc // TILE) % TILE
    cz = (tile // (g * g)) * TILE + loc // (TILE * TILE)
    occ_code = code[cz, cy, cx]
    offs = torch.as_tensor(CORNER_OFFS, device=field.device)
    isos = field[cz[:, None] + offs[None, :, 2], cy[:, None] + offs[None, :, 1],
                 cx[:, None] + offs[None, :, 0]]
    return occ_code, torch.stack([cx, cy, cz], dim=1), isos


def generate_codes(field: torch.Tensor,
                   region_cells: Sequence[int]) -> BlockCodes:
    """Marching tetrahedra on a (B, B, B) field indexed [z, y, x] (NaN =
    undefined), codes mode: the compacted cell ids and case codes plus one
    t16 per emitted (unwelded) vertex."""
    dev = field.device
    nc = field.shape[0] - 1
    codes, cells, isos = classify_dense(field, region_cells)
    count_tab = torch.as_tensor(tables.COUNT_TABLE, dtype=torch.int64,
                                device=dev)
    nv_c = count_tab[codes, 0]
    num_cells = int(codes.shape[0])
    num_vertices = int(nv_c.sum())
    num_indices = int(count_tab[codes, 1].sum())

    # Vertex j of cell i is emitted at slot v_start[i] + j.
    prod = torch.repeat_interleave(
        torch.arange(num_cells, device=dev), nv_c, output_size=num_vertices)
    v_start = torch.cumsum(nv_c, 0) - nv_c
    j = torch.arange(num_vertices, device=dev) - v_start[prod]
    vert_tab = torch.as_tensor(tables.VERT_TABLE, dtype=torch.int64,
                               device=dev)
    edges = torch.as_tensor(tables.EDGES, dtype=torch.int64, device=dev)
    vedge = vert_tab[codes[prod], j]
    viso = isos[prod]
    iso0 = torch.gather(viso, 1, edges[vedge, 0][:, None])[:, 0]
    iso1 = torch.gather(viso, 1, edges[vedge, 1][:, None])[:, 0]
    t = iso0 / (iso0 - iso1)
    t16 = torch.clamp(torch.round(t * 65535.0), 0, 65535).to(torch.int64)

    cell_ids = (cells[:, 2] * nc + cells[:, 1]) * nc + cells[:, 0]
    return BlockCodes(cell_ids=cell_ids, cell_codes=codes, t16=t16,
                      num_cells=num_cells, num_vertices=num_vertices,
                      num_indices=num_indices)
