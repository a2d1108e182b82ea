"""Marching-tetrahedra classification and emission over a dense corner
field (port of mlsgpu_tpu/ops/marching.py: `_classify_dense`,
`_classify_tiled` and `generate(emit="codes"|"mesh")`).

Every cell of the (B-1)^3 volume gets a case code from its 8 corner signs;
cells that are finite, inside the bucket region and cut by the surface are
compacted in tile-major order (8^3-cell tiles in (tz, ty, tx) order, raster
order inside a tile) — the order the JAX package's two-level compaction
produces, which the rerun-identical-output contract rests on. Dense
classification computes codes over the whole volume; tiled classification
(above 2^8 corners per axis, the JAX package's rule) first keeps the 8^3
tiles that hold any finite corner and classifies only those, in the same
order, so both give bitwise the same cells.

Codes mode emits per vertex one 16-bit interpolant t = iso0 / (iso0 - iso1)
for the host to rebuild and weld natively (_native.rebuild_block); mesh mode
emits block-local vertices, 64-bit weld keys and triangles for the device
weld (ops/weld.py).

Outputs are sized from the true counts (one host sync), so there are no
tile, cell, vertex or index caps to overflow.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from mlsgpu_tpu_torch.ops import tables

TILE = 8  # cells per axis of a compaction tile

#: Corners per axis above which classification is tiled (the JAX package's
#: default_march_tile_cap rule, mlsgpu_tpu/pipeline/reconstruct.py:73-88).
TILED_ABOVE = 1 << 8

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
    num_tiles: int = 0        # candidate tiles (tiled classification)


class BlockMesh(NamedTuple):
    """Mesh-mode marching output (unwelded), live entries only."""
    vertices: torch.Tensor    # (num_vertices, 3) f32 block-local grid coords
    key_hi: torch.Tensor      # (num_vertices,) int64 u32: ext<<31 | z<<10 | y>>11
    key_lo: torch.Tensor      # (num_vertices,) int64 u32: (y & 0x7FF)<<21 | x
    triangles: torch.Tensor   # (num_indices // 3, 3) int64 into vertices
    num_cells: int
    num_vertices: int
    num_indices: int
    num_tiles: int = 0


def classify_dense(field: torch.Tensor, region_cells: Sequence[int]):
    """Case codes and tile-major compaction of the occupied cells.

    Returns (codes (M,), cells (M, 3) int64 (x, y, z), isos (M, 8), 0) for
    the M occupied cells (the 0 stands for classify_tiled's tile count)."""
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
    return occ_code, torch.stack([cx, cy, cz], dim=1), isos, 0


def classify_tiled(field: torch.Tensor, region_cells: Sequence[int]):
    """classify_dense over candidate tiles only: one dense finite-reduction
    keeps the 8^3-cell tiles with any finite corner in their own 8^3 corner
    region (a cell is occupied only if all its corners are finite, its base
    corner included), then each candidate's 9^3 corner subvolume is gathered
    and classified. Candidates are sized from their true count and hold
    ascending tile ids, and cells stay raster-ordered inside a tile, so the
    result is bitwise classify_dense's.

    Returns (codes, cells, isos, number of candidate tiles)."""
    dev = field.device
    b = field.shape[0]
    nc = b - 1
    g = -(-nc // TILE)
    gb = g * TILE + 1
    pad = gb - b
    # NaN pad: pad cells are undefined (and outside the region anyway).
    fpad = torch.nn.functional.pad(field, (0, pad, 0, pad, 0, pad),
                                   value=float("nan"))
    gt = g * TILE
    cand = (torch.isfinite(fpad[:gt, :gt, :gt])
            .reshape(g, TILE, g, TILE, g, TILE).permute(0, 2, 4, 1, 3, 5)
            .reshape(g ** 3, TILE ** 3).any(dim=1))
    tids = torch.nonzero(cand).squeeze(1)            # ascending tile ids
    t_x, t_y, t_z = tids % g, (tids // g) % g, tids // (g * g)

    # Each candidate's 9^3 corner subvolume (the +1 halo row belongs to the
    # next tile; gb - 1 == g * TILE keeps the indices in range).
    r9 = torch.arange(TILE + 1, device=dev)
    zi = t_z[:, None] * TILE + r9
    yi = t_y[:, None] * TILE + r9
    xi = t_x[:, None] * TILE + r9
    tf = fpad[zi[:, :, None, None], yi[:, None, :, None],
              xi[:, None, None, :]]                  # (T, 9, 9, 9)

    nt = tids.shape[0]
    code = torch.zeros((nt, TILE, TILE, TILE), dtype=torch.int64, device=dev)
    finite = torch.ones((nt, TILE, TILE, TILE), dtype=torch.bool, device=dev)
    for v, (dx, dy, dz) in enumerate(CORNER_OFFS):
        cv = tf[:, dz:dz + TILE, dy:dy + TILE, dx:dx + TILE]
        code |= (cv >= 0.0).to(torch.int64) << v
        finite &= torch.isfinite(cv)
    lr = torch.arange(TILE, device=dev)
    rx, ry, rz = (int(v) for v in region_cells)
    in_region = (((t_x[:, None, None, None] * TILE + lr[None, None, None, :])
                  < rx)
                 & ((t_y[:, None, None, None] * TILE + lr[None, None, :, None])
                    < ry)
                 & ((t_z[:, None, None, None] * TILE + lr[None, :, None, None])
                    < rz))
    occupied = finite & in_region & (code != 0) & (code != 255)

    flat = torch.nonzero(occupied.reshape(-1)).squeeze(1)  # slot-major
    slot, loc = flat // TILE ** 3, flat % TILE ** 3
    l_x, l_y, l_z = loc % TILE, (loc // TILE) % TILE, loc // (TILE * TILE)
    cx = t_x[slot] * TILE + l_x
    cy = t_y[slot] * TILE + l_y
    cz = t_z[slot] * TILE + l_z
    occ_code = code.reshape(-1)[flat]
    offs = torch.as_tensor(CORNER_OFFS, device=dev)
    isos = tf[slot[:, None], l_z[:, None] + offs[None, :, 2],
              l_y[:, None] + offs[None, :, 1], l_x[:, None] + offs[None, :, 0]]
    return occ_code, torch.stack([cx, cy, cz], dim=1), isos, nt


def classify(field: torch.Tensor, region_cells: Sequence[int],
             tiled: Optional[bool] = None):
    """Tiled classification above TILED_ABOVE corners per axis, dense at or
    below it, unless `tiled` chooses. Returns (codes, cells, isos,
    candidate tiles or 0)."""
    if tiled is None:
        tiled = field.shape[0] > TILED_ABOVE
    return (classify_tiled if tiled else classify_dense)(field, region_cells)


def _emission(codes: torch.Tensor, per_cell: torch.Tensor, total: int):
    """(producing cell, rank inside the cell) of each of `total` output
    slots when cell i emits per_cell[i] slots starting at the exclusive
    prefix sum (the emission order)."""
    dev = codes.device
    prod = torch.repeat_interleave(torch.arange(codes.shape[0], device=dev),
                                   per_cell, output_size=total)
    start = torch.cumsum(per_cell, 0) - per_cell
    return prod, torch.arange(total, device=dev) - start[prod], start


def _edge_isos(isos: torch.Tensor, prod: torch.Tensor, vedge: torch.Tensor):
    edges = torch.as_tensor(tables.EDGES, dtype=torch.int64,
                            device=isos.device)
    viso = isos[prod]
    e0, e1 = edges[vedge, 0], edges[vedge, 1]
    iso0 = torch.gather(viso, 1, e0[:, None])[:, 0]
    iso1 = torch.gather(viso, 1, e1[:, None])[:, 0]
    return iso0, iso1, e0, e1


def _counts(codes: torch.Tensor):
    count_tab = torch.as_tensor(tables.COUNT_TABLE, dtype=torch.int64,
                                device=codes.device)
    nv_c, ni_c = count_tab[codes, 0], count_tab[codes, 1]
    totals = torch.stack([nv_c.sum(), ni_c.sum()]).tolist()  # one sync
    return nv_c, ni_c, int(totals[0]), int(totals[1])


def generate_codes(field: torch.Tensor, region_cells: Sequence[int],
                   tiled: Optional[bool] = None) -> BlockCodes:
    """Marching tetrahedra on a (B, B, B) field indexed [z, y, x] (NaN =
    undefined), codes mode: the compacted cell ids and case codes plus one
    t16 per emitted (unwelded) vertex."""
    nc = field.shape[0] - 1
    codes, cells, isos, num_tiles = classify(field, region_cells, tiled)
    nv_c, _, num_vertices, num_indices = _counts(codes)

    # Vertex j of cell i is emitted at slot v_start[i] + j.
    prod, j, _ = _emission(codes, nv_c, num_vertices)
    vert_tab = torch.as_tensor(tables.VERT_TABLE, dtype=torch.int64,
                               device=field.device)
    iso0, iso1, _, _ = _edge_isos(isos, prod, vert_tab[codes[prod], j])
    t = iso0 / (iso0 - iso1)
    t16 = torch.clamp(torch.round(t * 65535.0), 0, 65535).to(torch.int64)

    cell_ids = (cells[:, 2] * nc + cells[:, 1]) * nc + cells[:, 0]
    return BlockCodes(cell_ids=cell_ids, cell_codes=codes, t16=t16,
                      num_cells=int(codes.shape[0]),
                      num_vertices=num_vertices, num_indices=num_indices,
                      num_tiles=num_tiles)


def codes_words(num_cells: int, num_vertices: int) -> int:
    """Int32 words of a block's codes image (block.CodesFormat): the cell
    ids, then the case codes 4 a word, then the t16 2 a word."""
    return num_cells + (num_cells + 3) // 4 + (num_vertices + 1) // 2


def _bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """Little-endian packing of a flat uint8 tensor into int32 words (the
    u32 bits the host reads back with ndarray.view(np.uint32))."""
    pad = (-b.shape[0]) % 4
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return b.view(torch.int32)


def u16_to_words(u16: torch.Tensor) -> torch.Tensor:
    """Flat int64 tensor of u16 values -> int32 words, two per word,
    little-endian (the JAX package's _u16_pairs_to_u32)."""
    u16 = u16.reshape(-1)
    b = torch.stack([u16 & 0xFF, u16 >> 8], dim=1).reshape(-1)
    return _bytes_to_words(b.to(torch.uint8))


def pack_codes(cmesh: BlockCodes) -> torch.Tensor:
    """The codes image of one block: cells, then case codes 4 per word, then
    t16 2 per word, each region starting where the previous live one ends —
    bitwise the live prefix of the JAX package's `_pack_codes` image."""
    cells = cmesh.cell_ids.to(torch.int32)
    codes = _bytes_to_words(cmesh.cell_codes.to(torch.uint8))
    return torch.cat([cells, codes, u16_to_words(cmesh.t16)])


def generate_mesh(field: torch.Tensor, region_cells: Sequence[int],
                  cell_origin: Sequence[int],
                  tiled: Optional[bool] = None) -> BlockMesh:
    """Marching tetrahedra, mesh mode: block-local vertices, weld keys and
    triangles of the unwelded mesh, in emission order (the JAX package's
    `generate(emit="mesh")` live prefix).

    Keys use the reference's scheme (kernels/marching.cl:144-163): 21 bits
    per axis of the doubled global edge-midpoint coordinate, packed into
    (hi, lo) u32 halves with the external flag (the vertex lies on one of
    the region's six faces) in bit 31 of hi."""
    dev = field.device
    codes, cells, isos, num_tiles = classify(field, region_cells, tiled)
    nv_c, ni_c, num_vertices, num_indices = _counts(codes)

    prod, j, v_start = _emission(codes, nv_c, num_vertices)
    vert_tab = torch.as_tensor(tables.VERT_TABLE, dtype=torch.int64,
                               device=dev)
    vedge = vert_tab[codes[prod], j]
    iso0, iso1, e0, e1 = _edge_isos(isos, prod, vedge)
    offs = torch.as_tensor(CORNER_OFFS, device=dev)
    cell_xyz = cells[prod]
    off0, off1 = offs[e0], offs[e1]
    t = (iso0 / (iso0 - iso1))[:, None]
    vertices = ((cell_xyz + off0).to(torch.float32)
                + t * (off1 - off0).to(torch.float32))

    edge_key = torch.as_tensor(tables.EDGE_KEY, dtype=torch.int64, device=dev)
    kc_local = 2 * cell_xyz + edge_key[vedge]
    kc = kc_local + 2 * torch.as_tensor(cell_origin, dtype=torch.int64,
                                        device=dev)
    top = 2 * torch.as_tensor(region_cells, dtype=torch.int64, device=dev)
    ext = ((kc_local == 0).any(dim=1) | (kc_local == top).any(dim=1))
    key_lo = (kc[:, 0] | ((kc[:, 1] & 0x7FF) << 21)) & 0xFFFFFFFF
    key_hi = ((kc[:, 1] >> 11) | (kc[:, 2] << 10)
              | (ext.to(torch.int64) << 31)) & 0xFFFFFFFF

    # Triangle k of cell i is emitted at slot i_start[i] / 3 + k.
    tprod, k, _ = _emission(codes, ni_c // 3, num_indices // 3)
    index_tab = torch.as_tensor(tables.INDEX_TABLE, dtype=torch.int64,
                                device=dev)
    kk = 3 * k[:, None] + torch.arange(3, device=dev)
    triangles = v_start[tprod][:, None] + index_tab[codes[tprod][:, None], kk]
    return BlockMesh(vertices=vertices, key_hi=key_hi, key_lo=key_lo,
                     triangles=triangles, num_cells=int(codes.shape[0]),
                     num_vertices=num_vertices, num_indices=num_indices,
                     num_tiles=num_tiles)
