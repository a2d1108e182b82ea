"""The per-block device step: binning -> MLS field (kernel) -> canonical
faces and skeleton points -> marching codes -> one packed readback image
(port of the codes branch of mlsgpu_tpu/ops/block.py::block_step_body).

PyTorch runs eagerly, so the step is a plain function; the marching outputs
are sized from their true counts, so no cap can overflow and no retry is
needed. The host rebuilds and welds the mesh from the packed image
(_native.rebuild_block).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from mlsgpu_tpu_torch.ops import binning, marching, mls, mls_cuda


#: Order of the scalars inside BlockResult.counts (the JAX package's order;
#: the welded count and first external vertex are known only after the host
#: rebuild, max_tile_candidates and num_march_tiles are 0: no caps).
COUNTS_FIELDS = ("num_vertices", "first_external", "num_indices",
                 "max_tile_candidates", "num_cells", "num_unwelded",
                 "num_occ_tiles", "num_march_tiles")


class BlockResult(NamedTuple):
    packed: torch.Tensor   # (words,) int32 codes image (u32 bits), CodesFormat layout
    counts: np.ndarray     # (8,) int64 in COUNTS_FIELDS order

    @property
    def num_cells(self) -> int:        # occupied cells
        return int(self.counts[4])

    @property
    def num_unwelded(self) -> int:     # emitted (pre-weld) vertices
        return int(self.counts[5])

    @property
    def num_indices(self) -> int:      # triangle indices of the host rebuild
        return int(self.counts[2])

    @property
    def num_occ_tiles(self) -> int:    # MLS tiles with candidates
        return int(self.counts[6])


def fetch_counts(result: BlockResult) -> np.ndarray:
    """The result's count scalars, COUNTS_FIELDS order."""
    return np.asarray(result.counts, np.int64)


class CodesFormat(NamedTuple):
    """Layout of the codes readback image: one flat u32 buffer
    `[cells u32 | case codes u8 (4/word) | t16 u16 (2/word)]`. nc_axis (cells
    per axis of the block's dense volume) lets the host decode flat cell
    ids."""
    nc_axis: int

    def total_words(self, num_cells: int, num_unwelded: int) -> int:
        return (num_cells + (num_cells + 3) // 4
                + (num_unwelded + 1) // 2)


def codes_format(levels: int, subsampling: int) -> Optional[CodesFormat]:
    """Codes layout for a block size, or None when flat cell ids would not
    fit u32 (more than 2^10 corners per axis)."""
    nc_axis = (1 << (levels + subsampling - 1)) - 1
    if nc_axis + 1 > 1 << 10:
        return None
    return CodesFormat(nc_axis=nc_axis)


def _bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """Little-endian packing of a flat uint8 tensor into int32 words (the
    u32 bits the host reads back with ndarray.view(np.uint32))."""
    pad = (-b.shape[0]) % 4
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return b.view(torch.int32)


def pack_codes(cmesh: marching.BlockCodes) -> torch.Tensor:
    """The codes image of one block: cells, then case codes 4 per word, then
    t16 2 per word, each region starting where the previous live one ends —
    bitwise the live prefix of the JAX package's `_pack_codes` image."""
    cells = cmesh.cell_ids.to(torch.int32)
    codes = _bytes_to_words(cmesh.cell_codes.to(torch.uint8))
    t16 = cmesh.t16
    t_bytes = torch.stack([t16 & 0xFF, t16 >> 8], dim=1).reshape(-1)
    return torch.cat([cells, codes, _bytes_to_words(t_bytes.to(torch.uint8))])


def block_field(splats: torch.Tensor, valid: torch.Tensor,
                region_cells: Sequence[int], cell_origin: Sequence[int],
                boundary_factor: float, points: Optional[torch.Tensor] = None,
                *, levels: int, subsampling: int, fit_shape: str = "sphere"):
    """The seam-canonical MLS field of one block: (field (B,B,B) [z, y, x],
    n_occ tensor). splats (N, 8) f32 in global grid coords (col 3 = radius),
    valid (N,) bool, region_cells/cell_origin 3 host ints (x, y, z), points
    (P, 3) global skeleton corners or None."""
    min_shift = subsampling
    max_shift = levels + subsampling - 1
    tpa = 1 << (max_shift - 3)  # block corners / 8
    binned = binning.bin_splats(splats, valid, cell_origin, min_shift,
                                max_shift)
    starts, lens = binning.tile_segments(binned.entry_keys, min_shift,
                                         max_shift, tpa)
    field, _, n_occ = mls_cuda.eval_field(
        binned.entry_data, starts, lens, cell_origin, tpa, fit_shape,
        boundary_factor)
    mls.canonical_face_field(field, binned.entry_data, binned.entry_vals,
                             starts, lens, cell_origin, region_cells, tpa,
                             fit_shape, boundary_factor)
    if points is not None and points.shape[0] > 0:
        mls.skeleton_point_field(field, binned.entry_data, binned.entry_vals,
                                 starts, lens, cell_origin, points, tpa,
                                 fit_shape, boundary_factor)
    return field, n_occ


def block_step(splats: torch.Tensor, valid: torch.Tensor,
               region_cells: Sequence[int], cell_origin: Sequence[int],
               boundary_factor: float, points: Optional[torch.Tensor] = None,
               *, levels: int, subsampling: int,
               fit_shape: str = "sphere") -> BlockResult:
    """Reconstruct one block on the tensors' device into a codes image."""
    field, n_occ = block_field(splats, valid, region_cells, cell_origin,
                               boundary_factor, points, levels=levels,
                               subsampling=subsampling, fit_shape=fit_shape)
    cmesh = marching.generate_codes(field, region_cells)
    counts = np.array([cmesh.num_vertices, 0, cmesh.num_indices, 0,
                       cmesh.num_cells, cmesh.num_vertices, int(n_occ), 0],
                      np.int64)
    return BlockResult(packed=pack_codes(cmesh), counts=counts)
