"""The per-block device step: binning -> MLS field (kernel) -> canonical
faces and skeleton points (kernels) -> marching -> one readback (port of
mlsgpu_tpu/ops/block.py: `block_step_body`, `block_step_staged`, the
packed and codes layouts and their host decoders).

Three readback modes, as in the JAX package:
- "codes": marching codes packed into one image; the host rebuilds and
  welds the mesh natively (_native.rebuild_block);
- "packed": marching emits the mesh, the device welds it (ops/weld.py) and
  quantizes it into one image (PackFormat); the host decodes it
  (_native.unpack_readback);
- "raw": the welded arrays themselves (the mode a device filter needs: its
  vertices leave the cell-edge lattice the packed layout encodes).

PyTorch runs eagerly, so the step is a plain function; every output is
sized from its true count, so no cap can overflow and no retry is needed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from mlsgpu_tpu_torch.utils.statistics import get_registry

from mlsgpu_tpu_torch.ops import (binning, marching, mls, mls_cuda, seam_cuda,
                                  weld)


#: Order of the scalars inside BlockResult.counts (the JAX package's order).
#: In codes mode the welded count and first external vertex are known only
#: after the host rebuild (slots 0 and 1 hold the unwelded count and 0).
#: max_tile_candidates is 0 (no candidate cap); num_march_tiles counts the
#: candidate tiles of tiled classification (0 when it ran dense).
COUNTS_FIELDS = ("num_vertices", "first_external", "num_indices",
                 "max_tile_candidates", "num_cells", "num_unwelded",
                 "num_occ_tiles", "num_march_tiles")

READBACK_MODES = ("codes", "packed", "raw")


class CodesFormat(NamedTuple):
    """Layout of the codes readback image: one flat u32 buffer
    `[cells u32 | case codes u8 (4/word) | t16 u16 (2/word)]`. nc_axis (cells
    per axis of the block's dense volume) lets the host decode flat cell
    ids."""
    nc_axis: int

    def total_words(self, num_cells: int, num_unwelded: int) -> int:
        return (num_cells + (num_cells + 3) // 4
                + (num_unwelded + 1) // 2)


class PackFormat(NamedTuple):
    """Layout of the quantized readback image `[index region | vertex
    region]` (mlsgpu_tpu/ops/block.py::PackFormat).

    * index region — welded triangle indices: 'u16' one u16 per index, 2 per
      word (<= 2^16 vertices); 'u21x3' three 21-bit indices per triangle in
      2 words (<= 2^21 vertices); 'u32' raw i32 bits.
    * vertex region — `vertex_words` u16 per welded vertex. A marching
      vertex lies on a cell edge: per axis, the doubled edge-midpoint
      coordinate kl (from the weld key) gives base = kl >> 1, a parity bit
      (kl odd: the vertex moves along this axis) and a direction bit (the
      fraction is 1 - t rather than t); one shared t travels as 16-bit fixed
      point. vertex_words 3 (coord_bits <= 8): w[a] = base | parity << 8 |
      dir << 9 | t16 part << 10 (t16 split 6 + 6 + 4); vertex_words 4
      (coord_bits <= 13): w[a] = base | parity << 13 | dir << 14, w[3] = t16.
    The host rebuilds the f32 position and the 64-bit weld key from it.
    """
    index_mode: str
    vertex_words: int
    coord_bits: int

    def index_words(self, num_indices: int) -> int:
        if self.index_mode == "u16":
            return (num_indices + 1) // 2
        if self.index_mode == "u21x3":
            return 2 * (num_indices // 3)
        return num_indices

    def vertex_region_words(self, num_vertices: int) -> int:
        return (num_vertices * self.vertex_words + 1) // 2

    def total_words(self, num_indices: int, num_vertices: int) -> int:
        return (self.index_words(num_indices)
                + self.vertex_region_words(num_vertices))


Format = Union[CodesFormat, PackFormat, None]


class CountsView:
    """Named accessors over a result's `counts` (COUNTS_FIELDS order), shared
    by the device result (BlockResult) and the streamer's host block."""
    __slots__ = ()

    @property
    def num_vertices(self) -> int:     # welded (unwelded in codes mode)
        return int(self.counts[0])

    @property
    def first_external(self) -> int:
        return int(self.counts[1])

    @property
    def num_indices(self) -> int:      # triangle indices
        return int(self.counts[2])

    @property
    def num_cells(self) -> int:        # occupied cells
        return int(self.counts[4])

    @property
    def num_unwelded(self) -> int:     # emitted (pre-weld) vertices
        return int(self.counts[5])

    @property
    def num_occ_tiles(self) -> int:    # MLS tiles with candidates
        return int(self.counts[6])


class _BlockResult(NamedTuple):
    packed: Optional[torch.Tensor]  # (words,) int32 image (u32 bits): codes
    #                                 or packed layout; None for raw
    counts: np.ndarray              # (8,) int64 in COUNTS_FIELDS order
    readback: str = "codes"         # one of READBACK_MODES
    fmt: Format = None              # layout of `packed`
    mesh: Optional[weld.WeldedMesh] = None  # raw: the welded arrays


class BlockResult(CountsView, _BlockResult):
    """One block step's device readback and its count scalars."""
    __slots__ = ()


def fetch_counts(result: BlockResult) -> np.ndarray:
    """The result's count scalars, COUNTS_FIELDS order."""
    return np.asarray(result.counts, np.int64)


def codes_format(levels: int, subsampling: int) -> Optional[CodesFormat]:
    """Codes layout for a block size, or None when flat cell ids would not
    fit u32 (more than 2^10 corners per axis)."""
    nc_axis = (1 << (levels + subsampling - 1)) - 1
    if nc_axis + 1 > 1 << 10:
        return None
    return CodesFormat(nc_axis=nc_axis)


def pack_format(levels: int, subsampling: int,
                num_vertices: int) -> Optional[PackFormat]:
    """The packed layout of a block with `num_vertices` welded vertices;
    None when the block is beyond the reference's 2^13-corner limit. The
    JAX package picks the index mode from its static vertex cap; the port
    has no caps and picks it per block from the true count."""
    coord_bits = levels + subsampling - 1
    if coord_bits > 13:
        return None
    vertex_words = 3 if coord_bits <= 8 else 4
    if num_vertices <= 1 << 16:
        index_mode = "u16"
    elif num_vertices <= 1 << 21:
        index_mode = "u21x3"
    else:
        index_mode = "u32"
    return PackFormat(index_mode, vertex_words, coord_bits)


def resolve_readback(requested: str, levels: int, subsampling: int) -> str:
    """'auto' -> 'codes' when the native host rebuild is available and the
    block size fits flat u32 cell ids, else 'packed' (the JAX package's
    rule, mlsgpu_tpu/ops/block.py:660-669)."""
    if requested and requested != "auto":
        if requested not in READBACK_MODES:
            raise ValueError(f"unknown readback mode {requested!r}")
        return requested
    from mlsgpu_tpu_torch import _native
    if _native.available() and codes_format(levels, subsampling) is not None:
        return "codes"
    return "packed"


def _bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """Little-endian packing of a flat uint8 tensor into int32 words (the
    u32 bits the host reads back with ndarray.view(np.uint32))."""
    pad = (-b.shape[0]) % 4
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return b.view(torch.int32)


def _u16_to_words(u16: torch.Tensor) -> torch.Tensor:
    """Flat int64 tensor of u16 values -> int32 words, two per word,
    little-endian (the JAX package's _u16_pairs_to_u32)."""
    u16 = u16.reshape(-1)
    b = torch.stack([u16 & 0xFF, u16 >> 8], dim=1).reshape(-1)
    return _bytes_to_words(b.to(torch.uint8))


def _u32_to_words(u32: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 words with the same bits."""
    return torch.where(u32 >= 1 << 31, u32 - (1 << 32), u32).to(torch.int32)


def pack_codes(cmesh: marching.BlockCodes) -> torch.Tensor:
    """The codes image of one block: cells, then case codes 4 per word, then
    t16 2 per word, each region starting where the previous live one ends —
    bitwise the live prefix of the JAX package's `_pack_codes` image."""
    cells = cmesh.cell_ids.to(torch.int32)
    codes = _bytes_to_words(cmesh.cell_codes.to(torch.uint8))
    return torch.cat([cells, codes, _u16_to_words(cmesh.t16)])


def key_to_doubled_local(key_hi: torch.Tensor, key_lo: torch.Tensor,
                         cell_origin: Sequence[int]) -> torch.Tensor:
    """Invert marching's key packing to the per-axis doubled block-local
    edge-midpoint coordinates, (n, 3) int64 (x, y, z)."""
    m21 = 0x1FFFFF
    kx = key_lo & m21
    ky = ((key_lo >> 21) | ((key_hi & 0x3FF) << 11)) & m21
    kz = (key_hi >> 10) & m21
    org = torch.as_tensor(mls.host_ints(cell_origin), dtype=torch.int64,
                          device=key_hi.device)
    return torch.stack([kx, ky, kz], dim=1) - 2 * org


def pack_readback(welded: weld.WeldedMesh, cell_origin: Sequence[int],
                  fmt: PackFormat) -> torch.Tensor:
    """Quantize the welded mesh into one flat int32 image (PackFormat): the
    index region, then the vertex region from where the index region's
    live words end — bitwise the live prefix of the JAX package's
    `_pack_readback` image."""
    tris = welded.triangles
    if fmt.index_mode == "u16":
        idx_words = _u16_to_words(tris)
    elif fmt.index_mode == "u21x3":
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        w0 = (a | ((b & 0x7FF) << 21)) & 0xFFFFFFFF
        w1 = ((b >> 11) | (c << 10)) & 0xFFFFFFFF
        idx_words = _u32_to_words(torch.stack([w0, w1], dim=1).reshape(-1))
    else:
        idx_words = tris.reshape(-1).to(torch.int32)

    kl = key_to_doubled_local(welded.key_hi, welded.key_lo, cell_origin)
    parity = kl & 1
    base = kl >> 1
    f = welded.vertices - base.to(torch.float32)          # {0, t, 1-t}
    ref = torch.argmax(parity, dim=1)                      # first odd axis
    t_par = torch.gather(f, 1, ref[:, None])
    # the fraction on this axis is 1 - t rather than t
    dirb = (parity == 1) & (torch.abs(f - (1.0 - t_par))
                            < torch.abs(f - t_par))
    t16 = torch.clamp(torch.round(t_par[:, 0] * 65535.0), 0, 65535
                      ).to(torch.int64)
    dir_i = dirb.to(torch.int64)
    if fmt.vertex_words == 3:
        tparts = torch.stack([t16 & 0x3F, (t16 >> 6) & 0x3F,
                              (t16 >> 12) & 0xF], dim=1)
        words = (base | (parity << 8) | (dir_i << 9) | (tparts << 10)) & 0xFFFF
    else:
        w012 = (base | (parity << 13) | (dir_i << 14)) & 0xFFFF
        words = torch.cat([w012, t16[:, None]], dim=1)
    return torch.cat([idx_words, _u16_to_words(words)])


def block_field(splats: torch.Tensor, valid: torch.Tensor,
                region_cells: Sequence[int], cell_origin: Sequence[int],
                boundary_factor: float, points: Optional[torch.Tensor] = None,
                *, levels: int, subsampling: int, fit_shape: str = "sphere",
                stage: Optional[Callable[[str], object]] = None):
    """The seam-canonical MLS field of one block: (field (B,B,B) [z, y, x],
    n_occ tensor). splats (N, 8) f32 in global grid coords (col 3 = radius),
    valid (N,) bool, region_cells/cell_origin 3 host ints (x, y, z), points
    (P, 3) global skeleton corners or None. `stage(name)`, when given, is a
    context manager wrapped around each stage (StageTimer)."""
    stage = stage or _no_stage
    min_shift = subsampling
    max_shift = levels + subsampling - 1
    tpa = 1 << (max_shift - 3)  # block corners / 8
    with stage("binning"):
        binned = binning.bin_splats(splats, valid, cell_origin, min_shift,
                                    max_shift)
    with stage("segments"):
        starts, lens = binning.tile_segments(binned.entry_keys, min_shift,
                                             max_shift, tpa)
    with stage("mls"):
        field, _, n_occ = mls_cuda.eval_field(
            binned.entry_data, starts, lens, cell_origin, tpa, fit_shape,
            boundary_factor)
    with stage("faces"):
        seam_cuda.canonical_face_field(field, binned.entry_data,
                                       binned.entry_vals, starts, lens,
                                       cell_origin, region_cells, tpa,
                                       fit_shape, boundary_factor)
    if points is not None and points.shape[0] > 0:
        with stage("skeleton"):
            seam_cuda.skeleton_point_field(field, binned.entry_data,
                                           binned.entry_vals, starts, lens,
                                           cell_origin, points, tpa,
                                           fit_shape, boundary_factor)
    return field, n_occ


def _no_stage(name: str):
    return contextlib.nullcontext()


def block_step(splats: torch.Tensor, valid: torch.Tensor,
               region_cells: Sequence[int], cell_origin: Sequence[int],
               boundary_factor: float, points: Optional[torch.Tensor] = None,
               *, levels: int, subsampling: int, fit_shape: str = "sphere",
               readback: str = "codes", device_filter=None,
               stage: Optional[Callable[[str], object]] = None
               ) -> BlockResult:
    """Reconstruct one block on the tensors' device into a readback.

    readback: "codes", "packed" or "raw" (resolve "auto" first with
    resolve_readback). device_filter: a vertex transform (pipeline/
    mesh_filter.py) applied to the welded block-local vertices; it needs
    readback "raw". stage: see block_field (block_step_staged)."""
    if readback not in READBACK_MODES:
        raise ValueError(f"unknown readback mode {readback!r}")
    if device_filter is not None and readback != "raw":
        raise ValueError("a device filter needs readback 'raw': filtered "
                         "vertices leave the lattice the quantized "
                         "layouts encode")
    stage = stage or _no_stage
    field, n_occ = block_field(splats, valid, region_cells, cell_origin,
                               boundary_factor, points, levels=levels,
                               subsampling=subsampling, fit_shape=fit_shape,
                               stage=stage)
    n_occ = int(n_occ)
    if readback == "codes":
        with stage("marching"):
            cmesh = marching.generate_codes(field, region_cells)
        with stage("pack"):
            packed = pack_codes(cmesh)
        counts = np.array([cmesh.num_vertices, 0, cmesh.num_indices, 0,
                           cmesh.num_cells, cmesh.num_vertices, n_occ,
                           cmesh.num_tiles], np.int64)
        return BlockResult(packed=packed, counts=counts, readback="codes",
                           fmt=codes_format(levels, subsampling))

    with stage("marching"):
        mesh = marching.generate_mesh(field, region_cells, cell_origin)
    with stage("weld"):
        welded = weld.weld(mesh.vertices, mesh.key_hi, mesh.key_lo,
                           mesh.triangles)
    counts = np.array([welded.num_vertices, welded.first_external,
                       welded.num_indices, 0, mesh.num_cells,
                       mesh.num_vertices, n_occ, mesh.num_tiles], np.int64)
    if readback == "raw":
        if device_filter is not None:
            welded = welded._replace(
                vertices=device_filter(welded.vertices, cell_origin))
        return BlockResult(packed=None, counts=counts, readback="raw",
                           mesh=welded)
    fmt = pack_format(levels, subsampling, welded.num_vertices)
    if fmt is None:
        raise ValueError(f"block of 2^{levels + subsampling - 1} corners per "
                         "axis is too large for the packed readback; use "
                         "--readback raw")
    with stage("pack"):
        packed = pack_readback(welded, cell_origin, fmt)
    return BlockResult(packed=packed, counts=counts, readback="packed",
                       fmt=fmt)


class StageTimer:
    """`block_step(stage=...)` that times each stage into the statistics
    registry as `device.<stage>.time` seconds (the JAX package's
    block_step_staged names): CUDA events on the card, the wall clock on
    the CPU. Each stage ends in a synchronisation, which serialises the
    pipeline, so this is for profiling (--statistics-device), not
    production throughput."""

    def __init__(self, registry, device: torch.device):
        self.registry = registry
        self.cuda = device.type == "cuda"

    @contextlib.contextmanager
    def __call__(self, name: str):
        var = self.registry.variable(f"device.{name}.time")
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            var.add(start.elapsed_time(end) / 1000.0)
        else:
            t0 = time.monotonic()
            yield
            var.add(time.monotonic() - t0)


def block_step_staged(splats: torch.Tensor, valid: torch.Tensor,
                      region_cells: Sequence[int], cell_origin: Sequence[int],
                      boundary_factor: float,
                      points: Optional[torch.Tensor] = None,
                      **kwargs) -> BlockResult:
    """`block_step` with every stage timed (StageTimer) into the statistics
    registry, the port of mlsgpu_tpu/ops/block.py::block_step_staged."""
    timer = StageTimer(get_registry(), splats.device)
    return block_step(splats, valid, region_cells, cell_origin,
                      boundary_factor, points, stage=timer, **kwargs)


def readback_tensors(result: BlockResult) -> List[torch.Tensor]:
    """The device tensors one block's readback copies to the host: the image
    (codes, packed), or the raw arrays (vertices, external key halves as u32
    bits, triangles as int32)."""
    if result.readback != "raw":
        return [result.packed]
    m = result.mesh
    fe = m.first_external
    return [m.vertices, _u32_to_words(m.key_hi[fe:]),
            _u32_to_words(m.key_lo[fe:]), m.triangles.to(torch.int32)]


def unpack_readback(flat: np.ndarray, num_indices: int, num_vertices: int,
                    first_external: int, fmt: PackFormat,
                    cell_origin: np.ndarray):
    """Host decode of a packed image (numpy; the port of the JAX package's
    unpack_readback). Returns (vertices (nv, 3) f32 block-local, triangles
    (nt, 3) i32, ext_keys (nv - fe,) i64 global 63-bit weld keys)."""
    ni, nv, fe = int(num_indices), int(num_vertices), int(first_external)
    iw = fmt.index_words(ni)
    if fmt.index_mode == "u16":
        tris = (flat[:iw].view(np.uint16)[:ni]
                .astype(np.int32).reshape(-1, 3))
    elif fmt.index_mode == "u21x3":
        w = flat[:iw].reshape(-1, 2)
        m21 = np.uint32(0x1FFFFF)
        a = w[:, 0] & m21
        b = ((w[:, 0] >> 21) | ((w[:, 1] & np.uint32(0x3FF)) << 11)) & m21
        c = (w[:, 1] >> 10) & m21
        tris = np.stack([a, b, c], axis=1).astype(np.int32)
    else:
        tris = flat[:iw].view(np.int32).reshape(-1, 3)

    vw = fmt.vertex_words
    words = (flat[iw:iw + fmt.vertex_region_words(nv)]
             .view(np.uint16)[:nv * vw].reshape(nv, vw))
    if vw == 3:
        base = (words & np.uint16(0xFF)).astype(np.int32)
        parity = ((words >> 8) & 1).astype(np.int32)
        dirb = ((words >> 9) & 1).astype(bool)
        tp = (words >> 10).astype(np.uint32)
        t16 = (tp[:, 0] & 0x3F) | ((tp[:, 1] & 0x3F) << 6) \
            | ((tp[:, 2] & 0xF) << 12)
    else:
        base = (words[:, :3] & np.uint16(0x1FFF)).astype(np.int32)
        parity = ((words[:, :3] >> 13) & 1).astype(np.int32)
        dirb = ((words[:, :3] >> 14) & 1).astype(bool)
        t16 = words[:, 3].astype(np.uint32)

    t = (t16.astype(np.float32) / np.float32(65535.0))[:, None]
    frac = np.where(parity == 1, np.where(dirb, 1.0 - t, t),
                    np.float32(0.0)).astype(np.float32)
    verts = base.astype(np.float32) + frac

    kg = (2 * base + parity)[fe:] + 2 * np.asarray(cell_origin,
                                                   np.int64)[None, :]
    ext_keys = kg[:, 0] | (kg[:, 1] << 21) | (kg[:, 2] << 42)
    return verts, tris, ext_keys


def unpack_readback_global(flat: np.ndarray, num_indices: int,
                           num_vertices: int, first_external: int,
                           fmt: PackFormat, cell_origin: np.ndarray):
    """unpack_readback with the block -> global cell-origin add folded in,
    through the native decoder when it is available (bitwise the same)."""
    from mlsgpu_tpu_torch import _native
    out = _native.unpack_readback(flat, int(num_indices), int(num_vertices),
                                  int(first_external), fmt.index_mode,
                                  fmt.vertex_words,
                                  np.asarray(cell_origin, np.int64))
    if out is not None:
        return out
    verts, tris, keys = unpack_readback(flat, num_indices, num_vertices,
                                        first_external, fmt, cell_origin)
    return verts + np.asarray(cell_origin, np.float32), tris, keys
