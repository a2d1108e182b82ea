"""The codes path's marching and pack kernels (csrc/marching.cu) and the
functions the block step calls for them on the card: `classify`, then
`emit`, or both as `codes_image`.

Tensors on a CUDA device take the kernel path: `march_classify_kernel` (a
warp a column of 8 by 2 tiles walking a run along z, each corner's sign
and finite bit computed once and the cells classified 32 at a time as bit
words: each tile's occupied cells, vertices, indices and candidate flag,
and their sums for each row segment of 8 tiles) and `march_scan_kernel`
(the list of tiles with an occupied cell and their cell and vertex bases,
and the totals: a segment a thread, a CTA a ticketed tile of SCAN_ROWS
segments, one launch on the look-back scan of csrc/scan.cuh, its state
cleared by the classify pass) from one C call, one copy of the totals to pinned host
memory and a wait on the stream (the stage's one sync), then
`march_emit_kernel` (a warp a listed tile, its occupied cells ranked by
popcounts, its vertices a lane each), which writes the image in its final
layout, bit for bit `marching.pack_codes(marching.generate_codes(...))`.
`codes_image` on a CPU tensor returns those plain functions' image;
`classify` and `emit` take CUDA tensors alone. A CUDA tensor launches the
kernels or raises; nothing falls back. The kernels live in the library
ops/mls_cuda.py builds; their tables (csrc/marching_tables.h) are
generated from ops/tables.py by `python -m mlsgpu_tpu_torch.ops.marching_cuda`.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mlsgpu_tpu_torch.ops import launches, marching, mls_cuda, tables

TABLES_HEADER = os.path.join(os.path.dirname(mls_cuda.SOURCES[0]),
                             "marching_tables.h")
#: Ints a row of the occupied-tile list, and tiles a row segment of the
#: classify pass's records (csrc/marching.cuh).
LIST_WIDTH = 4
ROW_TILES = 8
#: The totals the scan writes, in this order (csrc/marching.cuh).
TOTALS = ("cells", "vertices", "indices", "candidates", "tiles")
#: Row segments a tile of the scan (a CTA: csrc/marching.cuh).
SCAN_ROWS = 256
#: The most corners an axis the codes readback's kernels take (flat cell
#: ids fit u32), and the mesh readbacks' (classify, scan and the mesh
#: emission: the packed layout's 2^13 limit, csrc/mesh.cuh).
CODES_MAX_CORNERS = 1 << 10
MESH_MAX_CORNERS = 1 << 13


def segment_rows(g: int) -> int:
    """The classify pass's row segments for g tiles an axis: a record
    each, g^2 * ceil(g / ROW_TILES)."""
    return g * g * -(-g // ROW_TILES)


def scan_state_words(g: int) -> int:
    """The scan's per-call state, int64 words (march_scan_state_words):
    its ticket and a status word a total for each tile of SCAN_ROWS
    segments, cleared by the classify pass."""
    return 1 + len(TOTALS) * -(-segment_rows(g) // SCAN_ROWS)


class MarchCounts(NamedTuple):
    """A block's marching counts: occupied cells, emitted vertices and
    triangle indices, candidate tiles (the tiled rule's count above
    marching.TILED_ABOVE corners an axis, else 0, as
    BlockCodes.num_tiles)."""
    num_cells: int
    num_vertices: int
    num_indices: int
    num_tiles: int


class Marched(NamedTuple):
    """What `classify` leaves for `emit`: the counts, the field and
    region, the occupied-tile list on the card and its live rows, and the
    int32 scalar the caller had copied back with the totals (else None)."""
    counts: MarchCounts
    field: torch.Tensor
    region: Tuple[int, int, int]
    tile_list: torch.Tensor
    march_tiles: int
    n_occ: Optional[int] = None


def _check_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"marching kernels need CUDA tensors, got {t.device}")


def _check_field(field: torch.Tensor, region_cells: Sequence[int],
                 max_corners: int = CODES_MAX_CORNERS
                 ) -> Tuple[int, Tuple[int, int, int]]:
    b = field.shape[0] if field.dim() == 3 else -1
    mls_cuda._check("field", field, torch.float32, (b, b, b))
    if not 2 <= b <= max_corners:
        raise ValueError(f"{b} corners an axis: the kernels take "
                         f"2-{max_corners}")
    region = tuple(int(v) for v in region_cells)
    if len(region) != 3 or not all(0 <= v <= b - 1 for v in region):
        raise ValueError(f"region {region} outside a block of {b - 1} "
                         "cells an axis")
    return b, region


def launch_classify(field: torch.Tensor, region_cells: Sequence[int],
                    max_corners: int = CODES_MAX_CORNERS
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The classify and scan kernels on a CUDA field of up to max_corners
    corners an axis (one C call, a launch of each), without synchronising:
    (the occupied-tile list (g^3, 4) int32: tile, cell, vertex and index
    bases, the totals (TOTALS order) int64), both on the device."""
    _check_cuda(field)
    dev = field.device
    b, region = _check_field(field, region_cells, max_corners)
    g = -(-(b - 1) // marching.TILE)
    records = torch.empty((g ** 3, 2), dtype=torch.int32, device=dev)
    rows = torch.empty((segment_rows(g), 4), dtype=torch.int32, device=dev)
    scan_state = torch.empty(scan_state_words(g), dtype=torch.int64,
                             device=dev)
    tile_list = torch.empty((g ** 3, LIST_WIDTH), dtype=torch.int32,
                            device=dev)
    totals = torch.empty(len(TOTALS), dtype=torch.int64, device=dev)
    lib = mls_cuda.load()
    with torch.cuda.device(dev):
        err = lib.march_classify_launch(
            field.data_ptr(), b, *region, int(b > marching.TILED_ABOVE),
            records.data_ptr(), rows.data_ptr(), scan_state.data_ptr(),
            tile_list.data_ptr(), totals.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"march_classify_launch failed: cudaError_t {err}")
    launches.count("march_classify")
    launches.count("march_scan")
    return tile_list, totals


def classify(field: torch.Tensor, region_cells: Sequence[int],
             n_occ: Optional[torch.Tensor] = None,
             max_corners: int = CODES_MAX_CORNERS,
             sync: Callable[[], contextlib.AbstractContextManager]
             = contextlib.nullcontext) -> Marched:
    """The block's occupied tiles and counts on a CUDA field:
    launch_classify, then the totals copied to pinned host memory, and
    n_occ (an int32 device scalar, such as the field kernel's occupied
    tiles) beside them when given, with one wait on the current stream,
    inside `sync()`. max_corners: MESH_MAX_CORNERS for the mesh
    readbacks, whose int32 index bases also hold the triangle indices
    below 2^31."""
    _check_cuda(field)
    dev = field.device
    if n_occ is not None:
        mls_cuda._check("n_occ", n_occ, torch.int32, ())
        if n_occ.device != dev:
            raise ValueError(f"n_occ on {n_occ.device}, field on {dev}")
    tile_list, totals = launch_classify(field, region_cells, max_corners)
    with torch.cuda.device(dev):
        # the int64 totals as int32 pairs, then n_occ
        host = torch.empty(2 * len(TOTALS) + 1, dtype=torch.int32,
                           pin_memory=True)
        host[:-1].view(torch.int64).copy_(totals, non_blocking=True)
        if n_occ is not None:
            host[-1:].copy_(n_occ.view(1), non_blocking=True)
        with sync():
            torch.cuda.current_stream(dev).synchronize()
    t = dict(zip(TOTALS, (int(v) for v in host[:-1].view(torch.int64)
                          .numpy())))
    if t["vertices"] >= 1 << 31 or (max_corners > CODES_MAX_CORNERS
                                    and t["indices"] >= 1 << 31):
        raise ValueError(f"{t['vertices']} vertices, {t['indices']} "
                         "indices: the kernels' bases are int32")
    return Marched(
        counts=MarchCounts(t["cells"], t["vertices"], t["indices"],
                           t["candidates"]),
        field=field, region=tuple(int(v) for v in region_cells),
        tile_list=tile_list, march_tiles=t["tiles"],
        n_occ=None if n_occ is None else int(host[-1]))


def emit(marched: Marched) -> torch.Tensor:
    """The codes image (CodesFormat layout, int32 words) of a block
    `classify` took: the emit kernel, one launch (none for a block without
    occupied cells)."""
    c = marched.counts
    field = marched.field
    dev = field.device
    image = torch.empty(marching.codes_words(c.num_cells, c.num_vertices),
                        dtype=torch.int32, device=dev)
    if marched.march_tiles == 0:
        return image
    lib = mls_cuda.load()
    with torch.cuda.device(dev):
        err = lib.march_emit_launch(
            field.data_ptr(), field.shape[0], *marched.region,
            marched.tile_list.data_ptr(), marched.march_tiles, c.num_cells,
            c.num_vertices, image.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"march_emit_launch failed: cudaError_t {err}")
    launches.count("march_emit")
    return image


def codes_image(field: torch.Tensor, region_cells: Sequence[int]
                ) -> Tuple[torch.Tensor, MarchCounts]:
    """(codes image, counts) of a (B, B, B) field [z, y, x] (NaN =
    undefined) and a region of region_cells (x, y, z) cells: the kernels
    for a CUDA tensor, the plain `marching.pack_codes(
    marching.generate_codes(...))` for a CPU tensor; any other device
    raises."""
    if field.device.type == "cpu":
        cm = marching.generate_codes(field, region_cells)
        return marching.pack_codes(cm), MarchCounts(
            cm.num_cells, cm.num_vertices, cm.num_indices, cm.num_tiles)
    if field.device.type != "cuda":
        raise ValueError(f"no marching path for device {field.device}")
    marched = classify(field, region_cells)
    return emit(marched), marched.counts


def vertex_end_offsets() -> np.ndarray:
    """(256, MAX_CELL_VERTICES) END_OFFSETS table: for each local vertex,
    where the corners at the ends of its edge (EDGES[VERT_TABLE]) lie in a
    tile's (9, 9, 9) corner block [z, y, x] from the cell's base corner,
    off0 | off1 << 8; 0 past the code's vertices."""
    dx, dy, dz = marching.CORNER_OFFS.T
    corner = dx + 9 * dy + 81 * dz
    e = corner[tables.EDGES[np.maximum(tables.VERT_TABLE, 0)]]
    return np.where(tables.VERT_TABLE >= 0, e[..., 0] | e[..., 1] << 8, 0)


def vertex_corners() -> np.ndarray:
    """(256, MAX_CELL_VERTICES) VERT_CORNERS table: for each local vertex,
    the corner ids at the ends of its edge (EDGES[VERT_TABLE]), c0 | c1 <<
    4; 0 past the code's vertices."""
    e = tables.EDGES[np.maximum(tables.VERT_TABLE, 0)]
    return np.where(tables.VERT_TABLE >= 0, e[..., 0] | e[..., 1] << 4, 0)


def tables_header() -> str:
    """csrc/marching_tables.h as ops/tables.py gives it."""
    def rows(a: np.ndarray, per_line: int) -> str:
        cells = ["{" + ", ".join(str(int(v)) for v in row) + "}" for row in a]
        return ", \\\n".join("  " + ", ".join(cells[i:i + per_line])
                              for i in range(0, len(cells), per_line))

    return "\n".join([
        "// Generated from mlsgpu_tpu_torch/ops/tables.py by",
        "// `python -m mlsgpu_tpu_torch.ops.marching_cuda`: do not edit.",
        "// tests/test_torch_marching_cuda.py holds it to tables.py.",
        "",
        "#pragma once",
        "",
        f"#define MARCH_NUM_EDGES {tables.NUM_EDGES}",
        f"#define MARCH_MAX_CELL_VERTICES {tables.MAX_CELL_VERTICES}",
        f"#define MARCH_MAX_CELL_INDICES {tables.MAX_CELL_INDICES}",
        "",
        "// EDGES: the corner ids at the ends of each edge.",
        "#define MARCH_EDGES_INIT { \\", rows(tables.EDGES, 10) + "}",
        "",
        "// COUNT_TABLE: the vertices and triangle indices of each code.",
        "#define MARCH_COUNT_INIT { \\", rows(tables.COUNT_TABLE, 8) + "}",
        "",
        "// VERT_TABLE: the edge of each local vertex of each code, -1 past",
        "// its vertices.",
        "#define MARCH_VERT_INIT { \\", rows(tables.VERT_TABLE, 1) + "}",
        "",
        "// END_OFFSETS: the offsets in a tile's 9x9x9 corner block from a",
        "// cell's base corner of the corners at the ends of each local",
        "// vertex's edge, off0 | off1 << 8 (EDGES[VERT_TABLE]), 0 past its",
        "// vertices.",
        "#define MARCH_END_OFFSETS_INIT { \\",
        rows(vertex_end_offsets(), 1) + "}",
        "",
        "// INDEX_TABLE: the local vertex of each triangle index of each",
        "// code, -1 past its indices.",
        "#define MARCH_INDEX_INIT { \\", rows(tables.INDEX_TABLE, 1) + "}",
        "",
        "// VERT_CORNERS: the corner ids at the ends of each local vertex's",
        "// edge, c0 | c1 << 4 (EDGES[VERT_TABLE]), 0 past its vertices.",
        "#define MARCH_VERT_CORNERS_INIT { \\",
        rows(vertex_corners(), 1) + "}",
        ""])


if __name__ == "__main__":
    with open(TABLES_HEADER, "w") as f:
        f.write(tables_header())
    print(f"wrote {TABLES_HEADER}")
