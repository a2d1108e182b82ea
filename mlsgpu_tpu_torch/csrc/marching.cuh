// The per-cell arithmetic of the marching kernels (marching.cu): one
// cell's case code from its eight corners, whether it is occupied, its
// vertex and index counts, the corners at the ends of its local vertex
// j's edge, and a vertex's 16-bit interpolant t16.
//
// Written once for the card and for a host build: nvcc compiles these
// functions into the kernels, where t16's subtraction, division and
// product are `_rn` intrinsics (IEEE round to nearest, never contracted
// into an FMA, denormals kept: no fast-math, no FTZ); a host compiler
// (g++ -ffp-contract=off) gets the same operations as plain IEEE float
// arithmetic, so a CPU test can hold the kernels' emulation to the plain
// version (ops/marching.py) bit for bit without a card.
//
// The tables are ops/tables.py's, generated into marching_tables.h; the
// card reads them from global memory through the read-only cache (the
// lanes of a warp look up different codes, which constant memory would
// serialise), a host build from static arrays.

#pragma once

#include <math.h>

#include "marching_tables.h"

#if defined(__CUDACC__)
#define MARCH_FN __host__ __device__ __forceinline__
#else
#define MARCH_FN static inline
#endif

// Cells an axis of a tile (ops/marching.py::TILE), cells and corners of a
// tile's corner block (its 8^3 corners and the next tiles' first layer).
#define MARCH_TILE 8
#define MARCH_TILE_CELLS (MARCH_TILE * MARCH_TILE * MARCH_TILE)
#define MARCH_SPAN (MARCH_TILE + 1)
#define MARCH_TILE_CORNERS (MARCH_SPAN * MARCH_SPAN * MARCH_SPAN)
// The classify pass takes a row segment of MARCH_ROW_TILES tiles along x a
// CTA, their corner blocks as one (9, 9, MARCH_ROW_PITCH) block; the scan
// is one CTA of MARCH_SCAN_THREADS threads.
#define MARCH_ROW_TILES 8
#define MARCH_ROW_PITCH (MARCH_ROW_TILES * MARCH_TILE + 1)
#define MARCH_SCAN_THREADS 1024

#if defined(__CUDACC__)
__device__ const unsigned char march_edges_d[MARCH_NUM_EDGES][2] =
    MARCH_EDGES_INIT;
__device__ const unsigned char march_counts_d[256][2] = MARCH_COUNT_INIT;
__device__ const signed char march_verts_d[256][MARCH_MAX_CELL_VERTICES] =
    MARCH_VERT_INIT;
#endif
static const unsigned char march_edges_h[MARCH_NUM_EDGES][2] =
    MARCH_EDGES_INIT;
static const unsigned char march_counts_h[256][2] = MARCH_COUNT_INIT;
static const signed char march_verts_h[256][MARCH_MAX_CELL_VERTICES] =
    MARCH_VERT_INIT;

// The index of corner (x, y, z) in a corner block of (9, 9, pitch)
// corners [z, y, x]: pitch 9 for one tile, MARCH_ROW_PITCH for a row
// segment.
MARCH_FN int march_corner_index(int x, int y, int z, int pitch) {
  return (z * MARCH_SPAN + y) * pitch + x;
}

// Where corner v of a cell lies in a corner block, from the cell's base
// corner: v is at offset (v & 1, (v >> 1) & 1, (v >> 2) & 1) along (x, y,
// z) (ops/marching.py::CORNER_OFFS).
MARCH_FN int march_corner_offset(int v, int pitch) {
  return march_corner_index(v & 1, (v >> 1) & 1, (v >> 2) & 1, pitch);
}

// The eight corners of the cell whose base corner is at `base` in a
// corner block of `pitch`.
MARCH_FN void march_cell_corners(const float* base, int pitch, float c[8]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) c[v] = base[march_corner_offset(v, pitch)];
}

// The case code: bit v set where corner v is >= 0 (true for -0.0, false
// for NaN).
MARCH_FN unsigned march_code(const float c[8]) {
  unsigned code = 0;
#pragma unroll
  for (int v = 0; v < 8; ++v) code |= (c[v] >= 0.0f ? 1u : 0u) << v;
  return code;
}

// Occupied: every corner finite, the cell inside the region, and the
// surface through it (code not 0 or 255).
MARCH_FN bool march_occupied(const float c[8], unsigned code, bool in_region) {
  bool finite = true;
#pragma unroll
  for (int v = 0; v < 8; ++v) finite = finite && isfinite(c[v]);
  return finite && in_region && code != 0u && code != 255u;
}

// COUNT_TABLE[code]: the vertices and the triangle indices of a cell.
MARCH_FN unsigned march_vertex_count(unsigned code) {
#ifdef __CUDA_ARCH__
  return __ldg(&march_counts_d[code][0]);
#else
  return march_counts_h[code][0];
#endif
}

MARCH_FN unsigned march_index_count(unsigned code) {
#ifdef __CUDA_ARCH__
  return __ldg(&march_counts_d[code][1]);
#else
  return march_counts_h[code][1];
#endif
}

// The corners c0, c1 at the ends of local vertex j's edge:
// EDGES[VERT_TABLE[code][j]] (j below the code's vertex count).
MARCH_FN void march_vertex_edge(unsigned code, int j, int* c0, int* c1) {
#ifdef __CUDA_ARCH__
  const int e = __ldg(&march_verts_d[code][j]);
  *c0 = __ldg(&march_edges_d[e][0]);
  *c1 = __ldg(&march_edges_d[e][1]);
#else
  const int e = march_verts_h[code][j];
  *c0 = march_edges_h[e][0];
  *c1 = march_edges_h[e][1];
#endif
}

// t16 = clamp(rint((iso0 / (iso0 - iso1)) * 65535), 0, 65535), each
// operation IEEE-rounded as torch computes it; rint rounds half to even,
// as torch.round. The edge is cut, so iso0 - iso1 is never 0.
MARCH_FN unsigned march_t16(float iso0, float iso1) {
#ifdef __CUDA_ARCH__
  const float t = __fdiv_rn(iso0, __fsub_rn(iso0, iso1));
  const float r = rintf(__fmul_rn(t, 65535.0f));
#else
  const float t = iso0 / (iso0 - iso1);
  const float r = rintf(t * 65535.0f);
#endif
  return (unsigned)fminf(fmaxf(r, 0.0f), 65535.0f);
}

// A tile's record from the classify pass (uint2): x = occupied cells |
// candidate << 16 (any of the tile's own 8^3 corners finite:
// classify_tiled's candidate test), y = vertices | indices << 16 (at most
// 512 * 13 and 512 * 36, both below 2^16).
MARCH_FN unsigned march_tile_cells(unsigned x) { return x & 0xFFFFu; }
MARCH_FN unsigned march_tile_candidate(unsigned x) { return x >> 16; }
MARCH_FN unsigned march_tile_vertices(unsigned y) { return y & 0xFFFFu; }
MARCH_FN unsigned march_tile_indices(unsigned y) { return y >> 16; }

// A row segment's record from the classify pass (uint4), the sums of its
// tiles': x = tiles with an occupied cell | candidate tiles << 16, y =
// cells, z = vertices, w = indices. Segments run in tile order: segment s
// of row (tz * g + ty) is record (tz * g + ty) * segments + s, where
// segments = ceil(g / MARCH_ROW_TILES), and holds tiles tx from s *
// MARCH_ROW_TILES up to the row's end.
MARCH_FN unsigned march_segment_tiles(unsigned x) { return x & 0xFFFFu; }
MARCH_FN unsigned march_segment_candidates(unsigned x) { return x >> 16; }

// The slots of the occupied-tile list the scan writes, a row of four ints
// per tile with an occupied cell, in tile order.
#define MARCH_LIST_TILE 0
#define MARCH_LIST_CELL_BASE 1
#define MARCH_LIST_VERTEX_BASE 2
#define MARCH_LIST_WIDTH 4

// The totals the scan writes, int64 each.
#define MARCH_TOTAL_CELLS 0
#define MARCH_TOTAL_VERTICES 1
#define MARCH_TOTAL_INDICES 2
#define MARCH_TOTAL_CANDIDATES 3
#define MARCH_TOTAL_TILES 4
#define MARCH_TOTALS 5
