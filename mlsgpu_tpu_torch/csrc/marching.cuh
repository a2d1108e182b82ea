// The per-cell arithmetic of the marching kernels (marching.cu): each
// corner's sign and finite bit, the occupied cells of 32 cells at once and
// a cell's case code from words of those bits, its vertex and index
// counts, the corners at the ends of its local vertex j's edge, the
// spread of a warp's vertices over its lanes, and a vertex's 16-bit
// interpolant t16.
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
// kernels copy the ones they read into shared memory once a CTA (the lanes
// of a warp look up different codes), a host build reads static arrays.

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
// The classify pass takes a column a warp: a row segment of
// MARCH_ROW_TILES tiles along x, MARCH_BAND_TILES along y and a run of
// march_run_tiles(g) along z, walked one corner plane at a time. The scan
// takes a row segment a thread, MARCH_SCAN_THREADS segments a CTA (a
// tile of scan.cuh's look-back).
#define MARCH_ROW_TILES 8
#define MARCH_BAND_TILES 2
#define MARCH_SCAN_THREADS 256

MARCH_FN int march_segments(int g) {
  return (g + MARCH_ROW_TILES - 1) / MARCH_ROW_TILES;
}

MARCH_FN int march_bands(int g) {
  return (g + MARCH_BAND_TILES - 1) / MARCH_BAND_TILES;
}

// The run a classify warp walks along z: the longest of 8, 4, 2 and 1
// tiles that still leaves 8,192 warps, else 1. A longer run reads the
// plane between two runs once; more warps than the card holds at once (22
// an SM, 2,904 on an H100's 132) keep every SM full to the end: at 512^3
// on an H100, runs of 2 tiles took 0.25 ms, of 8 tiles 0.33 ms.
MARCH_FN int march_run_tiles(int g) {
  const long long columns = (long long)march_segments(g) * march_bands(g);
  int run = 8;
  while (run > 1 && columns * ((g + run - 1) / run) < 8192) run >>= 1;
  return run;
}

#if defined(__CUDACC__)
__device__ const unsigned char march_counts_d[256][2] = MARCH_COUNT_INIT;
__device__ __align__(4) const unsigned short
    march_end_offsets_d[256][MARCH_MAX_CELL_VERTICES] = MARCH_END_OFFSETS_INIT;
#endif
static const unsigned char march_edges_h[MARCH_NUM_EDGES][2] =
    MARCH_EDGES_INIT;
static const unsigned char march_counts_h[256][2] = MARCH_COUNT_INIT;
static const signed char march_verts_h[256][MARCH_MAX_CELL_VERTICES] =
    MARCH_VERT_INIT;
static const unsigned short
    march_end_offsets_h[256][MARCH_MAX_CELL_VERTICES] = MARCH_END_OFFSETS_INIT;

// The index of corner (x, y, z) in a tile's (9, 9, 9) corner block
// [z, y, x].
MARCH_FN int march_corner_index(int x, int y, int z) {
  return (z * MARCH_SPAN + y) * MARCH_SPAN + x;
}

// The case code of a cell's eight corners: bit v set where corner v is
// >= 0 (true for -0.0 and +inf, false for NaN). The plain rule, which the
// kernels compute from corner bits (below).
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

// The two bits the kernels compute once a corner: its sign bit (v >= 0,
// march_code's) and its finite bit. A corner past the field's end is NaN:
// both 0.
MARCH_FN unsigned march_sign_bit(float v) { return v >= 0.0f ? 1u : 0u; }
MARCH_FN unsigned march_finite_bit(float v) { return isfinite(v) ? 1u : 0u; }

// The kernels hold corner bits in words, 32 cells a word: word[v] has at
// each cell's bit the bit of that cell's corner v (v = dx + 2 dy + 4 dz,
// march_code's order). A row word of corners x, x + 1, ... serves as the
// dx = 0 word of the cells x, x + 1, ...; march_next_corners gives dx = 1.

// The corners x + 1 of a row word w: w shifted down a bit, the next
// word's first corner (bit 0 of `next`) at bit 31.
MARCH_FN unsigned march_next_corners(unsigned w, unsigned next) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(w, next, 1);
#else
  return (w >> 1) | (next << 31);
#endif
}

// A word of four rows of 8 cells, a byte a row: byte i the bits `shift` to
// `shift` + 7 of rows[i] (a tile's corner row held as sign bits 0-8 and
// finite bits 16-24: shift 0 or 16 for the cells' dx = 0 corners, 1 or 17
// for dx = 1).
MARCH_FN unsigned march_row_bytes(const unsigned rows[4], int shift) {
  unsigned w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= ((rows[i] >> shift) & 0xFFu) << (8 * i);
  return w;
}

// Of 32 cells from their corner words, the occupied ones (march_occupied):
// every corner finite, some but not all signs set, in `region`.
MARCH_FN unsigned march_word_occupied(const unsigned sign[8],
                                      const unsigned finite[8],
                                      unsigned region) {
  unsigned any = 0u, all = ~0u, fin = ~0u;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    any |= sign[v];
    all &= sign[v];
    fin &= finite[v];
  }
  return fin & any & ~all & region;
}

// The case code of a tile's cell at x from its four corner rows (dy, dz) =
// (0, 0), (1, 0), (0, 1), (1, 1), each held as sign bits 0-8 (march_code).
MARCH_FN unsigned march_rows_code(unsigned r00, unsigned r10, unsigned r01,
                                  unsigned r11, int x) {
  return ((r00 >> x) & 3u) | (((r10 >> x) & 3u) << 2) |
         (((r01 >> x) & 3u) << 4) | (((r11 >> x) & 3u) << 6);
}

// The case code of the cell at bit x of the words (march_code).
MARCH_FN unsigned march_word_code(const unsigned sign[8], int x) {
  unsigned code = 0u;
#pragma unroll
  for (int v = 0; v < 8; ++v) code |= ((sign[v] >> x) & 1u) << v;
  return code;
}

// The vertex spread: a cell whose `count` vertices are a warp's vertices
// first .. first + count - 1 marks itself, `lane`, as their owner, so that
// each lane can then take one vertex and find its cell.
MARCH_FN void march_spread_vertices(unsigned char* owner, unsigned first,
                                    unsigned count, unsigned lane) {
  for (unsigned j = 0; j < count; ++j) owner[first + j] = (unsigned char)lane;
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

// Both counts of a code in one word, vertices | indices << 16 (a tile's
// sums stay below 2^16: 512 * 13 and 512 * 36).
MARCH_FN unsigned march_cell_counts(unsigned code) {
  return march_vertex_count(code) | (march_index_count(code) << 16);
}

// Where the corners at the ends of local vertex j's edge (j below the
// code's vertex count) lie in a tile's corner block from the cell's base
// corner, off0 | off1 << 8: from `offsets`, the END_OFFSETS table flat
// (march_end_offsets_h, or the kernel's copy in shared memory).
MARCH_FN unsigned march_vertex_end_offsets(const unsigned short* offsets,
                                           unsigned code, int j) {
  return offsets[code * MARCH_MAX_CELL_VERTICES + j];
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
// classify_tiled's candidate test), y = vertices | indices << 16.
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
// per tile with an occupied cell, in tile order: the tile, and the cells,
// vertices and triangle indices of the tiles before it (the codes
// emission reads the first three, the mesh emission all four).
#define MARCH_LIST_TILE 0
#define MARCH_LIST_CELL_BASE 1
#define MARCH_LIST_VERTEX_BASE 2
#define MARCH_LIST_INDEX_BASE 3
#define MARCH_LIST_WIDTH 4

// The totals the scan writes, int64 each. They are also the counts its
// look-back scans, a status word each a scan tile, in this order.
#define MARCH_TOTAL_CELLS 0
#define MARCH_TOTAL_VERTICES 1
#define MARCH_TOTAL_INDICES 2
#define MARCH_TOTAL_CANDIDATES 3
#define MARCH_TOTAL_TILES 4
#define MARCH_TOTALS 5

// The scan's tiles (CTAs) for `nrows` row segments.
MARCH_FN int march_scan_tiles(int nrows) {
  return (nrows + MARCH_SCAN_THREADS - 1) / MARCH_SCAN_THREADS;
}

// The scan's per-call state, 64-bit words: its ticket, then MARCH_TOTALS
// status words a tile (scan.cuh), all zero before it starts.
MARCH_FN long long march_scan_state_words(int nrows) {
  return 1 + (long long)MARCH_TOTALS * march_scan_tiles(nrows);
}
