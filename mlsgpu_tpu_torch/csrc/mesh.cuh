// The per-vertex and per-triangle arithmetic of the mesh readbacks'
// kernels (march_emit_mesh_kernel in marching.cu; the weld and pack
// kernels in mesh.cu): a vertex's position and its keys, the weld's
// compact sort key, a welded vertex's pack words and a triangle's index
// words.
//
// Written once for the card and for a host build, as marching.cuh: nvcc
// compiles these functions into the kernels, where every float
// subtraction, division, product and sum is an `_rn` intrinsic (IEEE
// round to nearest, never contracted into an FMA, denormals kept); a host
// compiler (g++ -ffp-contract=off) gets the same operations as plain IEEE
// float arithmetic, so a CPU test can hold the kernels' emulation to the
// plain versions (ops/marching.py::generate_mesh, ops/weld.py::weld,
// ops/block.py::pack_readback) bit for bit without a card. Integer work is
// the plain versions' int64 arithmetic.
//
// The weld's compact sort key: the plain weld sorts the 64-bit global
// keys (hi, lo) = ext << 63 | kz << 42 | ky << 21 | kx, each axis the
// doubled global edge-midpoint coordinate 2 cell_origin + kl, where kl is
// the block-local one (2 cell + the edge's two corner offsets, below
// 2^axis_bits with axis_bits = bit_length(2 (b - 1))). While every global
// coordinate fits its 21 bits (the wrapper checks it), adding 2
// cell_origin to each field keeps their order and their equalities, so
// (ext, kz, ky, kx) of the block-local coordinates, axis_bits each, sorts
// and welds as the global keys do: 3 axis_bits + 1 bits, 28 at 256^3
// corners, 31 at 512^3, 34 at 1024^3 and 43 at the 2^13 limit.

#pragma once

#include <math.h>

#include "marching.cuh"
#include "radix_sort.cuh"

#if defined(__CUDACC__)
#define MESH_FN __host__ __device__ __forceinline__
#else
#define MESH_FN static inline
#endif

// The most corners an axis of a mesh block: the packed readback's limit
// (ops/block.py::pack_format, 2^13 corners an axis).
#define MESH_MAX_CORNERS (1 << 13)

#if defined(__CUDACC__)
__device__ __align__(4) const signed char
    march_index_d[256][MARCH_MAX_CELL_INDICES] = MARCH_INDEX_INIT;
__device__ __align__(4) const unsigned char
    march_vert_corners_d[256][MARCH_MAX_CELL_VERTICES] =
        MARCH_VERT_CORNERS_INIT;
#endif
static const signed char march_index_h[256][MARCH_MAX_CELL_INDICES] =
    MARCH_INDEX_INIT;
static const unsigned char
    march_vert_corners_h[256][MARCH_MAX_CELL_VERTICES] =
        MARCH_VERT_CORNERS_INIT;

MESH_FN float mesh_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

MESH_FN float mesh_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

MESH_FN float mesh_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

MESH_FN float mesh_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

// The corners at the ends of local vertex j's edge of a code, c0 | c1 <<
// 4 (VERT_CORNERS: EDGES[VERT_TABLE]), from `table` (march_vert_corners_h,
// or on the card march_vert_corners_d through the read-only cache).
MESH_FN unsigned mesh_vertex_corners(const unsigned char* table,
                                     unsigned code, int j) {
#ifdef __CUDA_ARCH__
  return __ldg(table + code * MARCH_MAX_CELL_VERTICES + j);
#else
  return table[code * MARCH_MAX_CELL_VERTICES + j];
#endif
}

// The local vertex of triangle index i (< the code's index count) of a
// code, from `table` (march_index_h, or on the card march_index_d through
// the read-only cache).
MESH_FN int mesh_index_vertex(const signed char* table, unsigned code,
                              int i) {
#ifdef __CUDA_ARCH__
  return __ldg(table + code * MARCH_MAX_CELL_INDICES + i);
#else
  return table[code * MARCH_MAX_CELL_INDICES + i];
#endif
}

// --- the emission's tile: a CTA a listed tile (marching.cu) ---------------
//
// The tile's (9, 9, 9) corners are staged [z, y, x] with a corner row at a
// pitch of MESH_STAGE_PITCH floats, so that a row starts 16-byte aligned:
// two 16-byte copies and a 4-byte one fill it, and its thread reads it
// back as two float4 and a float.
#define MESH_STAGE_PITCH 12
#define MESH_STAGE_ROWS (MARCH_SPAN * MARCH_SPAN)
// A CTA of MESH_EMIT_THREADS threads: thread t ranks and counts the tile's
// cells 4 t .. 4 t + 3 (MESH_EMIT_CELLS a thread; raster order), then the
// occupied cells are taken MESH_EMIT_THREADS at a time (a batch, a thread
// a cell), and a batch's vertices and triangles a thread each.
#define MESH_EMIT_THREADS 128
#define MESH_EMIT_CELLS 4

// Where corner (x, y, z) of a tile's staged block lies, and corner c (bit a
// its offset along axis a) of a cell from the cell's base corner.
MESH_FN int mesh_staged_corner(int x, int y, int z) {
  return (z * MARCH_SPAN + y) * MESH_STAGE_PITCH + x;
}

MESH_FN int mesh_staged_offset(unsigned c) {
  return (int)(c & 1u) + MESH_STAGE_PITCH * (int)((c >> 1) & 1u) +
         MARCH_SPAN * MESH_STAGE_PITCH * (int)(c >> 2);
}

// The occupied cells x = lx .. lx + 3 of a tile's cell row, bit x - lx
// (march_occupied), from the four corner rows (dy, dz) = (0, 0), (1, 0),
// (0, 1), (1, 1) below and beside them, each held as sign bits 0-8 and
// finite bits 16-24, and the region's cells of the row (bit x).
MESH_FN unsigned mesh_quad_occupied(unsigned r00, unsigned r10, unsigned r01,
                                    unsigned r11, int lx, unsigned region) {
  const unsigned s_or = (r00 | r10 | r01 | r11) & 0x1FFu;
  const unsigned s_and = r00 & r10 & r01 & r11 & 0x1FFu;
  const unsigned fin = (r00 & r10 & r01 & r11) >> 16;
  const unsigned any = s_or | (s_or >> 1), all = s_and & (s_and >> 1);
  const unsigned occ = fin & (fin >> 1) & any & ~all & region;
  return (occ >> lx) & 0xFu;
}

// What places a block's vertices and keys: the region's doubled top (2
// region_cells, where a vertex is external), the block's doubled origin
// (2 cell_origin) and the compact key's bits an axis.
struct MeshFrame {
  int top[3];
  long long org2[3];
  int axis_bits;
};

// A vertex's keys from its doubled block-local coordinates k (x, y, z):
// the global halves (ops/marching.py::generate_mesh: 21 bits an axis of
// k + 2 cell_origin, the external flag in bit 31 of hi) and the compact
// sort key (ext, kz, ky, kx), axis_bits an axis.
MESH_FN void mesh_keys(const int k[3], const MeshFrame& f, unsigned* hi,
                       unsigned* lo, unsigned long long* sort) {
  bool ext = false;
  long long g[3];
  for (int a = 0; a < 3; ++a) {
    ext = ext || k[a] == 0 || k[a] == f.top[a];
    g[a] = (long long)k[a] + f.org2[a];
  }
  *lo = (unsigned)((g[0] | ((g[1] & 0x7FFLL) << 21)) & 0xFFFFFFFFLL);
  *hi = (unsigned)(((g[1] >> 11) | (g[2] << 10) | ((long long)ext << 31)) &
                   0xFFFFFFFFLL);
  const int a = f.axis_bits;
  *sort = ((unsigned long long)ext << (3 * a)) |
          ((unsigned long long)k[2] << (2 * a)) |
          ((unsigned long long)k[1] << a) | (unsigned long long)k[0];
}

// A vertex of the cell at block-local (cx, cy, cz) on the edge from
// corner c0 (value iso0) to corner c1 (iso1), the edge cut: its position
// (cell + off0) + t (off1 - off0) with t = iso0 / (iso0 - iso1), in
// generate_mesh's order and rounding, and its keys.
MESH_FN void mesh_vertex(int cx, int cy, int cz, unsigned c0, unsigned c1,
                         float iso0, float iso1, const MeshFrame& f,
                         float pos[3], unsigned* hi, unsigned* lo,
                         unsigned long long* sort) {
  const float t = mesh_div(iso0, mesh_sub(iso0, iso1));
  const int c[3] = {cx, cy, cz};
  int k[3];
  for (int a = 0; a < 3; ++a) {
    const int o0 = (int)((c0 >> a) & 1u), o1 = (int)((c1 >> a) & 1u);
    pos[a] = mesh_add((float)(c[a] + o0), mesh_mul(t, (float)(o1 - o0)));
    k[a] = 2 * c[a] + o0 + o1;
  }
  mesh_keys(k, f, hi, lo, sort);
}

// A welded vertex's `vertex_words` (3 or 4) u16 pack words (PackFormat)
// from its position v and its key halves, block.pack_readback's rule:
// per axis the doubled block-local coordinate kl, its parity and base kl
// >> 1, the fraction f = v - base; t from the first odd axis, and per odd
// axis whether the fraction is 1 - t rather than t.
MESH_FN void mesh_vertex_words(const float v[3], unsigned hi, unsigned lo,
                               const long long org2[3], int vertex_words,
                               unsigned short w[4]) {
  const long long m21 = 0x1FFFFFLL, h = hi, l = lo;
  const long long k[3] = {l & m21, ((l >> 21) | ((h & 0x3FFLL) << 11)) & m21,
                          (h >> 10) & m21};
  long long parity[3], base[3];
  float f[3];
  for (int a = 0; a < 3; ++a) {
    const long long kl = k[a] - org2[a];
    parity[a] = kl & 1;
    base[a] = kl >> 1;
    f[a] = mesh_sub(v[a], (float)base[a]);
  }
  const int ref = parity[0] == 1 ? 0 : parity[1] == 1 ? 1
                                     : parity[2] == 1 ? 2 : 0;
  const float tp = f[ref], one_minus = mesh_sub(1.0f, tp);
  const float r = rintf(mesh_mul(tp, 65535.0f));
  const long long t16 = (long long)fminf(fmaxf(r, 0.0f), 65535.0f);
  for (int a = 0; a < 3; ++a) {
    const long long dir =
        parity[a] == 1 &&
        fabsf(mesh_sub(f[a], one_minus)) < fabsf(mesh_sub(f[a], tp));
    if (vertex_words == 3) {
      const long long part = a == 0 ? t16 & 0x3F
                             : a == 1 ? (t16 >> 6) & 0x3F
                                      : (t16 >> 12) & 0xF;
      w[a] = (unsigned short)((base[a] | (parity[a] << 8) | (dir << 9) |
                               (part << 10)) & 0xFFFF);
    } else {
      w[a] = (unsigned short)((base[a] | (parity[a] << 13) | (dir << 14)) &
                              0xFFFF);
    }
  }
  if (vertex_words == 4) w[3] = (unsigned short)t16;
}

// The index modes of a packed image (PackFormat.index_mode) and the raw
// readback's remapped int32 triangles.
#define MESH_INDEX_U16 0
#define MESH_INDEX_U21X3 1
#define MESH_INDEX_U32 2
#define MESH_INDEX_RAW 3

// u21x3's two words of a triangle (a, b, c): a | b << 21, b >> 11 | c << 10.
MESH_FN void mesh_u21x3(long long a, long long b, long long c, unsigned* w0,
                        unsigned* w1) {
  *w0 = (unsigned)((a | ((b & 0x7FFLL) << 21)) & 0xFFFFFFFFLL);
  *w1 = (unsigned)(((b >> 11) | (c << 10)) & 0xFFFFFFFFLL);
}

// Words of a packed image's index region (PackFormat.index_words); its
// vertex region follows.
MESH_FN long long mesh_index_words(int mode, long long num_indices) {
  return mode == MESH_INDEX_U16     ? (num_indices + 1) / 2
         : mode == MESH_INDEX_U21X3 ? 2 * (num_indices / 3)
                                    : num_indices;
}

// --- the weld's plan -------------------------------------------------------
//
// The weld sorts the compact keys in two steps (mesh.cu): g global passes
// of binning's pass body over the key's top 8 g bits only, then
// weld_group_kernel, which takes the runs of equal top bits (key groups),
// finishes each group's sort by the f = key_bits - 8 g free bits below
// them in shared memory and compacts in the same pass. g is the least
// number of passes for which no group the emission can produce exceeds
// the group kernel's capacity. A group's keys share the top bits and so
// the parity of every coordinate none of whose bits is free; a vertex is
// the midpoint of one of a cell's 19 tetrahedra edges, so its doubled
// coordinates are not all even, and its copies (one a cell holding the
// edge: VERT_TABLE emits a cut edge's vertex once a cell) follow its odd
// coordinates: a cube edge's midpoint (one odd) is shared by 4 cells, a
// face diagonal's (two) by 2, the body diagonal's (three) by 1. Summed
// over the free bits' values (ranges ignored, which only lowers it).
// The capacity's limit is a budget of shared memory: a CTA holds its tile
// and a capacity more of slots, 16 bytes each (three CTAs an SM at 1,024
// keys, four at the 384 of 512^3). 28 bits (256^3) take g = 3 (4 free
// bits, groups of at most 48 keys), 31 bits (512^3) g = 3 (7, 384), 34
// and 37 bits g = 4, 43 bits g = 5. (g = 2 at 28 bits leaves groups of up
// to 10,240 keys: 200 KB of shared memory, one CTA an SM, and on the H100
// the group kernel took 0.108 ms at the densest 256^3 bucket against
// 0.033 with the third pass, which costs 0.013.)
#define MESH_WELD_MAX_CAPACITY 1024
// The free bits a group kernel sorts in shared memory: the local word
// holds them below the external flag (bit 31), in at most 4 local digits.
#define MESH_WELD_MAX_FREE_BITS 30
#define MESH_WELD_LOCAL_BITS 8
// The group kernel: a CTA of MESH_WELD_THREADS threads takes a ticketed
// tile of MESH_WELD_TILE positions of the top-sorted keys and owns every
// group that starts in it; it marks and counts its range a round of
// MESH_WELD_ITEMS consecutive positions a thread at a time; three counts
// are scanned across tiles (welded vertices, those internal, groups past
// the capacity).
#define MESH_WELD_THREADS 256
#define MESH_WELD_TILE 2048
#define MESH_WELD_ITEMS 9
#define MESH_WELD_ROUND (MESH_WELD_THREADS * MESH_WELD_ITEMS)
#define MESH_WELD_COUNTS 3

// The weld's sort keys between passes: 4 bytes up to 32 bits, else 8.
MESH_FN int mesh_sort_key_bytes(int key_bits) { return key_bits <= 32 ? 4 : 8; }

// The free bits below g global passes' digits.
MESH_FN int mesh_weld_free_bits(int key_bits, int passes) {
  const int f = key_bits - SORT_DIGIT_BITS * passes;
  return f > 0 ? f : 0;
}

// The most keys of one group of `key_bits`-bit keys (3 axis bits + 1)
// with f free bits (above): the free bits fill kx's bits, then ky's, then
// kz's from the lowest; a coordinate with a free bit has either parity,
// the others the parities the top bits fix.
MESH_FN long long mesh_weld_group_bound(int key_bits, int free_bits) {
  if (free_bits > 40) return 1LL << 42;   // past any capacity
  const int a = (key_bits - 1) / 3;
  int free_axes = 0, left = free_bits;
  for (int i = 0; i < 3; ++i) {
    if (left > 0) free_axes |= 1 << i;
    left -= left < a ? left : a;
  }
  const int copies[4] = {0, 4, 2, 1};   // by odd coordinates
  int per = 0;                           // patterns a free value takes
  for (int i = 0; i < 3; ++i) per += (free_axes >> i) & 1;
  long long best = 0;
  for (int fixed = 0; fixed < 8; ++fixed) {
    if (fixed & free_axes) continue;
    long long keys = 0;
    for (int odd = 0; odd < 8; ++odd) {
      if ((odd & ~free_axes) != fixed) continue;
      const int n_odd = (odd & 1) + ((odd >> 1) & 1) + ((odd >> 2) & 1);
      keys += copies[n_odd] * ((1LL << free_bits) >> per);
    }
    best = keys > best ? keys : best;
  }
  return best;
}

// g: the least number of global passes whose groups fit the capacity.
MESH_FN int mesh_sort_passes(int key_bits) {
  int g = 1;
  while (mesh_weld_group_bound(key_bits, mesh_weld_free_bits(key_bits, g)) >
         MESH_WELD_MAX_CAPACITY)
    ++g;
  return g;
}

// The global passes' digits: bits [f, key_bits), SORT_DIGIT_BITS a pass
// from the lowest (the last takes what is left). Valid for 1 <= passes
// and SORT_DIGIT_BITS (passes - 1) < key_bits.
static inline SortPlan mesh_weld_sort_plan(int key_bits, int passes) {
  SortPlan plan{0u, passes, {}, {}};
  const int f = mesh_weld_free_bits(key_bits, passes);
  for (int p = 0; p < passes; ++p) {
    plan.shift[p] = f + SORT_DIGIT_BITS * p;
    const int left = key_bits - plan.shift[p];
    plan.bits[p] = left < SORT_DIGIT_BITS ? left : SORT_DIGIT_BITS;
  }
  return plan;
}

// The group kernel's local digits of the free bits: as few as keep each
// at most MESH_WELD_LOCAL_BITS bits, of equal width from bit 0 (the last
// takes what is left): 12 bits are 2 of 6, 7 bits 1 of 7.
MESH_FN int mesh_weld_local_digits(int free_bits) {
  return (free_bits + MESH_WELD_LOCAL_BITS - 1) / MESH_WELD_LOCAL_BITS;
}

MESH_FN int mesh_weld_local_width(int free_bits) {
  const int d = mesh_weld_local_digits(free_bits);
  return d == 0 ? 0 : (free_bits + d - 1) / d;
}

// Local digit `digit` of a local word (its free bits from bit 0).
MESH_FN unsigned mesh_weld_local_digit(unsigned word, int digit, int width,
                                       int free_bits) {
  const int shift = digit * width;
  const int left = free_bits - shift;
  const int bits = left < width ? left : width;
  return (word >> shift) & ((1u << bits) - 1u);
}

// The group kernel's dynamic shared memory at a capacity: a local word
// and an index a slot, twice (the local sort's two buffers), for the
// tile and the last group's overhang; then a group's start a tile
// position (and room for the range's end), and the groups that cross an
// edge of a window of 32 slots (one an edge at most).
static inline long long mesh_weld_shared_bytes(int capacity) {
  const long long slots = MESH_WELD_TILE + capacity;
  return 16 * slots + 2LL * (MESH_WELD_TILE + 2) + 2 * (slots / 32 + 2);
}

// The weld's scratch, 64-bit words: the sort's g passes
// (radix_sort.cuh), then the group kernel's ticket and a status word a
// count a tile, all but the histograms cleared by the sort's histogram
// kernel.
static inline long long mesh_weld_state_words(long long n) {
  return 1 + MESH_WELD_COUNTS * ((n + MESH_WELD_TILE - 1) / MESH_WELD_TILE);
}

static inline long long mesh_weld_scratch_words(long long n, int key_bits) {
  return sort_scratch_words(n, mesh_sort_passes(key_bits),
                            mesh_sort_key_bytes(key_bits)) +
         mesh_weld_state_words(n);
}

// The weld's work buffers, int32 words: the passes' outputs, a key and an
// index a vertex each (a buffer an even count of words, so that the
// second one's 64-bit keys stay aligned), two of them where a pass reads
// another's.
static inline long long mesh_weld_buffer_words(long long n, int key_bits) {
  return ((mesh_sort_key_bytes(key_bits) / 4 + 1) * n + 1) / 2 * 2;
}

static inline long long mesh_weld_work_words(long long n, int key_bits) {
  return (mesh_sort_passes(key_bits) > 1 ? 2 : 1) *
         mesh_weld_buffer_words(n, key_bits);
}
