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
// or the kernel's copy in shared memory).
MESH_FN unsigned mesh_vertex_corners(const unsigned char* table,
                                     unsigned code, int j) {
  return table[code * MARCH_MAX_CELL_VERTICES + j];
}

// Where corner c (bit a its offset along axis a) lies in a tile's (9, 9,
// 9) corner block [z, y, x] from the cell's base corner.
MESH_FN int mesh_corner_offset(unsigned c) {
  return (int)(c & 1u) + MARCH_SPAN * (int)((c >> 1) & 1u) +
         MARCH_SPAN * MARCH_SPAN * (int)(c >> 2);
}

// The local vertex of triangle index i (< the code's index count) of a
// code, from `table` (march_index_h, or the kernel's copy).
MESH_FN int mesh_index_vertex(const signed char* table, unsigned code,
                              int i) {
  return table[code * MARCH_MAX_CELL_INDICES + i];
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

// The weld's compaction (weld_compact_kernel): a CTA of MESH_WELD_THREADS
// threads takes a ticketed tile of MESH_WELD_ITEMS sorted keys a thread;
// two counts are scanned (the first of each run of equal keys, and those
// of them internal).
#define MESH_WELD_THREADS 256
#define MESH_WELD_ITEMS 8
#define MESH_WELD_TILE (MESH_WELD_THREADS * MESH_WELD_ITEMS)
#define MESH_WELD_COUNTS 2

// The weld's sort keys between passes: 4 bytes up to 32 bits, else 8.
MESH_FN int mesh_sort_key_bytes(int key_bits) { return key_bits <= 32 ? 4 : 8; }

MESH_FN int mesh_sort_passes(int key_bits) {
  return (key_bits + SORT_DIGIT_BITS - 1) / SORT_DIGIT_BITS;
}

// The weld's scratch, 64-bit words: the sort's (radix_sort.cuh), then the
// compaction's ticket and a status word a count a tile, all but the
// histograms cleared by the sort's histogram kernel.
static inline long long mesh_weld_state_words(long long n) {
  return 1 + MESH_WELD_COUNTS * ((n + MESH_WELD_TILE - 1) / MESH_WELD_TILE);
}

static inline long long mesh_weld_scratch_words(long long n, int key_bits) {
  return sort_scratch_words(n, mesh_sort_passes(key_bits),
                            mesh_sort_key_bytes(key_bits)) +
         mesh_weld_state_words(n);
}

// The weld's work buffer between the sort's passes, int32 words: a key
// and an index a vertex.
static inline long long mesh_weld_work_words(long long n, int key_bits) {
  return mesh_sort_passes(key_bits) > 1
             ? n * (mesh_sort_key_bytes(key_bits) / 4 + 1)
             : 0;
}
